// Weighted max-min water-fill over a batch of padded f64 rows (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/accel/waterfill_pallas.py::_pallas_fill
// (its inner `kernel`, reached through water_fill_pallas): per row, fill
// the free slots in proportion to weight, clamp at each entry's cap,
// hand the overflow back, and repeat until nobody is capped.
//
// Design
// * One thread block per row, blockDim = min(width, 1024).  Thread t owns
//   lanes t, t + blockDim, t + 2*blockDim, ...  A row's caps, weights,
//   live mask, allocation and active flags are read from device memory
//   once and stay in registers through every round; the allocation is
//   written once at the end.
// * At most width + 1 rounds (every continuing round caps at least one
//   active entry).  Each round does two block reductions: sum(w_act) with
//   any(active), then sum(grant_capped) with any(capped).  The reference
//   loop's guard `free > 1e-12 && any(active)` is computed from reduced
//   values, so it is uniform across the block, and the block leaves the
//   loop as soon as it is false: every later round is an exact no-op.
// * Fixed summation order, no atomics: each thread sums its own lanes in
//   lane order starting from +0.0, then a stride-halving tree in shared
//   memory (sh[t] = sh[t] + sh[t + s], s = blockDim/2 ... 1).  Zeros
//   appended at the tail are added exactly (padding-neutral) and reruns
//   are bitwise equal.  The plain PyTorch version
//   (repro_torch/accel/waterfill.py::water_fill_reference) sums in the
//   same order, and the build passes -fmad=false so no product is
//   contracted into an FMA: kernel and plain version agree bitwise.
//
// Bound: a row moves width * (8 + 8 + 1 + 8) bytes plus 8 for its slots,
// so at the main path's shapes (tens of rows of width 128) a launch is a
// few tens of KB and latency-bound, not bandwidth- or FLOP-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr double kEps = 1e-12;

// Block-wide sum in the fixed tree order.  Every thread returns the
// total; the caller must pass a barrier before `sh` is written again.
__device__ __forceinline__ double block_sum(double v, double* sh, int t,
                                            int nt) {
  sh[t] = v;
  __syncthreads();
  for (int s = nt >> 1; s > 0; s >>= 1) {
    if (t < s) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  return sh[0];
}

template <int KMAX>
__global__ void __launch_bounds__(kMaxThreads)
    waterfill_kernel(const double* __restrict__ caps,
                     const double* __restrict__ ws,
                     const double* __restrict__ slots,
                     const uint8_t* __restrict__ live,
                     double* __restrict__ out, int width) {
  __shared__ double sh[kMaxThreads];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int k = width / nt;  // lanes per thread, 1 <= k <= KMAX
  const size_t row = static_cast<size_t>(blockIdx.x) * width;

  double c[KMAX], w[KMAX], alloc[KMAX];
  bool active[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    c[j] = 0.0;
    w[j] = 0.0;
    alloc[j] = 0.0;
    active[j] = false;
    if (j < k) {
      const size_t i = row + t + static_cast<size_t>(j) * nt;
      const bool lv = live[i] != 0;
      w[j] = lv ? ws[i] : 0.0;
      c[j] = lv ? caps[i] : 0.0;
      active[j] = lv && (c[j] > 0.0);
    }
  }
  double free_slots = slots[blockIdx.x];

  for (int r = 0; r <= width; ++r) {
    // -- reduction 1: total active weight, any(active)
    double acc = 0.0;
    int any_act = 0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const double wa = active[j] ? w[j] : 0.0;
        acc = acc + wa;
        any_act |= active[j] ? 1 : 0;
      }
    }
    const double total_w = block_sum(acc, sh, t, nt);
    // Also the barrier that frees `sh` for the next reduction.
    const bool any_active = __syncthreads_or(any_act) != 0;
    if (!((free_slots > kEps) && any_active)) break;

    const bool w_ok = total_w > 0.0;
    const double denom = w_ok ? total_w : 1.0;

    // -- reduction 2: slots granted to capped entries, any(capped)
    double acc2 = 0.0;
    int any_cap = 0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const double wa = active[j] ? w[j] : 0.0;
        const double share = active[j] ? (free_slots * wa) / denom : 0.0;
        const double head = c[j] - alloc[j];
        const bool capped = active[j] && (share >= head - kEps);
        acc2 = acc2 + (capped ? head : 0.0);
        any_cap |= capped ? 1 : 0;
      }
    }
    const double sum_gc = block_sum(acc2, sh, t, nt);
    const bool cont = w_ok && (__syncthreads_or(any_cap) != 0);

    // -- update (recomputes share/capped: same inputs, same bits)
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const double wa = active[j] ? w[j] : 0.0;
        const double share = active[j] ? (free_slots * wa) / denom : 0.0;
        const double head = c[j] - alloc[j];
        const bool capped = active[j] && (share >= head - kEps);
        const double grant =
            cont ? (capped ? head : 0.0) : (w_ok ? share : 0.0);
        alloc[j] = alloc[j] + grant;
        active[j] = cont && active[j] && !capped;
      }
    }
    free_slots = cont ? free_slots - sum_gc : free_slots;
  }

#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) out[row + t + static_cast<size_t>(j) * nt] = alloc[j];
  }
}

template <int KMAX>
cudaError_t launch(const double* caps, const double* ws, const double* slots,
                   const uint8_t* live, double* out, int rows, int width,
                   int threads, cudaStream_t stream) {
  waterfill_kernel<KMAX><<<rows, threads, 0, stream>>>(caps, ws, slots, live,
                                                      out, width);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `width` must be a padded
// bucket width: a power of two up to 1024, or a multiple of 1024 up to
// 32 * 1024.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int repro_waterfill_f64(const double* caps, const double* ws,
                                   const double* slots, const uint8_t* live,
                                   double* out, int rows, int width,
                                   void* stream) {
  if (rows <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = width < kMaxThreads ? width : kMaxThreads;
  if (width % threads != 0 || (threads & (threads - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = width / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 1) {
    err = launch<1>(caps, ws, slots, live, out, rows, width, threads, s);
  } else if (k <= 2) {
    err = launch<2>(caps, ws, slots, live, out, rows, width, threads, s);
  } else if (k <= 4) {
    err = launch<4>(caps, ws, slots, live, out, rows, width, threads, s);
  } else if (k <= 8) {
    err = launch<8>(caps, ws, slots, live, out, rows, width, threads, s);
  } else if (k <= 16) {
    err = launch<16>(caps, ws, slots, live, out, rows, width, threads, s);
  } else if (k <= 32) {
    err = launch<32>(caps, ws, slots, live, out, rows, width, threads, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
