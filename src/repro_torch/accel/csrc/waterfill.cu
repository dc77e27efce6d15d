// Weighted max-min water-fill over a batch of padded f64 rows (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/accel/waterfill_pallas.py::_pallas_fill
// (its inner `kernel`, reached through water_fill_pallas): per row, fill
// the free slots in proportion to weight, clamp at each entry's cap,
// hand the overflow back, and repeat until nobody is capped.
//
// Bound: a row moves width * (8 + 8 + 1 + 8) bytes plus 8 for its slots,
// and the rows of a call need a handful of rounds, so at the main path's
// shapes (32 rows of width 128 per launch) a launch is a few tens of KB
// and a few thousand f64 operations: latency-bound, far below both the
// memory and the f64 rate.  The design therefore cuts the fixed cost of a
// round and of a launch, not bytes or operations.
//
// Summation order (fixed, no atomics, the same at every width).  A row is
// cut into segments of 256 lanes; lane i is slot (i % 256) / 32 of thread
// i % 32 of segment i / 256.
//   1. Each thread sums its slots of a segment in order from +0.0.
//   2. Each segment's 32 thread sums go through a __shfl_xor_sync
//      butterfly (offsets 16 ... 1).  Each step adds the same two operands
//      on both lanes of a pair, so every lane ends with the same bits.
//   3. The segment sums, padded with +0.0 to a power of two >= 32, go
//      through a stride-halving tree (pairs s, s + n/2 first); its last
//      five levels are again a butterfly.
// Lanes past the row add +0.0 and no partial is ever -0.0, so padding a
// row to any wider width moves no bit, and reruns are bitwise equal.  The
// plain PyTorch version (repro_torch/accel/waterfill.py::_tree_sum) sums
// in this order, and the build passes -fmad=false so no product is
// contracted into an FMA: kernel and plain version agree bitwise.
//
// Design
// * One launch serves both virtual clusters of a cell step: rows
//   [0, rows) are phase 0 (MAP), rows [rows, 2 rows) phase 1 (REDUCE).
//   The phases share the weights `ws` and the width; the row index picks
//   the phase's caps, slots, live mask and output.  A single call is the
//   same launch with one phase.
// * Rows of width <= 256 (the accel cell's 128; the small buckets of the
//   discrete-event path): one warp per row, kRowsPerBlock rows a block,
//   at most 8 lanes a thread, held in registers from the first load to
//   the one store.  Flags are __any_sync votes.  No shared memory and no
//   barrier.
// * Wider rows (512 ... 32768): one block per row, one warp per segment
//   (up to 32 warps; above 8192 lanes each warp takes segments w, w + 32,
//   ... and halves them first).  Lane 0 of each warp writes the warp's
//   sum to shared memory, and one __syncthreads_or both publishes the
//   sums and takes the block's flag; every warp then reads them (lane i
//   reads warp i's, +0.0 past the last warp) and butterflies them.  One
//   barrier per reduction; the two reductions of a round write two
//   buffers, so a buffer is rewritten only after the other reduction's
//   barrier.  Up to 4096 lanes (512 threads, 128 registers a thread) the
//   row stays in registers; wider rows spill (off every main path).
// * The guard first: `free > 1e-12` is a register, tested before
//   anything else; `any(active)` is one vote.  In the warp route the vote
//   comes before the weight sum, so a row whose guard is false pays no
//   sum.  In the block route a vote is itself a barrier, so the warps'
//   weight sums are published on that same barrier and the row leaves
//   before the cross-warp sum.  The row leaves the loop at once (every
//   later round of the reference is an exact no-op), and a round that
//   does not continue is the row's last.
// * Per lane and round, share and capped are computed once and kept for
//   the update: one value `pend` (the headroom if capped, else the share)
//   gives the grant in both cases, and the capped flags are a bit mask.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kEps = 1e-12;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kSlots = 8;                   // a thread's lanes in a segment
constexpr int kSegment = kSlots * kWarp;    // 256 lanes
constexpr int kMaxWarps = 32;
constexpr int kMaxWidth = 4 * kMaxWarps * kSegment;  // 32768
constexpr int kRowsPerBlock = 4;            // warp route: rows (warps) a block

struct Rows {
  const double* caps[2];
  const double* slots[2];
  const uint8_t* live[2];
  double* out[2];
  const double* ws;
  int rows;   // rows per phase
  int total;  // rows * phases
  int width;
};

// Sum over the 32 lanes of a warp; every lane returns the same bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

// The row `g` of the launch: phase 0 below `rows`, phase 1 above.
struct Row {
  const double* caps;
  const double* ws;
  const uint8_t* live;
  double* out;
  double slots;
};

__device__ __forceinline__ Row row_of(const Rows& a, int g) {
  const int p = g >= a.rows ? 1 : 0;
  const int r = g - p * a.rows;
  const size_t off = static_cast<size_t>(r) * a.width;
  Row row;
  row.caps = (p ? a.caps[1] : a.caps[0]) + off;
  row.live = (p ? a.live[1] : a.live[0]) + off;
  row.out = (p ? a.out[1] : a.out[0]) + off;
  row.ws = a.ws + off;
  row.slots = (p ? a.slots[1] : a.slots[0])[r];
  return row;
}

// The K lanes of one thread (thread t of warp w): slot j % 8 of segment
// w + 32 * (j / 8), i.e. lane w*256 + t + 32*(j % 8) + 8192*(j / 8).
template <int K>
struct Lanes {
  static constexpr int kSegs = K < kSlots ? 1 : K / kSlots;
  static constexpr int kPerSeg = K < kSlots ? K : kSlots;
  double c[K], w[K], alloc[K], pend[K];
  unsigned active = 0u, capped = 0u;
  int first = 0;  // lane of slot 0

  __device__ __forceinline__ static int offset(int j) {
    return kWarp * (j % kSlots) + kMaxWarps * kSegment * (j / kSlots);
  }

  __device__ __forceinline__ void load(const Row& row, int warp, int width) {
    first = warp * kSegment + static_cast<int>(threadIdx.x % kWarp);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      c[j] = 0.0;
      w[j] = 0.0;
      alloc[j] = 0.0;
      pend[j] = 0.0;
      const int i = first + offset(j);
      if (i < width) {
        // Three independent loads, then the selects (no load waits on
        // the live mask).
        const bool lv = row.live[i] != 0;
        const double wi = row.ws[i], ci = row.caps[i];
        w[j] = lv ? wi : 0.0;
        c[j] = lv ? ci : 0.0;
        if (lv && c[j] > 0.0) active |= 1u << j;
      }
    }
  }

  __device__ __forceinline__ void store(const Row& row, int width) const {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = first + offset(j);
      if (i < width) row.out[i] = alloc[j];
    }
  }

  // The warp's sum of x over its lanes: steps 1-2 per segment, then the
  // levels of step 3 that pair this warp's segments.  Every lane of the
  // warp returns the same bits.
  __device__ __forceinline__ static double warp_lanes_sum(
      const double (&x)[K]) {
    double seg[kSegs];
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      double acc = 0.0;
#pragma unroll
      for (int j = 0; j < kPerSeg; ++j) acc = acc + x[s * kSlots + j];
      seg[s] = warp_sum(acc);
    }
#pragma unroll
    for (int n = kSegs / 2; n > 0; n /= 2) {
#pragma unroll
      for (int s = 0; s < n; ++s) seg[s] = seg[s] + seg[s + n];
    }
    return seg[0];
  }

  // The warp's sum(w_act).
  __device__ __forceinline__ double weight() const {
    double x[K];
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = ((active >> j) & 1u) ? w[j] : 0.0;
    return warp_lanes_sum(x);
  }

  // share and capped of every lane, once; sets `capped` and `pend` and
  // returns the warp's sum(grant_capped).
  __device__ __forceinline__ double cap(double free_slots, double denom) {
    double x[K];
    capped = 0u;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool act = (active >> j) & 1u;
      double share = 0.0;
      if (act) share = (free_slots * w[j]) / denom;
      const double head = c[j] - alloc[j];
      const bool cp = act && (share >= head - kEps);
      pend[j] = cp ? head : share;
      capped |= (cp ? 1u : 0u) << j;
      x[j] = cp ? head : 0.0;
    }
    return warp_lanes_sum(x);
  }

  // The round's update: continuing, capped lanes take their headroom and
  // leave; otherwise every active lane takes its share (the last round).
  __device__ __forceinline__ void update(bool cont, bool w_ok) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool cp = (capped >> j) & 1u;
      const double grant =
          cont ? (cp ? pend[j] : 0.0) : (w_ok ? pend[j] : 0.0);
      alloc[j] = alloc[j] + grant;
    }
    active = cont ? (active & ~capped) : 0u;
  }
};

// Warp route: one warp per row of width <= 32 * K <= 256.
template <int K>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
    waterfill_warp(Rows a) {
  const int g = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (g >= a.total) return;  // warp-uniform
  const Row row = row_of(a, g);
  Lanes<K> l;
  l.load(row, 0, a.width);
  double free_slots = row.slots;

  for (int r = 0; r <= a.width; ++r) {
    if (!(free_slots > kEps)) break;
    if (!__any_sync(kFull, l.active != 0u)) break;
    const double total_w = l.weight();
    const bool w_ok = total_w > 0.0;
    const double denom = w_ok ? total_w : 1.0;
    const double sum_gc = l.cap(free_slots, denom);
    const bool any_capped = __any_sync(kFull, l.capped != 0u);
    const bool cont = w_ok && any_capped;
    l.update(cont, w_ok);
    if (!cont) break;
    free_slots = free_slots - sum_gc;
  }
  l.store(row, a.width);
}

// Block route, after the barrier: the block's sum, the warps' sums in a
// butterfly (+0.0 past the last warp); every thread gets the same bits.
__device__ __forceinline__ double gather(const double* buf) {
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  return warp_sum(lane < warps ? buf[lane] : 0.0);
}

// Block route: one block per row, one warp per segment (blockDim =
// 32 * min(segments, 32)), K = 8 * ceil(segments / 32) lanes a thread.
template <int K, int MAXT>
__global__ void __launch_bounds__(MAXT) waterfill_block(Rows a) {
  __shared__ double buf[2][kMaxWarps];
  const int warp = threadIdx.x / kWarp;
  const bool lead = threadIdx.x % kWarp == 0;
  const Row row = row_of(a, blockIdx.x);
  Lanes<K> l;
  l.load(row, warp, a.width);
  double free_slots = row.slots;

  for (int r = 0; r <= a.width; ++r) {
    if (!(free_slots > kEps)) break;
    const double wsum = l.weight();
    if (lead) buf[0][warp] = wsum;
    if (__syncthreads_or(l.active != 0u) == 0) break;
    const double total_w = gather(buf[0]);
    const bool w_ok = total_w > 0.0;
    const double denom = w_ok ? total_w : 1.0;
    const double gsum = l.cap(free_slots, denom);
    if (lead) buf[1][warp] = gsum;
    const bool any_capped = __syncthreads_or(l.capped != 0u) != 0;
    const bool cont = w_ok && any_capped;
    l.update(cont, w_ok);
    if (!cont) break;
    free_slots = free_slots - gather(buf[1]);
  }
  l.store(row, a.width);
}

template <int K>
cudaError_t launch_warp(const Rows& a, cudaStream_t s) {
  const int blocks = (a.total + kRowsPerBlock - 1) / kRowsPerBlock;
  waterfill_warp<K><<<blocks, kRowsPerBlock * kWarp, 0, s>>>(a);
  return cudaGetLastError();
}

template <int K, int MAXT>
cudaError_t launch_block(const Rows& a, int threads, cudaStream_t s) {
  waterfill_block<K, MAXT><<<a.total, threads, 0, s>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Rows& a, cudaStream_t s) {
  const int width = a.width;
  if (width <= kWarp) return launch_warp<1>(a, s);
  if (width <= 2 * kWarp) return launch_warp<2>(a, s);
  if (width <= 4 * kWarp) return launch_warp<4>(a, s);
  if (width <= kSegment) return launch_warp<8>(a, s);
  const int segments = (width + kSegment - 1) / kSegment;
  const int warps = segments < kMaxWarps ? segments : kMaxWarps;
  const int threads = warps * kWarp;
  if (segments <= 16) return launch_block<8, 512>(a, threads, s);
  if (segments <= 32) return launch_block<8, 1024>(a, threads, s);
  if (segments <= 64) return launch_block<16, 1024>(a, threads, s);
  return launch_block<32, 1024>(a, threads, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes): `phases` (1 or 2) phases of
// `rows` rows each, all of `width` (1 ... 32768) lanes, sharing `ws`.
// Phase 0 reads caps_m, slots_m, live_m and writes out_m; phase 1 the *_r
// pointers (ignored when phases == 1).  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int repro_waterfill_f64(const double* caps_m, const double* caps_r,
                                   const double* ws, const double* slots_m,
                                   const double* slots_r,
                                   const uint8_t* live_m,
                                   const uint8_t* live_r, double* out_m,
                                   double* out_r, int rows, int phases,
                                   int width, void* stream) {
  if (rows <= 0 || width <= 0 || width > kMaxWidth ||
      (phases != 1 && phases != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = phases == 2;
  const Rows a{{caps_m, two ? caps_r : caps_m},
               {slots_m, two ? slots_r : slots_m},
               {live_m, two ? live_r : live_m},
               {out_m, two ? out_r : out_m},
               ws, rows, rows * phases, width};
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}
