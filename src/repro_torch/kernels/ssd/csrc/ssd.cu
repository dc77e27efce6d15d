// Mamba2 SSD chunked scan (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::_ssd_kernel
// (reached through ssd_chunked_bhtp): the recurrence
//   S_t = a_t S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
// with a scalar decay a and step dt per (head, token), B and C (b, t, n)
// shared across heads, evaluated chunk by chunk.  Per chunk of c rows, f32:
//   cum    = cumsum(log max(a, 1e-38))                       inclusive
//   scores = where(j <= i, exp(cum_i - cum_j) (C B^T)_ij dt_j, 0)
//   y      = scores x + exp(cum) (C S^T)
//   S      = exp(total) S + (x dt exp(total - cum))^T B
// x, B and C are f32 or bf16 (read through their strides, the last dim
// contiguous); dt, a and s0 are f32.  y is in x's dtype, the state f32.
//
// Design (a simple, correct first kernel)
// * One thread block per (head, batch) walks the chunks in order: the TPU
//   kernel's sequential chunk grid axis becomes a loop inside the block,
//   and the (p x n) state stays in shared memory between chunks.
// * Per chunk: stage the x, B and C tiles as f32 and dt, log a as scalars
//   (rows at or past t read as x = B = C = dt = 0, a = 1: the reference's
//   padding, with no copies); warp 0 takes the inclusive prefix sum of the
//   c log-decays with warp shuffles and forms exp(cum) and
//   dt exp(total - cum) per row; then the c x c scores, the output and the
//   new state.  256 threads as 16 x 16 each own a register tile of every
//   product; the tiles are read from shared memory as float4 along the
//   reduction where the layout allows it.  Rows are padded so that float4
//   reads of consecutive rows fall in distinct banks.
// * Masking is a select: above the diagonal cum_i - cum_j > 0 and exp may
//   overflow to inf, which a multiply by 0 would turn into NaN.
// * No atomics and a fixed order of every sum: reruns are bitwise equal.
// * Built without fast math and without -ftz: fmaxf(a, 1e-38f) keeps its
//   subnormal constant, and logf/expf are the accurate ones.
//
// Bound on the card: at zamba2-2.7b's prefill call (b, h, t, p, n) =
// (4, 80, 4096, 64, 64), chunk 64, the function needs ~2.7e10 flops (the
// lower triangle of C B^T once per (batch, chunk), since B and C are
// shared across heads, and of scores x per head; C S^T and the state
// update in full) over ~0.36 GB, so it is bound by f32 operations (67
// TFLOP/s outside the tensor cores; the reference computes the chunked
// form in f32).  This kernel forms C B^T per head and the full score
// tile (~4.3e10 flops of FMAs), one block per (b, h): 320 blocks of ~89 KB
// of shared memory, two per SM, about 1.2 waves on 132 SMs.  Sharing C B^T
// across the heads of a batch row, wgmma tiles and TMA loads are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per x/B/C/S row

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* B;
  const void* C;
  const float* s0;
  void* y;
  float* s_out;
  int64_t x_b, x_h, x_t, dt_b, dt_h, dt_t, a_b, a_h, a_t, B_b, B_t, C_b, C_t,
      y_b, y_h, y_t;
  int h, t;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int C, int P, int N>
struct Layout {
  static constexpr int LP = P + kPad;  // row stride of the x tile
  static constexpr int LN = N + kPad;  // row stride of the B, C tiles and S
  static constexpr int LC = C + 16;    // row stride of the score tile: the
                                       // two rows a warp writes land in
                                       // disjoint banks
  static constexpr int RC = C / 16;    // score and output rows per thread
  static constexpr int TXP = P < 16 ? P : 16;  // threads across p (output)
  static constexpr int VP = P / TXP;           // output columns per thread
  static constexpr int TXN = N < 16 ? N : 16;  // threads across n (state)
  static constexpr int VN = N / TXN;           // state columns per thread
  static constexpr int RP = (P + 15) / 16;     // state rows per thread
  static constexpr size_t floats =
      C * LP + 2 * C * LN + P * LN + C * LC + 4 * C + 4;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int C, int P, int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd(Params p) {
  using L = Layout<C, P, N>;
  constexpr int LP = L::LP, LN = L::LN, LC = L::LC, RC = L::RC, TXP = L::TXP,
                VP = L::VP, TXN = L::TXN, VN = L::VN, RP = L::RP;
  static_assert(C % 16 == 0 && C <= 64 && P % 8 == 0 && P <= 64 &&
                    N % 8 == 0 && N <= 64,
                "chunk in {16, 32, 64}, p and n in {8, 16, 32, 64}");

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // x           [C][LP]
  float* bs = xs + C * LP;                      // B           [C][LN]
  float* cs = bs + C * LN;                      // C           [C][LN]
  float* ss = cs + C * LN;                      // state       [P][LN]
  float* ps = ss + P * LN;                      // scores      [C][LC]
  float* cum = ps + C * LC;                     // log a, then cum  [C]
  float* dts = cum + C;                         // dt          [C]
  float* ecum = dts + C;                        // exp(cum)    [C]
  float* wrow = ecum + C;                       // dt exp(total - cum) [C]
  float* dec = wrow + C;                        // exp(total)  [1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(bb) * p.h + hh;

  const T* xg = static_cast<const T*>(p.x) + bb * p.x_b + hh * p.x_h;
  const float* dtg = p.dt + bb * p.dt_b + hh * p.dt_h;
  const float* ag = p.a + bb * p.a_b + hh * p.a_h;
  const T* bg = static_cast<const T*>(p.B) + bb * p.B_b;
  const T* cg = static_cast<const T*>(p.C) + bb * p.C_b;
  T* yg = static_cast<T*>(p.y) + bb * p.y_b + hh * p.y_h;

  for (int e = tid; e < P * N; e += kThreads)
    ss[(e / N) * LN + e % N] = p.s0[bh * P * N + e];

  float sn[RP][VN];  // this thread's tile of the new state
  const int n_chunks = (p.t + C - 1) / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * C;

    // 1. Stage the chunk; rows at or past t are the padding.
    for (int e = tid; e < C * P; e += kThreads) {
      const int i = e / P, col = e % P;
      const int row = c0 + i;
      xs[i * LP + col] = row < p.t ? to_f32(xg[row * p.x_t + col]) : 0.f;
    }
    for (int e = tid; e < C * N; e += kThreads) {
      const int i = e / N, col = e % N;
      const int row = c0 + i;
      const bool in = row < p.t;
      bs[i * LN + col] = in ? to_f32(bg[row * p.B_t + col]) : 0.f;
      cs[i * LN + col] = in ? to_f32(cg[row * p.C_t + col]) : 0.f;
    }
    if (tid < C) {
      const int row = c0 + tid;
      const bool in = row < p.t;
      dts[tid] = in ? dtg[row * p.dt_t] : 0.f;
      cum[tid] = logf(fmaxf(in ? ag[row * p.a_t] : 1.f, 1e-38f));
    }
    __syncthreads();

    // 2. Warp 0: inclusive prefix sum of the log-decays (R consecutive
    //    rows per lane, then a shuffle scan of the lane sums), and the
    //    per-row factors exp(cum) and dt exp(total - cum).
    if (tid < 32) {
      constexpr int R = C > 32 ? C / 32 : 1;
      const int lane = tid;
      float loc[R];
      float run = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane * R + r;
        run += i < C ? cum[i] : 0.f;
        loc[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      float cm[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cm[r] = excl + loc[r];
      const float total = __shfl_sync(0xffffffffu, cm[R - 1], (C - 1) / R);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane * R + r;
        if (i < C) {
          cum[i] = cm[r];
          ecum[i] = expf(cm[r]);
          wrow[i] = dts[i] * expf(total - cm[r]);
        }
      }
      if (lane == 0) dec[0] = expf(total);
    }
    __syncthreads();

    // 3. Scores: rows ty + 16 a, columns tx + 16 b; (C B^T) over n, then
    //    exp(cum_i - cum_j) (C B^T) dt_j on and below the diagonal.
    {
      float s[RC][RC];
#pragma unroll
      for (int a = 0; a < RC; ++a)
#pragma unroll
        for (int b = 0; b < RC; ++b) s[a][b] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; k += 4) {
        float4 ca[RC], bv[RC];
#pragma unroll
        for (int a = 0; a < RC; ++a)
          ca[a] = *reinterpret_cast<const float4*>(&cs[(ty + 16 * a) * LN + k]);
#pragma unroll
        for (int b = 0; b < RC; ++b)
          bv[b] = *reinterpret_cast<const float4*>(&bs[(tx + 16 * b) * LN + k]);
#pragma unroll
        for (int a = 0; a < RC; ++a)
#pragma unroll
          for (int b = 0; b < RC; ++b) {
            float v = s[a][b];
            v = fmaf(ca[a].x, bv[b].x, v);
            v = fmaf(ca[a].y, bv[b].y, v);
            v = fmaf(ca[a].z, bv[b].z, v);
            v = fmaf(ca[a].w, bv[b].w, v);
            s[a][b] = v;
          }
      }
#pragma unroll
      for (int a = 0; a < RC; ++a)
#pragma unroll
        for (int b = 0; b < RC; ++b) {
          const int i = ty + 16 * a, j = tx + 16 * b;
          float v = 0.f;
          if (j <= i) v = expf(cum[i] - cum[j]) * s[a][b] * dts[j];
          ps[i * LC + j] = v;
        }
    }
    __syncthreads();

    // 4. Output rows ty + 16 a, columns tx + TXP v: scores x (intra) and
    //    exp(cum) (C S^T) (inter).  State rows ty + 16 r, columns
    //    tx + TXN v: exp(total) S + (x dt exp(total - cum))^T B.  Both read
    //    the old state; the new one stays in registers until every thread
    //    is done with it.
    if (tx < TXP) {
      float inter[RC][VP], intra[RC][VP];
#pragma unroll
      for (int a = 0; a < RC; ++a)
#pragma unroll
        for (int v = 0; v < VP; ++v) inter[a][v] = intra[a][v] = 0.f;
#pragma unroll 2
      for (int k = 0; k < N; k += 4) {
        float4 ca[RC];
#pragma unroll
        for (int a = 0; a < RC; ++a)
          ca[a] = *reinterpret_cast<const float4*>(&cs[(ty + 16 * a) * LN + k]);
#pragma unroll
        for (int v = 0; v < VP; ++v) {
          const float4 sv =
              *reinterpret_cast<const float4*>(&ss[(tx + TXP * v) * LN + k]);
#pragma unroll
          for (int a = 0; a < RC; ++a) {
            float acc = inter[a][v];
            acc = fmaf(ca[a].x, sv.x, acc);
            acc = fmaf(ca[a].y, sv.y, acc);
            acc = fmaf(ca[a].z, sv.z, acc);
            acc = fmaf(ca[a].w, sv.w, acc);
            inter[a][v] = acc;
          }
        }
      }
#pragma unroll 2
      for (int j = 0; j < C; j += 4) {
        float4 pa[RC];
#pragma unroll
        for (int a = 0; a < RC; ++a)
          pa[a] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * a) * LC + j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float xv[VP];
#pragma unroll
          for (int v = 0; v < VP; ++v) xv[v] = xs[(j + e) * LP + tx + TXP * v];
#pragma unroll
          for (int a = 0; a < RC; ++a)
#pragma unroll
            for (int v = 0; v < VP; ++v)
              intra[a][v] = fmaf(lane_of(pa[a], e), xv[v], intra[a][v]);
        }
      }
#pragma unroll
      for (int a = 0; a < RC; ++a) {
        const int i = ty + 16 * a;
        const int row = c0 + i;
        if (row >= p.t) continue;
        T* yrow = yg + row * p.y_t;
#pragma unroll
        for (int v = 0; v < VP; ++v)
          yrow[tx + TXP * v] = from_f32<T>(intra[a][v] + ecum[i] * inter[a][v]);
      }
    }
    if (tx < TXN) {
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int v = 0; v < VN; ++v) sn[r][v] = 0.f;
#pragma unroll 4
      for (int i = 0; i < C; ++i) {
        const float w = wrow[i];
        float xw[RP], bv[VN];
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const int pp = ty + 16 * r;
          xw[r] = pp < P ? xs[i * LP + pp] * w : 0.f;
        }
#pragma unroll
        for (int v = 0; v < VN; ++v) bv[v] = bs[i * LN + tx + TXN * v];
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int v = 0; v < VN; ++v) sn[r][v] = fmaf(xw[r], bv[v], sn[r][v]);
      }
      const float d = dec[0];
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int pp = ty + 16 * r;
        if (pp >= P) continue;
#pragma unroll
        for (int v = 0; v < VN; ++v)
          sn[r][v] = d * ss[pp * LN + tx + TXN * v] + sn[r][v];
      }
    }
    __syncthreads();  // every read of the old state and the tiles done
    if (tx < TXN) {
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int pp = ty + 16 * r;
        if (pp >= P) continue;
#pragma unroll
        for (int v = 0; v < VN; ++v) ss[pp * LN + tx + TXN * v] = sn[r][v];
      }
    }
  }

  if (tx < TXN) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int pp = ty + 16 * r;
      if (pp >= P) continue;
#pragma unroll
      for (int v = 0; v < VN; ++v)
        p.s_out[bh * P * N + pp * N + tx + TXN * v] = sn[r][v];
    }
  }
}

template <typename T, int C, int P, int N>
int launch(const Params& p, int b, int h, cudaStream_t stream) {
  constexpr size_t bytes = Layout<C, P, N>::bytes;
  static bool configured = false;  // per instantiation, on first launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fwd<T, C, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  ssd_fwd<T, C, P, N><<<dim3(h, b), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, int P>
int launch_n(const Params& p, int n, int b, int h, cudaStream_t stream) {
  switch (n) {
    case 8: return launch<T, C, P, 8>(p, b, h, stream);
    case 16: return launch<T, C, P, 16>(p, b, h, stream);
    case 32: return launch<T, C, P, 32>(p, b, h, stream);
    case 64: return launch<T, C, P, 64>(p, b, h, stream);
    default: return -1;
  }
}

template <typename T, int C>
int launch_pn(const Params& p, int pd, int n, int b, int h,
              cudaStream_t stream) {
  switch (pd) {
    case 8: return launch_n<T, C, 8>(p, n, b, h, stream);
    case 16: return launch_n<T, C, 16>(p, n, b, h, stream);
    case 32: return launch_n<T, C, 32>(p, n, b, h, stream);
    case 64: return launch_n<T, C, 64>(p, n, b, h, stream);
    default: return -1;
  }
}

template <typename T>
int launch_cpn(const Params& p, int chunk, int pd, int n, int b, int h,
               cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch_pn<T, 16>(p, pd, n, b, h, stream);
    case 32: return launch_pn<T, 32>(p, pd, n, b, h, stream);
    case 64: return launch_pn<T, 64>(p, pd, n, b, h, stream);
    default: return -1;
  }
}

}  // namespace

// strides: 16 element strides: (batch, head, time) of x, dt and a;
// (batch, time) of B and C; (batch, head, time) of y.  The last dim of x,
// B, C and y is contiguous; s0 and s_out are (b, h, p, n), contiguous.
// dtype (of x, B, C and y) 0 = f32, 1 = bf16.  Returns a cudaError_t of
// the launch (0 on success), or -1 for an unsupported chunk, p, n or dtype.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* a,
                             const void* B, const void* C, const void* s0,
                             void* y, void* s_out, const int64_t* strides,
                             int b, int h, int t, int pd, int n, int chunk,
                             int dtype, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0) return -1;
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.B = B;
  p.C = C;
  p.s0 = static_cast<const float*>(s0);
  p.y = y;
  p.s_out = static_cast<float*>(s_out);
  p.x_b = strides[0]; p.x_h = strides[1]; p.x_t = strides[2];
  p.dt_b = strides[3]; p.dt_h = strides[4]; p.dt_t = strides[5];
  p.a_b = strides[6]; p.a_h = strides[7]; p.a_t = strides[8];
  p.B_b = strides[9]; p.B_t = strides[10];
  p.C_b = strides[11]; p.C_t = strides[12];
  p.y_b = strides[13]; p.y_h = strides[14]; p.y_t = strides[15];
  p.h = h;
  p.t = t;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cpn<float>(p, chunk, pd, n, b, h, s);
  if (dtype == 1) return launch_cpn<__nv_bfloat16>(p, chunk, pd, n, b, h, s);
  return -1;
}
