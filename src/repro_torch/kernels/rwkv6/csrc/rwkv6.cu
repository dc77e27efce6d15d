// RWKV6 chunked WKV scan (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6/kernel.py::_rwkv6_kernel
// (reached through rwkv6_chunked_bhtd): the recurrence
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
// evaluated chunk by chunk in its chunked form.  Per chunk of c rows, f32:
//   cum   = cumsum(log max(w, 1e-38))          inclusive, per channel
//   a_pre = exp(cum - log w)                    decay before each token
//   o     = (r a_pre) S  +  tril_{-1}((r a_pre)(k / max(a_pre w, 1e-30))^T) v
//         + (sum_d r u k) v
//   S     = exp(total) S + (k exp(total - cum))^T v
// Inputs r, k, v are f32 or bf16 (read through their strides, head dim
// contiguous); w, u and s0 are f32.  The output is in r's dtype, the final
// state f32.  The clamps are the reference's, so is its behaviour under
// strong decays (a cumulative decay below 1e-30 breaks the ratio form).
//
// Design (a simple, correct first kernel)
// * One thread block per (head, batch) walks the chunks in order: the TPU
//   kernel's sequential chunk grid axis becomes a loop inside the block,
//   and the (d x d) state stays in shared memory between chunks.
// * Per chunk: stage the r, k, v, w tiles as f32 (rows at or past t read
//   as r = k = v = 0, w = 1: the reference's padding, with no copies); one
//   thread per channel takes the cumulative log-decay down its column
//   while other threads take the bonus diagonal of each row; an
//   elementwise pass turns r into r a_pre, w into the inverse-decayed k
//   and k into the end-decayed k; then the c x c scores, the output
//   (inter-chunk, intra-chunk and diagonal terms, each summed apart and
//   added in the reference's order) and the new state.  256 threads as
//   16 x 16 each own a register tile of every product; the tiles are read
//   from shared memory as float4 along the reduction where the layout
//   allows it.  Rows are padded by 4 floats so that float4 reads of
//   consecutive rows fall in distinct banks.
// * No atomics and a fixed order of every sum: reruns are bitwise equal.
// * Built without fast math: fmaxf(w, 1e-38f) keeps its subnormal
//   constant and logf/expf are the accurate ones.
//
// Bound on the card: at the main path's shape (b, h, t, d) = (4, 32, 4096,
// 64), chunk 64, the four products are ~1.3e10 flops (the strictly lower
// triangle of the scores counted) over ~0.41 GB, so the kernel is bound
// by f32 operations (67 TFLOP/s outside the tensor cores).  The f32
// yardstick is the reference's: the ratio form multiplies terms scaled by
// 1/cumulative-decay, which a bf16 or TF32 product would round outside the
// tolerance.  This kernel does them as f32 FMAs with one block per
// (b, h): 128 blocks on 132 SMs, each one block deep, with the chunks in
// sequence; splitting the dv columns of the state over more blocks is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // floats of padding per shared row

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  void* o;
  float* s_out;
  int64_t r_b, r_h, r_t, k_b, k_h, k_t, v_b, v_h, v_t, w_b, w_h, w_t, o_b,
      o_h, o_t;
  int h, t;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

__device__ __forceinline__ float lane(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// VN consecutive floats from shared memory (VN in {1, 2, 4}, aligned).
template <int VN>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[VN]) {
  if constexpr (VN == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else if constexpr (VN == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

template <int C, int D>
struct Layout {
  static constexpr int LD = D + kPad;  // row stride of the (c x d) tiles and S
  static constexpr int LP = C + kPad;  // row stride of the score tile
  static constexpr int RC = C / 16;    // score/output rows per thread
  static constexpr int TXV = D < 16 ? D : 16;  // threads across the d columns
  static constexpr int VN = D / TXV;   // consecutive columns per thread
  static constexpr int RD = (D + 15) / 16;  // state rows per thread
  static constexpr int TILE = C * LD;
  static constexpr size_t floats =
      5 * TILE + D * LD + C * LP + C + 2 * D;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int C, int D>
__global__ void __launch_bounds__(kThreads, 1) rwkv6_fwd(Params p) {
  using L = Layout<C, D>;
  constexpr int LD = L::LD, LP = L::LP, RC = L::RC, TXV = L::TXV,
                VN = L::VN, RD = L::RD;
  static_assert(C % 16 == 0 && D % 4 == 0 && D <= 64 && C <= 64,
                "chunk in {16, 32, 64}, head dim in {8, 16, 32, 64}");

  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // r, then r a_pre    [C][LD]
  float* ks = rs + L::TILE;                     // k, then k decayed  [C][LD]
  float* vs = ks + L::TILE;                     // v                  [C][LD]
  float* ws = vs + L::TILE;                     // w, then k / (a_pre w)
  float* cs = ws + L::TILE;                     // inclusive cum log w
  float* ss = cs + L::TILE;                     // state              [D][LD]
  float* ps = ss + D * LD;                      // scores             [C][LP]
  float* diag = ps + C * LP;                    // [C]
  float* tot = diag + C;                        // [D]
  float* us = tot + D;                          // [D]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(bb) * p.h + hh;

  const T* rg = static_cast<const T*>(p.r) + bb * p.r_b + hh * p.r_h;
  const T* kg = static_cast<const T*>(p.k) + bb * p.k_b + hh * p.k_h;
  const T* vg = static_cast<const T*>(p.v) + bb * p.v_b + hh * p.v_h;
  const float* wg = p.w + bb * p.w_b + hh * p.w_h;
  T* og = static_cast<T*>(p.o) + bb * p.o_b + hh * p.o_h;

  for (int e = tid; e < D * D; e += kThreads)
    ss[(e / D) * LD + e % D] = p.s0[bh * D * D + e];
  for (int e = tid; e < D; e += kThreads) us[e] = p.u[hh * D + e];

  float sn[RD][VN];  // this thread's tile of the new state
  const int n_chunks = (p.t + C - 1) / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * C;

    // 1. Stage the chunk's tiles; rows at or past t are the padding.
    for (int e = tid; e < C * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const int row = c0 + i;
      const bool in = row < p.t;
      const int idx = i * LD + d;
      rs[idx] = in ? to_f32(rg[row * p.r_t + d]) : 0.f;
      ks[idx] = in ? to_f32(kg[row * p.k_t + d]) : 0.f;
      vs[idx] = in ? to_f32(vg[row * p.v_t + d]) : 0.f;
      ws[idx] = in ? wg[row * p.w_t + d] : 1.f;
    }
    __syncthreads();

    // 2. Cumulative log-decay down each channel (threads 0..D-1); the
    //    bonus diagonal sum_d r u k of each row (threads 64..64+C-1).
    if (tid < D) {
      float cum = 0.f;
      for (int i = 0; i < C; ++i) {
        cum += logf(fmaxf(ws[i * LD + tid], 1e-38f));
        cs[i * LD + tid] = cum;
      }
      tot[tid] = cum;
    } else if (tid >= 64 && tid < 64 + C) {
      const int i = tid - 64;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        acc += rs[i * LD + d] * us[d] * ks[i * LD + d];
      diag[i] = acc;
    }
    __syncthreads();

    // 3. Elementwise: r a_pre, k / max(a_pre w, 1e-30), k exp(total - cum).
    for (int e = tid; e < C * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const int idx = i * LD + d;
      const float w = ws[idx];
      const float cum = cs[idx];
      const float a_pre = expf(cum - logf(fmaxf(w, 1e-38f)));
      const float kk = ks[idx];
      rs[idx] *= a_pre;
      ws[idx] = kk / fmaxf(a_pre * w, 1e-30f);
      ks[idx] = kk * expf(tot[d] - cum);
    }
    __syncthreads();

    // 4. Scores (r a_pre)(k / (a_pre w))^T, strictly lower triangle;
    //    thread rows ty + 16 a, columns tx + 16 b.
    {
      float s[RC][RC];
#pragma unroll
      for (int a = 0; a < RC; ++a)
#pragma unroll
        for (int b = 0; b < RC; ++b) s[a][b] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 ra[RC], kb[RC];
#pragma unroll
        for (int a = 0; a < RC; ++a)
          ra[a] = *reinterpret_cast<const float4*>(&rs[(ty + 16 * a) * LD + d]);
#pragma unroll
        for (int b = 0; b < RC; ++b)
          kb[b] = *reinterpret_cast<const float4*>(&ws[(tx + 16 * b) * LD + d]);
#pragma unroll
        for (int a = 0; a < RC; ++a)
#pragma unroll
          for (int b = 0; b < RC; ++b) {
            float x = s[a][b];
            x = fmaf(ra[a].x, kb[b].x, x);
            x = fmaf(ra[a].y, kb[b].y, x);
            x = fmaf(ra[a].z, kb[b].z, x);
            x = fmaf(ra[a].w, kb[b].w, x);
            s[a][b] = x;
          }
      }
#pragma unroll
      for (int a = 0; a < RC; ++a)
#pragma unroll
        for (int b = 0; b < RC; ++b) {
          const int i = ty + 16 * a, j = tx + 16 * b;
          ps[i * LP + j] = j < i ? s[a][b] : 0.f;
        }
    }
    __syncthreads();

    // 5. Output rows ty + 16 a, columns tx * VN + n; state rows ty + 16 a,
    //    the same columns.  Both read the old state; the new one is kept
    //    in registers until every thread is done with it.
    if (tx < TXV) {
      const int col = tx * VN;
      float inter[RC][VN], intra[RC][VN];
#pragma unroll
      for (int a = 0; a < RC; ++a)
#pragma unroll
        for (int n = 0; n < VN; ++n) inter[a][n] = intra[a][n] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 ra[RC];
#pragma unroll
        for (int a = 0; a < RC; ++a)
          ra[a] = *reinterpret_cast<const float4*>(&rs[(ty + 16 * a) * LD + d]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv[VN];
          load_vec<VN>(&ss[(d + e) * LD + col], sv);
#pragma unroll
          for (int a = 0; a < RC; ++a)
#pragma unroll
            for (int n = 0; n < VN; ++n)
              inter[a][n] = fmaf(lane(ra[a], e), sv[n], inter[a][n]);
        }
      }
#pragma unroll 2
      for (int j = 0; j < C; j += 4) {
        float4 pa[RC];
#pragma unroll
        for (int a = 0; a < RC; ++a)
          pa[a] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * a) * LP + j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float vv[VN];
          load_vec<VN>(&vs[(j + e) * LD + col], vv);
#pragma unroll
          for (int a = 0; a < RC; ++a)
#pragma unroll
            for (int n = 0; n < VN; ++n)
              intra[a][n] = fmaf(lane(pa[a], e), vv[n], intra[a][n]);
        }
      }
#pragma unroll
      for (int a = 0; a < RC; ++a) {
        const int i = ty + 16 * a;
        const int row = c0 + i;
        if (row >= p.t) continue;
        float vv[VN];
        load_vec<VN>(&vs[i * LD + col], vv);
        T* orow = og + row * p.o_t + col;
#pragma unroll
        for (int n = 0; n < VN; ++n)
          orow[n] = from_f32<T>(inter[a][n] + intra[a][n] + diag[i] * vv[n]);
      }

#pragma unroll
      for (int a = 0; a < RD; ++a)
#pragma unroll
        for (int n = 0; n < VN; ++n) sn[a][n] = 0.f;
#pragma unroll 4
      for (int i = 0; i < C; ++i) {
        float kd[RD], vv[VN];
#pragma unroll
        for (int a = 0; a < RD; ++a) {
          const int d = ty + 16 * a;
          kd[a] = d < D ? ks[i * LD + d] : 0.f;
        }
        load_vec<VN>(&vs[i * LD + col], vv);
#pragma unroll
        for (int a = 0; a < RD; ++a)
#pragma unroll
          for (int n = 0; n < VN; ++n) sn[a][n] = fmaf(kd[a], vv[n], sn[a][n]);
      }
#pragma unroll
      for (int a = 0; a < RD; ++a) {
        const int d = ty + 16 * a;
        if (d >= D) continue;
        const float decay = expf(tot[d]);
#pragma unroll
        for (int n = 0; n < VN; ++n)
          sn[a][n] = decay * ss[d * LD + col + n] + sn[a][n];
      }
    }
    __syncthreads();  // every read of the old state and the tiles done
    if (tx < TXV) {
#pragma unroll
      for (int a = 0; a < RD; ++a) {
        const int d = ty + 16 * a;
        if (d >= D) continue;
#pragma unroll
        for (int n = 0; n < VN; ++n) ss[d * LD + tx * VN + n] = sn[a][n];
      }
    }
  }

  if (tx < TXV) {
#pragma unroll
    for (int a = 0; a < RD; ++a) {
      const int d = ty + 16 * a;
      if (d >= D) continue;
#pragma unroll
      for (int n = 0; n < VN; ++n)
        p.s_out[bh * D * D + d * D + tx * VN + n] = sn[a][n];
    }
  }
}

template <typename T, int C, int D>
int launch(const Params& p, int b, int h, cudaStream_t stream) {
  constexpr size_t bytes = Layout<C, D>::bytes;
  static bool configured = false;  // per instantiation, on first launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_fwd<T, C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  rwkv6_fwd<T, C, D><<<dim3(h, b), kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_d(const Params& p, int d, int b, int h, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, C, 8>(p, b, h, stream);
    case 16: return launch<T, C, 16>(p, b, h, stream);
    case 32: return launch<T, C, 32>(p, b, h, stream);
    case 64: return launch<T, C, 64>(p, b, h, stream);
    default: return -1;
  }
}

template <typename T>
int launch_cd(const Params& p, int chunk, int d, int b, int h,
              cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch_d<T, 16>(p, d, b, h, stream);
    case 32: return launch_d<T, 32>(p, d, b, h, stream);
    case 64: return launch_d<T, 64>(p, d, b, h, stream);
    default: return -1;
  }
}

}  // namespace

// strides: 15 element strides, (batch, head, time) of r, k, v, w and o; the
// head dim is contiguous in all five.  u is (h, d) and s0, s_out are
// (b, h, d, d), contiguous.  dtype (of r, k, v and o) 0 = f32, 1 = bf16.
// Returns a cudaError_t of the launch (0 on success), or -1 for an
// unsupported chunk, head dim or dtype.
extern "C" int repro_rwkv6_fwd(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* o, void* s_out, const int64_t* strides,
                               int b, int h, int t, int d, int chunk,
                               int dtype, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0) return -1;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.o = o;
  p.s_out = static_cast<float*>(s_out);
  p.r_b = strides[0]; p.r_h = strides[1]; p.r_t = strides[2];
  p.k_b = strides[3]; p.k_h = strides[4]; p.k_t = strides[5];
  p.v_b = strides[6]; p.v_h = strides[7]; p.v_t = strides[8];
  p.w_b = strides[9]; p.w_h = strides[10]; p.w_t = strides[11];
  p.o_b = strides[12]; p.o_h = strides[13]; p.o_t = strides[14];
  p.h = h;
  p.t = t;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cd<float>(p, chunk, d, b, h, s);
  if (dtype == 1) return launch_cd<__nv_bfloat16>(p, chunk, d, b, h, s);
  return -1;
}
