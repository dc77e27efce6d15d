// Mamba2 SSD chunked scan (Hopper, sm_90a): two kernels, ssd_cb and
// ssd_scan, launched one after the other on the caller's stream.
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
// contiguous, rows 16-byte aligned); dt, a and s0 are f32.  y is in x's
// dtype, the state f32.
//
// Design.  Only the last line carries anything from one chunk to the next,
// and it is elementwise in S; everything else of a chunk needs only S.  So
// every chunk gets a block of its own, and the state alone is passed from
// block to block:
// * ssd_cb, grid (chunk, batch): the lower triangle of C_c B_c^T once per
//   (batch, chunk), since B and C are shared across heads, in f32, into a
//   (b, nc, c, c) scratch (zeros above the diagonal).  It also zeroes
//   ssd_scan's tickets and flags.
// * ssd_scan, one 256-thread block per (chunk, head, batch), 20480 at
//   zamba2-2.7b's call.  A block
//   - brings all its tiles at once by cp.async, 16 bytes a thread: the
//     C B^T triangle, x, B and C (rows at or past t zero-filled, a read as
//     1 there: the reference's padding, with no copies), and dt and a (4
//     bytes each: their stride is h).  bf16 tiles land packed and are
//     widened to f32 in shared memory once, since 16 threads read each
//     value;
//   - takes the prefix sum of the log-decays in one warp, turns the
//     triangle into the scores in place (a select: above the diagonal exp
//     may overflow to inf, which a multiply by 0 would turn into NaN), and
//     forms its chunk's term of the state, s_c = (x w)^T B;
//   - waits for the state entering its chunk, which the block of the chunk
//     before publishes in a two-slot ring per (batch, head) (10 MB at
//     zamba2's call, so it stays in L2), publishes exp(total) S_in + s_c
//     for the next chunk (or writes the final state), and only then
//   - computes y = scores x + exp(cum) (C S_in^T) straight into
//     (b, t, h, p); each warp reads the scores only up to its last row's
//     diagonal, so scores x skips the upper triangle.
//   Blocks take their chunk from an atomic ticket, chunk by chunk across
//   every (batch, head), so the block a block waits on started before it:
//   the wait cannot deadlock, and the chain of 64 hand-overs runs beside
//   the parallel work instead of after it.  Every product gives each of
//   the 256 threads a 4 x 4 register tile fed by float4 reads.
// * No atomics in any sum and a fixed order of every sum: reruns are
//   bitwise equal.  Built without fast math and without -ftz:
//   fmaxf(a, 1e-38f) keeps its subnormal constant, and logf/expf are the
//   accurate ones.
//
// Bound on the card, and why this design: at zamba2-2.7b's prefill call
// (b, h, t, p, n) = (4, 80, 4096, 64, 64), chunk 64, the function needs
// ~2.70e10 flops (the lower triangle of C B^T once per (batch, chunk), of
// scores x per head; C S^T and the state update in full) over ~0.36 GB:
// bound by f32 operations, 0.403 ms at 67 TFLOP/s outside the tensor cores
// (the bytes take 0.108 ms at 3.35 TB/s).  Tensor cores are not used: once
// C B^T is shared it is ~0.3% of the work, and every other product takes
// an f32 operand.  Mamba2's four-step split (chunk states, a state pass,
// outputs) writes and reads per-chunk f32 states of (4, 80, 64, 64, 64),
// 0.336 GB each time, ~1.5-1.9 GB of device-memory traffic in all, a floor
// of ~0.5 ms above the function's bound; the ring keeps that traffic in
// L2.  A design that keeps the state on chip instead, one block per
// (16-column slice of p, head, batch) walking the chunks in order, has
// only 1280 blocks of four warps, each chunk a chain of barriers and
// dependent products, too little to hide their latency.  PERF.md has the
// times of the designs tried.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of every kernel
constexpr int kCols = 4;       // columns of p per thread in the products
// Naps of a block waiting for the state entering its chunk: a flag that
// never came would turn the state to NaN after ~0.3 s, not hang the card.
constexpr int kSpinLimit = 1 << 22;

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* B;
  const void* C;
  const float* s0;
  void* y;
  float* s_out;
  float* cb;   // (b, nc, c, c): C B^T per (batch, chunk)
  float* st;   // (b, h, 2, n, p): the state entering chunk c, n by p, in
               // slot c % 2 of a ring per (batch, head)
  int* sync;   // [0]: ssd_scan's tickets; [1 + (b h + h) nc + c]: the
               // state entering chunk c is in the ring
  int64_t x_b, x_h, x_t, dt_b, dt_h, dt_t, a_b, a_h, a_t, B_b, B_t, C_b, C_t,
      y_b, y_h, y_t;
  int b, h, t, p, n, nc;
};

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);  // bf16 -> f32 is exact
  o[1] = __uint_as_float(w & 0xffff0000u);
}

// K contiguous values at s (aligned to their size), as f32.
template <typename T, int K>
__device__ __forceinline__ void load_f32(const T* s, float* o) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (K % 4 == 0) {
#pragma unroll
      for (int m = 0; m < K; m += 4) {
        const float4 v = reinterpret_cast<const float4*>(s)[m / 4];
        o[m] = v.x;
        o[m + 1] = v.y;
        o[m + 2] = v.z;
        o[m + 3] = v.w;
      }
    } else if constexpr (K == 2) {
      const float2 v = *reinterpret_cast<const float2*>(s);
      o[0] = v.x;
      o[1] = v.y;
    } else {
      o[0] = s[0];
    }
  } else {
    if constexpr (K % 8 == 0) {
#pragma unroll
      for (int m = 0; m < K; m += 8) {
        const uint4 v = reinterpret_cast<const uint4*>(s)[m / 8];
        unpack_bf16x2(v.x, o + m);
        unpack_bf16x2(v.y, o + m + 2);
        unpack_bf16x2(v.z, o + m + 4);
        unpack_bf16x2(v.w, o + m + 6);
      }
    } else if constexpr (K == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(s);
      unpack_bf16x2(v.x, o);
      unpack_bf16x2(v.y, o + 2);
    } else if constexpr (K == 2) {
      unpack_bf16x2(*reinterpret_cast<const uint32_t*>(s), o);
    } else {
      o[0] = __bfloat162float(s[0]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // as astype
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 f32 values into 4 contiguous T at d (aligned to their size).
template <typename T>
__device__ __forceinline__ void store4(T* d, const float* v) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint2*>(d) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  }
}

// 16 bytes (4 bytes for cp4) from global to shared memory, asynchronously;
// zeros instead when !in (src is then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
// Waits for every copy this thread issued, then for the whole block.
__device__ __forceinline__ void cp_wait_block() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ int load_acquire(const int* flag) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* flag, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(flag), "r"(v)
               : "memory");
}

// Issues the copies of rows [0, R) of W values of T from src (row stride
// `stride` values) to dst, packed; rows at or past `valid` are zeros.
template <int NT, typename T, int R, int W>
__device__ __forceinline__ void copy_rows(void* dst, const T* src,
                                          int64_t stride, int valid) {
  constexpr int KC = 16 / static_cast<int>(sizeof(T)), NCH = W / KC;
  for (int e = threadIdx.x; e < R * NCH; e += NT) {
    const int i = e / NCH, ch = e - i * NCH;
    const bool in = i < valid;
    cp16(static_cast<char*>(dst) + e * 16, src + (in ? i : 0) * stride + ch * KC,
         in);
  }
}

// Where the copies of an f32 tile of R x W values that arrive as T land:
// f32 in place; bf16 packed in the upper half of the tile, for widen3.
template <typename T, int R, int W>
__device__ __forceinline__ void* landing(float* tile) {
  if constexpr (std::is_same<T, float>::value) return tile;
  return reinterpret_cast<char*>(tile) + R * W * 2;
}

// One tile that landed as bf16 (widen3's reads and writes of it).
template <int NT, int R, int W>
struct Packed {
  static constexpr int NCH = R * W / 8, IT = (NCH + NT - 1) / NT;
  uint4 v[IT];
  __device__ __forceinline__ void read(const float* tile) {
    const uint4* raw = reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(tile) + R * W * 2);
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = threadIdx.x + it * NT;
      if (e < NCH) v[it] = raw[e];
    }
  }
  __device__ __forceinline__ void write(float* tile) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = threadIdx.x + it * NT;
      if (e < NCH)
        load_f32<__nv_bfloat16, 8>(
            reinterpret_cast<const __nv_bfloat16*>(&v[it]), tile + 8 * e);
    }
  }
};

// Three tiles that landed as bf16 become f32 in place: every thread reads
// its chunks, the block synchronises, then every thread writes them
// widened.  Call and return with the block synchronised.
template <int NT, int R1, int W1, int R2, int W2, int R3, int W3>
__device__ __forceinline__ void widen3(float* f1, float* f2, float* f3) {
  Packed<NT, R1, W1> t1;
  Packed<NT, R2, W2> t2;
  Packed<NT, R3, W3> t3;
  t1.read(f1);
  t2.read(f2);
  t3.read(f3);
  __syncthreads();
  t1.write(f1);
  t2.write(f2);
  t3.write(f3);
  __syncthreads();
}

// The chunk's dt and a (4 bytes each: their stride is h) to dts and cum;
// rows at or past `valid` are zeros.
__device__ __forceinline__ void copy_dt_a(float* dts, float* cum,
                                          const float* dtg, int64_t dt_t,
                                          const float* ag, int64_t a_t,
                                          int rows, int valid) {
  const int i = threadIdx.x;
  if (i < rows) {
    const bool in = i < valid;
    const int64_t r = in ? i : 0;
    cp4(dts + i, dtg + r * dt_t, in);
    cp4(cum + i, ag + r * a_t, in);
  }
}

// Warp 0: cum, which holds the chunk's a, becomes the inclusive prefix sum
// of log max(a, 1e-38) (a read as 1 at or past `valid`): R consecutive rows
// per lane, then a shuffle scan of the lane sums.  Returns exp(total).
template <int C>
__device__ __forceinline__ float cumsum_warp0(float* cum, int valid) {
  constexpr int R = C > 32 ? C / 32 : 1;
  const int lane = threadIdx.x;
  float loc[R];
  float run = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane * R + r;
    if (i < C) run += logf(fmaxf(i < valid ? cum[i] : 1.f, 1e-38f));
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
    if (i < C) cum[i] = cm[r];
  }
  return expf(total);
}

// ---------------------------------------------------------------------------
// 1. ssd_cb: (C B^T)_ij for j <= i of one (chunk, batch), zeros above.
// ---------------------------------------------------------------------------
template <typename T, int C, int N>
__global__ void __launch_bounds__(kThreads) ssd_cb(Params p) {
  constexpr int LN = N + 4, RC = C / 16;
  __shared__ __align__(16) float cs[C * LN];
  __shared__ __align__(16) float bs[C * LN];
  const int tid = threadIdx.x;
  const int ci = blockIdx.x, bb = blockIdx.y, c0 = ci * C;
  const int valid = p.t - c0;
  // ssd_scan's tickets and flags start at 0 (it runs after this).
  for (int hh = tid; hh < p.h; hh += kThreads)
    p.sync[1 + (static_cast<int64_t>(bb) * p.h + hh) * p.nc + ci] = 0;
  if (ci == 0 && bb == 0 && tid == 0) p.sync[0] = 0;
  {
    constexpr int KC = 16 / static_cast<int>(sizeof(T)), NCH = N / KC;
    const T* bg = static_cast<const T*>(p.B) + bb * p.B_b + c0 * p.B_t;
    const T* cg = static_cast<const T*>(p.C) + bb * p.C_b + c0 * p.C_t;
    for (int e = tid; e < C * NCH; e += kThreads) {
      const int i = e / NCH, ch = e - i * NCH;
      float bv[KC], cv[KC];
      if (i < valid) {
        load_f32<T, KC>(bg + i * p.B_t + ch * KC, bv);
        load_f32<T, KC>(cg + i * p.C_t + ch * KC, cv);
      } else {
#pragma unroll
        for (int m = 0; m < KC; ++m) bv[m] = cv[m] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < KC; ++m) {
        bs[i * LN + ch * KC + m] = bv[m];
        cs[i * LN + ch * KC + m] = cv[m];
      }
    }
  }
  __syncthreads();

  // Thread (ty, tx) owns rows ty RC + a and columns tx RC + b; a tile
  // wholly above the diagonal (tx > ty) is not computed.
  const int ty = tid / 16, tx = tid % 16;
  float acc[RC][RC];
#pragma unroll
  for (int a = 0; a < RC; ++a)
#pragma unroll
    for (int b = 0; b < RC; ++b) acc[a][b] = 0.f;
  if (tx <= ty) {
#pragma unroll 4
    for (int k = 0; k < N; k += 4) {
      float4 c4[RC], b4[RC];
#pragma unroll
      for (int a = 0; a < RC; ++a)
        c4[a] = *reinterpret_cast<const float4*>(&cs[(ty * RC + a) * LN + k]);
#pragma unroll
      for (int b = 0; b < RC; ++b)
        b4[b] = *reinterpret_cast<const float4*>(&bs[(tx * RC + b) * LN + k]);
#pragma unroll
      for (int a = 0; a < RC; ++a)
#pragma unroll
        for (int b = 0; b < RC; ++b) {
          float v = acc[a][b];
          v = fmaf(c4[a].x, b4[b].x, v);
          v = fmaf(c4[a].y, b4[b].y, v);
          v = fmaf(c4[a].z, b4[b].z, v);
          v = fmaf(c4[a].w, b4[b].w, v);
          acc[a][b] = v;
        }
    }
  }
  float* out = p.cb + (static_cast<int64_t>(bb) * p.nc + ci) * C * C;
#pragma unroll
  for (int a = 0; a < RC; ++a)
#pragma unroll
    for (int b = 0; b < RC; ++b) {
      const int i = ty * RC + a, j = tx * RC + b;
      out[i * C + j] = j <= i ? acc[a][b] : 0.f;
    }
}

// ---------------------------------------------------------------------------
// 2. ssd_scan: one (chunk, head, batch): the state entering the next chunk,
//    then y.
// ---------------------------------------------------------------------------
template <int C, int P, int N>
struct ScanTile {
  static_assert(kCols == 4, "the state and y tiles are 4 columns wide");
  // Lanes are PG column groups (kCols columns of p each) by RG row groups.
  // In the state's product a thread owns TK rows of n; in y's, TR
  // consecutive rows of the chunk, and warp w owns rows [w RPW,
  // (w + 1) RPW).
  static constexpr int PG = P / kCols;
  static constexpr int RG = kThreads / PG;
  static constexpr int TK = (N + RG - 1) / RG;
  static constexpr int TR = (C + RG - 1) / RG;
  static constexpr int RPW = 32 / PG * TR;
  // shared floats: scores [C][C], x [C][P], B [C][N] then S_in^T [N][P],
  // C [C][N], dt [C], w [C], cum [C], exp(total) [4]
  static constexpr int BS = C * N > N * P ? C * N : N * P;
  static constexpr size_t bytes =
      (C * C + C * P + BS + C * N + 3 * C + 4) * sizeof(float);
};

template <typename T, int C, int P, int N>
__global__ void __launch_bounds__(kThreads, 3) ssd_scan(Params p) {
  using L = ScanTile<C, P, N>;
  constexpr int PG = L::PG, TK = L::TK, TR = L::TR, RPW = L::RPW;
  extern __shared__ float4 smem4[];
  __shared__ int ticket, late;
  float* sc = reinterpret_cast<float*>(smem4);  // C B^T, then scores [C][C]
  float* xs = sc + C * C;                        // x       [C][P]
  float* bs = xs + C * P;                        // B, then S_in^T
  float* cs = bs + L::BS;                        // C       [C][N]
  float* dts = cs + C * N;                       // dt      [C]
  float* ws = dts + C;                           // w       [C]
  float* cum = ws + C;                           // cum     [C]
  float* dec = cum + C;                          // exp(total)

  // Blocks take their chunk in the order they start, chunk by chunk across
  // every (batch, head): the block of chunk c - 1 of a (batch, head) holds
  // an earlier ticket, so it started before this one, and waiting on it
  // cannot deadlock.
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) ticket = atomicAdd(p.sync, 1);
  __syncthreads();
  const int rows = p.b * p.h;
  const int ci = ticket / rows, bh = ticket - ci * rows;
  const int bb = bh / p.h, hh = bh - bb * p.h, c0 = ci * C;
  const int valid = p.t - c0;
  const int64_t bhc = static_cast<int64_t>(bh) * p.nc + ci;

  copy_rows<kThreads, float, C, C>(
      sc, p.cb + (static_cast<int64_t>(bb) * p.nc + ci) * C * C, C, C);
  copy_rows<kThreads, T, C, P>(landing<T, C, P>(xs),
                               static_cast<const T*>(p.x) + bb * p.x_b +
                                   hh * p.x_h + c0 * p.x_t,
                               p.x_t, valid);
  copy_rows<kThreads, T, C, N>(landing<T, C, N>(bs),
                               static_cast<const T*>(p.B) + bb * p.B_b +
                                   c0 * p.B_t,
                               p.B_t, valid);
  copy_rows<kThreads, T, C, N>(landing<T, C, N>(cs),
                               static_cast<const T*>(p.C) + bb * p.C_b +
                                   c0 * p.C_t,
                               p.C_t, valid);
  copy_dt_a(dts, cum, p.dt + bb * p.dt_b + hh * p.dt_h + c0 * p.dt_t,
            p.dt_t, p.a + bb * p.a_b + hh * p.a_h + c0 * p.a_t, p.a_t, C,
            valid);
  cp_wait_block();
  if constexpr (!std::is_same<T, float>::value)
    widen3<kThreads, C, P, C, N, C, N>(xs, bs, cs);
  if (tid < 32) {
    const float d = cumsum_warp0<C>(cum, valid);
    if (tid == 0) dec[0] = d;
  }
  __syncthreads();

  // w = dt exp(total - cum); the triangle becomes the scores in place.
  if (tid < C) ws[tid] = dts[tid] * expf(cum[C - 1] - cum[tid]);
  for (int e = tid; e < C * C / 4; e += kThreads) {
    const int i = e / (C / 4), j = 4 * (e - i * (C / 4));
    float4* ptr = reinterpret_cast<float4*>(sc + i * C + j);
    if (j > i) continue;  // zeros already
    float4 v = *ptr;
    const float cmi = cum[i];
    const float4 cj = *reinterpret_cast<const float4*>(cum + j);
    const float4 dj = *reinterpret_cast<const float4*>(dts + j);
    v.x = expf(cmi - cj.x) * v.x * dj.x;
    v.y = j + 1 <= i ? expf(cmi - cj.y) * v.y * dj.y : 0.f;
    v.z = j + 2 <= i ? expf(cmi - cj.z) * v.z * dj.z : 0.f;
    v.w = j + 3 <= i ? expf(cmi - cj.w) * v.w * dj.w : 0.f;
    *ptr = v;
  }
  __syncthreads();

  // This chunk's term of the state, s^T[k][pp] = sum_i B[i][k] (x w)[i][pp]
  // (x w rounded as the reference forms it), on rows k0 + r and columns
  // kCols pg + v.
  const int pg = tid % PG, rg = tid / PG, k0 = rg * TK;
  const bool mine = k0 < N;
  float acc[TK][kCols];
#pragma unroll
  for (int r = 0; r < TK; ++r)
#pragma unroll
    for (int v = 0; v < kCols; ++v) acc[r][v] = 0.f;
  if (mine) {
#pragma unroll 4
    for (int i = 0; i < C; ++i) {
      float bv[TK], xv[kCols];
      load_f32<float, TK>(bs + i * N + k0, bv);
      load_f32<float, kCols>(xs + i * P + kCols * pg, xv);
      const float w = ws[i];
#pragma unroll
      for (int v = 0; v < kCols; ++v) xv[v] = xv[v] * w;
#pragma unroll
      for (int r = 0; r < TK; ++r)
#pragma unroll
        for (int v = 0; v < kCols; ++v)
          acc[r][v] = fmaf(bv[r], xv[v], acc[r][v]);
    }
  }
  __syncthreads();  // B is read; its space takes S_in^T

  // The state entering this chunk: s0 for the first, else what the block of
  // chunk c - 1 published in slot c % 2 of this (batch, head)'s ring (read
  // past L1).  A wait past kSpinLimit naps turns it to NaN.
  float sin[TK][kCols];
  float* ring = p.st + static_cast<int64_t>(bh) * 2 * N * P + kCols * pg;
  if (ci == 0) {
    if (mine)
#pragma unroll
      for (int r = 0; r < TK; ++r)
#pragma unroll
        for (int v = 0; v < kCols; ++v)
          sin[r][v] = p.s0[(static_cast<int64_t>(bh) * p.p + kCols * pg + v) *
                               N + k0 + r];
  } else {
    if (tid == 0) {
      const int* flag = p.sync + 1 + bhc;
      int naps = 0;
      while (load_acquire(flag) == 0 && ++naps < kSpinLimit) __nanosleep(64);
      late = naps >= kSpinLimit;
    }
    __syncthreads();
    if (mine) {
      const float* slot = ring + (ci & 1) * N * P;
#pragma unroll
      for (int r = 0; r < TK; ++r) {
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(slot + (k0 + r) * P));
        sin[r][0] = late ? __int_as_float(0x7fc00000) : v.x;
        sin[r][1] = late ? __int_as_float(0x7fc00000) : v.y;
        sin[r][2] = late ? __int_as_float(0x7fc00000) : v.z;
        sin[r][3] = late ? __int_as_float(0x7fc00000) : v.w;
      }
    }
  }

  // S_in^T to shared memory for y; S_in_{c+1} = exp(total) S_in_c + s_c to
  // slot (c + 1) % 2 and a flag for the next chunk's block, or, after the
  // last chunk, the final state (p by n).
  const float d = dec[0];
  const bool last = ci + 1 == p.nc;
  if (mine) {
    float* next = ring + ((ci + 1) & 1) * N * P;
#pragma unroll
    for (int r = 0; r < TK; ++r) {
      *reinterpret_cast<float4*>(bs + (k0 + r) * P + kCols * pg) =
          make_float4(sin[r][0], sin[r][1], sin[r][2], sin[r][3]);
#pragma unroll
      for (int v = 0; v < kCols; ++v) acc[r][v] = d * sin[r][v] + acc[r][v];
      if (last) {
#pragma unroll
        for (int v = 0; v < kCols; ++v)
          p.s_out[(static_cast<int64_t>(bh) * p.p + kCols * pg + v) * N + k0 +
                  r] = acc[r][v];
      } else {
        *reinterpret_cast<float4*>(next + (k0 + r) * P) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  }
  if (!last) __threadfence();
  __syncthreads();
  if (!last && tid == 0) store_release(p.sync + 2 + bhc, 1);

  // y: rows rg TR + a (a < TR) and columns kCols pg + v.
  int rws[TR];
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int i = rg * TR + a;
    rws[a] = i < C ? i : C - 1;  // a row past the tile is computed, not kept
  }
  float inter[TR][kCols], intra[TR][kCols];
#pragma unroll
  for (int a = 0; a < TR; ++a)
#pragma unroll
    for (int v = 0; v < kCols; ++v) inter[a][v] = intra[a][v] = 0.f;
  // C S_in^T
#pragma unroll 2
  for (int k = 0; k < N; k += 4) {
    float4 c4[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a)
      c4[a] = *reinterpret_cast<const float4*>(cs + rws[a] * N + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv[kCols];
      load_f32<float, kCols>(bs + (k + e) * P + kCols * pg, sv);
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float cv = lane_of(c4[a], e);
#pragma unroll
        for (int v = 0; v < kCols; ++v)
          inter[a][v] = fmaf(cv, sv[v], inter[a][v]);
      }
    }
  }
  // scores x, up to the diagonal of the warp's last row
  const int jend = min(C, (warp + 1) * RPW + 3) & ~3;
#pragma unroll 2
  for (int j = 0; j < jend; j += 4) {
    float4 s4[TR];
#pragma unroll
    for (int a = 0; a < TR; ++a)
      s4[a] = *reinterpret_cast<const float4*>(sc + rws[a] * C + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float xv[kCols];
      load_f32<float, kCols>(xs + (j + e) * P + kCols * pg, xv);
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const float sv = lane_of(s4[a], e);
#pragma unroll
        for (int v = 0; v < kCols; ++v)
          intra[a][v] = fmaf(sv, xv[v], intra[a][v]);
      }
    }
  }
  T* yg = static_cast<T*>(p.y) + bb * p.y_b + hh * p.y_h + kCols * pg;
#pragma unroll
  for (int a = 0; a < TR; ++a) {
    const int i = rg * TR + a;
    if (i >= C || i >= valid) continue;
    const float e = expf(cum[i]);
    float out[kCols];
#pragma unroll
    for (int v = 0; v < kCols; ++v) out[v] = intra[a][v] + e * inter[a][v];
    store4<T>(yg + (c0 + i) * p.y_t, out);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int C, int P, int N>
int launch(const Params& p, int b, int h, cudaStream_t stream) {
  constexpr size_t bytes = ScanTile<C, P, N>::bytes;
  static bool configured = false;  // per instantiation, on first launch
  if (!configured) {
    const int err = allow_smem(ssd_scan<T, C, P, N>, bytes);
    if (err != 0) return err;
    configured = true;
  }
  ssd_cb<T, C, N><<<dim3(p.nc, b), kThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan<T, C, P, N><<<p.nc * h * b, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, int P>
int launch_n(const Params& p, int b, int h, cudaStream_t stream) {
  switch (p.n) {
    case 8: return launch<T, C, P, 8>(p, b, h, stream);
    case 16: return launch<T, C, P, 16>(p, b, h, stream);
    case 32: return launch<T, C, P, 32>(p, b, h, stream);
    case 64: return launch<T, C, P, 64>(p, b, h, stream);
    default: return -1;
  }
}

template <typename T, int C>
int launch_pn(const Params& p, int b, int h, cudaStream_t stream) {
  switch (p.p) {
    case 8: return launch_n<T, C, 8>(p, b, h, stream);
    case 16: return launch_n<T, C, 16>(p, b, h, stream);
    case 32: return launch_n<T, C, 32>(p, b, h, stream);
    case 64: return launch_n<T, C, 64>(p, b, h, stream);
    default: return -1;
  }
}

template <typename T>
int launch_cpn(const Params& p, int chunk, int b, int h,
               cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch_pn<T, 16>(p, b, h, stream);
    case 32: return launch_pn<T, 32>(p, b, h, stream);
    case 64: return launch_pn<T, 64>(p, b, h, stream);
    default: return -1;
  }
}

}  // namespace

// strides: 16 element strides: (batch, head, time) of x, dt and a;
// (batch, time) of B and C; (batch, head, time) of y.  The last dim of x,
// B, C and y is contiguous, and x, B and C rows are 16-byte aligned; s0
// and s_out are (b, h, p, n), contiguous.  Scratch, nc = ceil(t / chunk):
// cb f32 (b, nc, chunk, chunk), st f32 (b, h, 2, n, p), sync int32
// (1 + b h nc).  dtype (of x, B, C and y) 0 = f32, 1 = bf16.  Launches
// ssd_cb and ssd_scan on the stream; returns the
// cudaError_t of the first launch that failed (0 when all were taken), or
// -1 for an unsupported chunk, p, n or dtype.
extern "C" int repro_ssd(const void* x, const void* dt, const void* a,
                         const void* B, const void* C, const void* s0,
                         void* y, void* s_out, void* cb, void* st, void* sync,
                         const int64_t* strides, int b, int h, int t, int pd,
                         int n, int chunk, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || chunk <= 0) return -1;
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.B = B;
  p.C = C;
  p.s0 = static_cast<const float*>(s0);
  p.y = y;
  p.s_out = static_cast<float*>(s_out);
  p.cb = static_cast<float*>(cb);
  p.st = static_cast<float*>(st);
  p.sync = static_cast<int*>(sync);
  p.x_b = strides[0]; p.x_h = strides[1]; p.x_t = strides[2];
  p.dt_b = strides[3]; p.dt_h = strides[4]; p.dt_t = strides[5];
  p.a_b = strides[6]; p.a_h = strides[7]; p.a_t = strides[8];
  p.B_b = strides[9]; p.B_t = strides[10];
  p.C_b = strides[11]; p.C_t = strides[12];
  p.y_b = strides[13]; p.y_h = strides[14]; p.y_t = strides[15];
  p.b = b;
  p.h = h;
  p.t = t;
  p.p = pd;
  p.n = n;
  p.nc = (t + chunk - 1) / chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cpn<float>(p, chunk, b, h, s);
  if (dtype == 1) return launch_cpn<__nv_bfloat16>(p, chunk, b, h, s);
  return -1;
}
