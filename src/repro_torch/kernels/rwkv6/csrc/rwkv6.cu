// RWKV6 chunked WKV scan (Hopper, sm_90a): one kernel, rwkv6_scan.
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
// contiguous, rows 16-byte aligned); w, u and s0 are f32.  The output is
// in r's dtype, the final state f32.  The clamps are the reference's, so
// is its behaviour under strong decays (a cumulative decay below 1e-30
// breaks the ratio form).
//
// Design.  Only the last line carries anything from one chunk to the next,
// and it is elementwise in S, row by row (one channel of k per row);
// everything else of a chunk needs only the state entering it.  So every
// chunk gets a block of its own, and the state alone is passed from block
// to block.  One 256-thread block per (chunk, head, batch), 8192 at
// rwkv6-1.6b's call.  A block
// - brings its r, k, v and w tiles at once by cp.async, 16 bytes a thread
//   (rows at or past t zero-filled, w read as 1 there: the reference's
//   padding, with no copies).  bf16 tiles land packed and are widened to
//   f32 in shared memory once, since several threads read each value;
// - takes the cumulative log-decay with every thread: four threads per
//   channel, each down 16 consecutive rows, then a shuffle scan of their
//   sums; the same threads keep log w and cum in registers and turn
//   r into r a_pre, w into k / max(a_pre w, 1e-30) and k into
//   k exp(total - cum) in place, while four threads per row first sum
//   the bonus diagonal sum_d r u k;
// - forms the strictly lower triangle of the scores (the 16 x 16 blocks
//   above the diagonal are not computed), its chunk's term of the state,
//   dS = (k exp(total - cum))^T v, and o_intra = scores v (only the
//   blocks at or below the diagonal are read), all before it needs the
//   state;
// - waits for the state entering its chunk, which the block of the chunk
//   before publishes in a two-slot ring per (batch, head) ((b, h, 2, d, d)
//   f32, 4.2 MB at rwkv6-1.6b's call, so it stays in L2), publishes
//   exp(total) S_in + dS for the next chunk (or writes the final state),
//   and only then
// - computes o = (r a_pre) S_in + o_intra + diag v, the three terms summed
//   apart and added in the reference's order, straight into (b, t, h, d).
// Blocks take their chunk from an atomic ticket, chunk by chunk across
// every (batch, head), so the block a block waits on started before it:
// the wait cannot deadlock, and a wait that outlasts kSpinLimit naps turns
// the state to NaN instead of hanging the card.  The C entry point zeroes
// the tickets and flags (a memset on the caller's stream) before each
// launch.
// Every product gives each thread a 4 x 4 register tile fed by float4
// reads; rows are padded by 4 floats so that float4 reads of consecutive
// rows fall in distinct banks.  Shared memory is four f32 tiles, reused as
// the work goes on (~69 KB at c = d = 64): three blocks an SM.  The order
// of the products keeps the registers within 80 a thread at that tile.
// No atomics in any sum and a fixed order of every sum: reruns are
// bitwise equal.  Built without fast math and without -ftz:
// fmaxf(w, 1e-38f) keeps its subnormal constant, and logf, expf and the
// division are the accurate ones.
//
// Bound on the card, and why this design: at rwkv6-1.6b's prefill call
// (b, h, t, d) = (4, 32, 4096, 64), chunk 64, the four products are
// ~1.28e10 flops (the strictly lower triangle of the scores counted) over
// ~0.41 GB, so the function is bound by f32 operations: 0.191 ms at 67
// TFLOP/s outside the tensor cores (the bytes take 0.12 ms at 3.35 TB/s).
// The yardstick is f32 because the reference computes the ratio form in
// f32: it multiplies terms scaled by 1/cumulative-decay, which a bf16 or
// TF32 product would round outside the tolerance.  A design that keeps the
// state on chip instead, one block per (batch, head) walking the 64 chunks
// in order, has 128 blocks for 132 SMs, each chunk a chain of dependent
// steps: 13.6x the bound.  Here every chunk is parallel and the state stays
// in L2; the chain of 64 hand-overs runs beside the parallel work (with the
// wait removed the kernel is no faster), and so do the exp, log and
// division of the elementwise pass (with them replaced by plain arithmetic,
// no faster either).  What it misses the bound by: the products take about
// twice their f32 FMA time (each 4 x 4 tile reads shared memory as often as
// it issues FMAs, and the diagonal blocks of the scores are computed
// whole), and a block's loads, widening, scan and hand-over, about as long
// again, overlap the products of the other two blocks on its SM only in
// part.
// PERF.md has the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // threads of a block
constexpr int kPad = 4;        // floats of padding per shared row
// Naps of a block waiting for the state entering its chunk: a flag that
// never came would turn the state to NaN after ~0.3 s, not hang the card.
constexpr int kSpinLimit = 1 << 22;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  void* o;
  float* s_out;
  float* st;   // (b, h, 2, d, d): the state entering chunk c in slot c % 2
               // of a ring per (batch, head)
  int* sync;   // [0]: tickets; [1 + (b h + h) nc + c]: the state entering
               // chunk c is in the ring
  int64_t r_b, r_h, r_t, k_b, k_h, k_t, v_b, v_h, v_t, w_b, w_h, w_t, o_b,
      o_h, o_t;
  int b, h, t, nc;
};

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* o) {
  o[0] = __uint_as_float(w << 16);  // bf16 -> f32 is exact
  o[1] = __uint_as_float(w & 0xffff0000u);
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

// 16 bytes from global to shared memory, asynchronously; zeros instead
// when !in (src is then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
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

template <int C, int D>
struct Tile {
  static_assert(C % 16 == 0 && C <= 64 && D % 8 == 0 && D <= 64,
                "chunk in {16, 32, 64}, head dim in {8, 16, 32, 64}");
  static constexpr int LD = D + kPad;  // row stride of the (c x d) tiles and S
  static constexpr int LP = C + kPad;  // row stride of the scores
  static constexpr int RS = C / 4;     // rows (and score columns) of a block
                                       // of the 4 x 4 thread tiles
  static constexpr int DG = D / 4;     // groups of 4 columns across d
  // The scan: TPC threads per channel (lanes of one warp), R consecutive
  // rows each.
  static constexpr int TPC0 = kThreads / D < 32 ? kThreads / D : 32;
  static constexpr int TPC = TPC0 < C ? TPC0 : C;
  static constexpr int R = C / TPC;
  static_assert((D * TPC) % 32 == 0, "the scan's warps are whole");
  // Blocks an SM the registers must allow: three (80 registers a thread)
  // for the model's tile, which fits them without spilling; two (128)
  // for the others, some of which would spill at 80.
  static constexpr int MIN_BLOCKS = C == 64 && D == 64 ? 3 : 2;
  // shared floats: r a_pre [C][LD]; w, then k / max(a_pre w, 1e-30), then
  // the scores [C][LP]; k, then k exp(total - cum), then S_in [D][LD];
  // v [C][LD]; diag [C]; exp(total) [D]; u [D]
  static constexpr int A_F = C * LD;
  static constexpr int B_F = C * (LD > LP ? LD : LP);
  static constexpr int K_F = (C > D ? C : D) * LD;
  static constexpr int V_F = C * LD;
  static constexpr size_t bytes =
      (A_F + B_F + K_F + V_F + C + 2 * D) * sizeof(float);
};

// Issues the copies of rows [0, C) of D values of T (row i at src + i *
// stride) into the tile at dst: f32 rows at a stride of LD floats, bf16
// rows packed at the tile's byte offset C D 2 (widened later).  Rows at or
// past `valid` are zeros.
template <typename T, int C, int D, int LD>
__device__ __forceinline__ void copy_tile(float* dst, const T* src,
                                          int64_t stride, int valid) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int KC = 16 / static_cast<int>(sizeof(T)), NCH = D / KC;
  T* base = f32 ? reinterpret_cast<T*>(dst)
                : reinterpret_cast<T*>(reinterpret_cast<char*>(dst) +
                                       C * D * 2);
  for (int e = threadIdx.x; e < C * NCH; e += kThreads) {
    const int i = e / NCH, ch = e - i * NCH;
    const bool in = i < valid;
    cp16(base + (f32 ? i * LD + ch * KC : e * KC),
         src + (in ? i : 0) * stride + ch * KC, in);
  }
}

// One tile that landed as bf16 (widen3's reads and writes of it).
template <int C, int D, int LD>
struct Packed {
  static constexpr int PER_ROW = D / 8;
  static constexpr int NCH = C * PER_ROW, IT = (NCH + kThreads - 1) / kThreads;
  uint4 v[IT];
  __device__ __forceinline__ void read(const float* tile) {
    const uint4* raw = reinterpret_cast<const uint4*>(
        reinterpret_cast<const char*>(tile) + C * D * 2);
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (e < NCH) v[it] = raw[e];
    }
  }
  __device__ __forceinline__ void write(float* tile) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (e < NCH) {
        const int i = e / PER_ROW, col = 8 * (e - i * PER_ROW);
        float f[8];
        unpack_bf16x2(v[it].x, f);
        unpack_bf16x2(v[it].y, f + 2);
        unpack_bf16x2(v[it].z, f + 4);
        unpack_bf16x2(v[it].w, f + 6);
        float4* out = reinterpret_cast<float4*>(tile + i * LD + col);
        out[0] = make_float4(f[0], f[1], f[2], f[3]);
        out[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }
};

// The three tiles that landed as bf16 become f32 in place: every thread
// reads its chunks, the block synchronises, then every thread writes them
// widened.  Call and return with the block synchronised.
template <int C, int D, int LD>
__device__ __forceinline__ void widen3(float* f1, float* f2, float* f3) {
  Packed<C, D, LD> t1, t2, t3;
  t1.read(f1);
  t2.read(f2);
  t3.read(f3);
  __syncthreads();
  t1.write(f1);
  t2.write(f2);
  t3.write(f3);
  __syncthreads();
}

template <typename T, int C, int D>
__global__ void __launch_bounds__(kThreads, Tile<C, D>::MIN_BLOCKS)
    rwkv6_scan(Params p) {
  using L = Tile<C, D>;
  constexpr int LD = L::LD, LP = L::LP, RS = L::RS, DG = L::DG,
                TPC = L::TPC, R = L::R;
  extern __shared__ float4 smem4[];
  __shared__ int ticket, late;
  float* as = reinterpret_cast<float*>(smem4);  // r, then r a_pre
  float* bs = as + L::A_F;   // w, then k / max(a_pre w, 1e-30), then scores
  float* ks = bs + L::B_F;   // k, then k exp(total - cum), then S_in
  float* vs = ks + L::K_F;   // v
  float* diag = vs + L::V_F;  // sum_d r u k per row
  float* dec = diag + C;      // exp(total) per channel
  float* us = dec + D;        // u

  // Blocks take their chunk in the order they start, chunk by chunk across
  // every (batch, head): the block of chunk c - 1 of a (batch, head) holds
  // an earlier ticket, so it started before this one, and waiting on it
  // cannot deadlock.
  const int tid = threadIdx.x;
  if (tid == 0) ticket = atomicAdd(p.sync, 1);
  __syncthreads();
  const int rows = p.b * p.h;
  const int ci = ticket / rows, bh = ticket - ci * rows;
  const int bb = bh / p.h, hh = bh - bb * p.h, c0 = ci * C;
  const int valid = p.t - c0;  // rows of the chunk before t (may exceed C)
  const int64_t bhc = static_cast<int64_t>(bh) * p.nc + ci;

  // 1. The chunk's tiles.
  copy_tile<T, C, D, LD>(as,
                         static_cast<const T*>(p.r) + bb * p.r_b +
                             hh * p.r_h + c0 * p.r_t,
                         p.r_t, valid);
  copy_tile<T, C, D, LD>(ks,
                         static_cast<const T*>(p.k) + bb * p.k_b +
                             hh * p.k_h + c0 * p.k_t,
                         p.k_t, valid);
  copy_tile<T, C, D, LD>(vs,
                         static_cast<const T*>(p.v) + bb * p.v_b +
                             hh * p.v_h + c0 * p.v_t,
                         p.v_t, valid);
  copy_tile<float, C, D, LD>(bs, p.w + bb * p.w_b + hh * p.w_h + c0 * p.w_t,
                             p.w_t, valid);
  if (tid < D) us[tid] = p.u[hh * D + tid];
  cp_wait_block();
  if constexpr (!std::is_same<T, float>::value) widen3<C, D, LD>(as, ks, vs);

  // 2. The cumulative log-decay: thread (channel ch, segment sg) owns rows
  //    [sg R, sg R + R) of its channel and keeps log w and cum of them;
  //    a shuffle scan over the TPC segments adds what comes before.  Four
  //    threads per row sum the bonus diagonal meanwhile.
  const int ch = tid / TPC, sg = tid - ch * TPC;
  const bool scans = tid < D * TPC;
  float lw[R], cm[R];
  float total = 0.f;
  if (scans) {
    float run = 0.f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = sg * R + q;
      lw[q] = logf(fmaxf(i < valid ? bs[i * LD + ch] : 1.f, 1e-38f));
      run += lw[q];
      cm[q] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < TPC; off <<= 1) {
      const float x = __shfl_up_sync(0xffffffffu, incl, off, TPC);
      if (sg >= off) incl += x;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1, TPC);
    if (sg == 0) excl = 0.f;
#pragma unroll
    for (int q = 0; q < R; ++q) cm[q] = excl + cm[q];
    total = __shfl_sync(0xffffffffu, cm[R - 1], TPC - 1, TPC);
    if (sg == 0) dec[ch] = expf(total);
  }
  if (tid < 4 * C) {
    const int i = tid >> 2, part = tid & 3;
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < D / 4; ++m) {
      const int d = part * (D / 4) + m;
      acc = fmaf(as[i * LD + d] * us[d], ks[i * LD + d], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) diag[i] = acc;
  }
  __syncthreads();

  // 3. Elementwise, in place: r a_pre, k / max(a_pre w, 1e-30) and
  //    k exp(total - cum).
  if (scans) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = sg * R + q, idx = i * LD + ch;
      const float w = i < valid ? bs[idx] : 1.f;
      const float a_pre = expf(cm[q] - lw[q]);
      const float kk = ks[idx];
      as[idx] = as[idx] * a_pre;
      bs[idx] = kk / fmaxf(a_pre * w, 1e-30f);
      ks[idx] = kk * expf(total - cm[q]);
    }
  }
  __syncthreads();

  // 4. The scores (r a_pre)(k / (a_pre w))^T on rows py + RS a and columns
  //    px + RS b: the blocks with b > a lie above the diagonal and are
  //    neither computed nor read.  They replace k / (a_pre w).
  const int px = tid % RS, py = tid / RS;
  const bool owns_p = tid < RS * RS;
  {
    float sco[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sco[a][b] = 0.f;
    if (owns_p) {
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 ra[4], kb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          ra[a] =
              *reinterpret_cast<const float4*>(as + (py + RS * a) * LD + d);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          kb[b] =
              *reinterpret_cast<const float4*>(bs + (px + RS * b) * LD + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b <= a; ++b) {
            float x = sco[a][b];
            x = fmaf(ra[a].x, kb[b].x, x);
            x = fmaf(ra[a].y, kb[b].y, x);
            x = fmaf(ra[a].z, kb[b].z, x);
            x = fmaf(ra[a].w, kb[b].w, x);
            sco[a][b] = x;
          }
      }
    }
    __syncthreads();  // k / (a_pre w) is read
    if (owns_p) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b <= a; ++b) {
          const int i = py + RS * a, j = px + RS * b;
          bs[i * LP + j] = j < i ? sco[a][b] : 0.f;
        }
    }
    __syncthreads();
  }

  // 5. o_intra = scores v on rows oy + RS a and columns 4 ox + e, over the
  //    column blocks at or below each row's diagonal block ...
  const int ox = tid % DG, oy = tid / DG;
  const bool owns_o = tid < RS * DG;
  float intra[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) intra[a][e] = 0.f;
  if (owns_o) {
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
#pragma unroll 2
      for (int j = jb * RS; j < (jb + 1) * RS; j += 4) {
        float4 pa[4];
#pragma unroll
        for (int a = jb; a < 4; ++a)
          pa[a] = *reinterpret_cast<const float4*>(bs + (oy + RS * a) * LP + j);
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (j + f) * LD + 4 * ox);
#pragma unroll
          for (int a = jb; a < 4; ++a) {
            const float x = lane_of(pa[a], f);
            intra[a][0] = fmaf(x, vv.x, intra[a][0]);
            intra[a][1] = fmaf(x, vv.y, intra[a][1]);
            intra[a][2] = fmaf(x, vv.z, intra[a][2]);
            intra[a][3] = fmaf(x, vv.w, intra[a][3]);
          }
        }
      }
    }
  }
  //    ... and this chunk's term of the state, dS[dk][dv] = sum_i kd[i][dk]
  //    v[i][dv], on rows 4 sr + a and columns 4 sc + e.
  const int sc = tid % DG, sr = tid / DG;
  const bool owns_s = tid < DG * DG;
  float ds[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[a][e] = 0.f;
  if (owns_s) {
#pragma unroll 4
    for (int i = 0; i < C; ++i) {
      const float4 kd = *reinterpret_cast<const float4*>(ks + i * LD + 4 * sr);
      const float4 vv = *reinterpret_cast<const float4*>(vs + i * LD + 4 * sc);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[a][e] = fmaf(lane_of(kd, a), lane_of(vv, e), ds[a][e]);
    }
  }

  // 6. The state entering this chunk: s0 for the first, else what the block
  //    of chunk c - 1 published in slot c % 2 of this (batch, head)'s ring
  //    (read past L1).  A wait past kSpinLimit naps turns it to NaN.
  float* ring = p.st + static_cast<int64_t>(bh) * 2 * D * D;
  if (tid == 0) {
    int naps = 0;
    if (ci > 0) {
      const int* flag = p.sync + 1 + bhc;
      while (load_acquire(flag) == 0 && ++naps < kSpinLimit) __nanosleep(64);
    }
    late = naps >= kSpinLimit;
  }
  __syncthreads();  // the scores and k decayed are read
  // o_intra waits in the scores' space, S_in takes k decayed's.
  if (owns_o) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(bs + (oy + RS * a) * LD + 4 * ox) =
          make_float4(intra[a][0], intra[a][1], intra[a][2], intra[a][3]);
  }
  float sin[4][4];
  if (owns_s) {
    const float* src = ci == 0 ? p.s0 + static_cast<int64_t>(bh) * D * D
                               : ring + (ci & 1) * D * D;
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 x = __ldcg(
          reinterpret_cast<const float4*>(src + (4 * sr + a) * D + 4 * sc));
      sin[a][0] = late ? nan : x.x;
      sin[a][1] = late ? nan : x.y;
      sin[a][2] = late ? nan : x.z;
      sin[a][3] = late ? nan : x.w;
    }
  }

  // S_in to shared memory for o; exp(total) S_in + dS to slot (c + 1) % 2
  // and a flag for the next chunk's block, or, after the last chunk, the
  // final state.
  const bool last = ci + 1 == p.nc;
  if (owns_s) {
    float* next = ring + ((ci + 1) & 1) * D * D;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int dk = 4 * sr + a;
      *reinterpret_cast<float4*>(ks + dk * LD + 4 * sc) =
          make_float4(sin[a][0], sin[a][1], sin[a][2], sin[a][3]);
      const float decay = dec[dk];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[a][e] = decay * sin[a][e] + ds[a][e];
      const float4 out = make_float4(ds[a][0], ds[a][1], ds[a][2], ds[a][3]);
      if (last)
        *reinterpret_cast<float4*>(
            p.s_out + (static_cast<int64_t>(bh) * D + dk) * D + 4 * sc) = out;
      else
        *reinterpret_cast<float4*>(next + dk * D + 4 * sc) = out;
    }
  }
  if (!last) __threadfence();
  __syncthreads();
  if (!last && tid == 0) store_release(p.sync + 2 + bhc, 1);

  // 7. o = (r a_pre) S_in + o_intra + diag v on the rows before t.
  if (owns_o) {
    float inter[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) inter[a][e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 ra[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        ra[a] = *reinterpret_cast<const float4*>(as + (oy + RS * a) * LD + d);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float4 sv =
            *reinterpret_cast<const float4*>(ks + (d + f) * LD + 4 * ox);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float x = lane_of(ra[a], f);
          inter[a][0] = fmaf(x, sv.x, inter[a][0]);
          inter[a][1] = fmaf(x, sv.y, inter[a][1]);
          inter[a][2] = fmaf(x, sv.z, inter[a][2]);
          inter[a][3] = fmaf(x, sv.w, inter[a][3]);
        }
      }
    }
    T* og = static_cast<T*>(p.o) + bb * p.o_b + hh * p.o_h + 4 * ox;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = oy + RS * a;
      if (i >= valid) continue;
      const float4 vv = *reinterpret_cast<const float4*>(vs + i * LD + 4 * ox);
      const float4 in = *reinterpret_cast<const float4*>(bs + i * LD + 4 * ox);
      const float dg = diag[i];
      const float out[4] = {inter[a][0] + in.x + dg * vv.x,
                            inter[a][1] + in.y + dg * vv.y,
                            inter[a][2] + in.z + dg * vv.z,
                            inter[a][3] + in.w + dg * vv.w};
      store4<T>(og + (c0 + i) * p.o_t, out);
    }
  }
}

template <typename T, int C, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = Tile<C, D>::bytes;
  static bool configured = false;  // per instantiation, on first launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan<T, C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const size_t sync_bytes =
      (1 + static_cast<size_t>(p.b) * p.h * p.nc) * sizeof(int);
  const cudaError_t err = cudaMemsetAsync(p.sync, 0, sync_bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_scan<T, C, D><<<p.nc * p.h * p.b, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C>
int launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, C, 8>(p, stream);
    case 16: return launch<T, C, 16>(p, stream);
    case 32: return launch<T, C, 32>(p, stream);
    case 64: return launch<T, C, 64>(p, stream);
    default: return -1;
  }
}

template <typename T>
int launch_cd(const Params& p, int chunk, int d, cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch_d<T, 16>(p, d, stream);
    case 32: return launch_d<T, 32>(p, d, stream);
    case 64: return launch_d<T, 64>(p, d, stream);
    default: return -1;
  }
}

}  // namespace

// strides: 15 element strides, (batch, head, time) of r, k, v, w and o; the
// head dim is contiguous in all five, and r, k, v and w rows are 16-byte
// aligned.  u is (h, d) and s0, s_out are (b, h, d, d), contiguous.
// Scratch, nc = ceil(t / chunk): st f32 (b, h, 2, d, d), sync int32
// (1 + b h nc), zeroed here on the stream before the launch.  dtype (of r,
// k, v and o) 0 = f32, 1 = bf16.  Returns the cudaError_t of the memset or
// the launch that failed (0 when both were taken), or -1 for an
// unsupported chunk, head dim or dtype.
extern "C" int repro_rwkv6(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* s_out, void* st, void* sync,
                           const int64_t* strides, int b, int h, int t, int d,
                           int chunk, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || chunk <= 0) return -1;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.o = o;
  p.s_out = static_cast<float*>(s_out);
  p.st = static_cast<float*>(st);
  p.sync = static_cast<int*>(sync);
  p.r_b = strides[0]; p.r_h = strides[1]; p.r_t = strides[2];
  p.k_b = strides[3]; p.k_h = strides[4]; p.k_t = strides[5];
  p.v_b = strides[6]; p.v_h = strides[7]; p.v_t = strides[8];
  p.w_b = strides[9]; p.w_h = strides[10]; p.w_t = strides[11];
  p.o_b = strides[12]; p.o_h = strides[13]; p.o_t = strides[14];
  p.b = b;
  p.h = h;
  p.t = t;
  p.nc = (t + chunk - 1) / chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_cd<float>(p, chunk, d, s);
  if (dtype == 1) return launch_cd<__nv_bfloat16>(p, chunk, d, s);
  return -1;
}
