// Causal / sliding-window flash attention with GQA on Hopper's tensor
// cores (sm_90a), for bf16 q, k, v.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// _flash_kernel (reached through flash_attention_bhsd) on its bf16 route:
// blockwise online-softmax attention of q (b, h, sq, hd) against k/v
// (b, kvh, skv, hd), kv_head = h / (h / kvh).  Scores, the running max m,
// the running sum l and the accumulator are f32; the output is rounded to
// bf16 once.  f32 inputs keep the CUDA-core kernel of flash_attention.cu.
//
// Bound on the card: at olmo-1b's prefill call (4, 16, 4096, 128) causal
// the function does ~2.75e11 flops on ~0.27 GB, 0.28 ms at the bf16
// tensor-core peak against 0.08 ms for the bytes, so it is bound by
// operations, and only wgmma reaches that peak.
//
// Design
// * One block of two consumer warpgroups (256 threads) per (128-row q tile,
//   head, batch); each warpgroup owns 64 query rows.  The grid is (h, b,
//   q tiles) with the q tile slowest, heaviest causal tiles first.
// * Both products on wgmma, m64nNk16, bf16 in, f32 accumulate:
//   S = Q K^T with Q and K from shared memory (both K-major, N = 128 kv
//   rows per tile); O += P V with P from registers and V from shared
//   memory, MN-major (the transpose bit).  The S accumulator's fragment of
//   each k16 slice is the register layout of wgmma's A operand once pairs
//   are packed to bf16x2, so P never goes through shared memory.
// * TMA brings the tiles: Q once per block, K and V through a ring of two
//   stages, each with a "full" mbarrier (TMA bytes) and an "empty" one
//   (one arrival per consumer warp).  Thread 0 issues tile j + 1 at the
//   start of tile j, so the copy runs under tile j's products.  K's stage
//   is released right after S, V's after P V.
// * Tensor maps are 4-D, the head dim innermost and the three outer dims
//   (seq, head, batch) in the order of their strides, so that the model's
//   (b, s, h, hd) storage read as (b, h, s, hd) views and contiguous
//   (b, h, s, hd) tensors are both taken without copies; a box is one
//   column block of 128 rows of one head.  They are encoded on the host
//   for each call (microseconds) with cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint, so the library does not link libcuda.
// * Head dims 32, 64, 80, 128 on one code path: each tile is staged as
//   column blocks as wide as the widest swizzle atom that divides hd
//   (64 columns and 128 B swizzle at hd 64 and 128, 32 and 64 B at hd 32,
//   16 and 32 B at hd 80).  hd 80 is five 16-column blocks: five TMA boxes
//   and five descriptors per tile and no padded work (zamba2's 2560 / 32);
//   the cost is more, smaller TMA requests than a 128 B swizzle would make.
// * Online softmax on the accumulator registers, in the exp2 domain: with
//   c = scale * log2(e), p = exp2(s c - m c).  Row max and row sum reduce
//   over the four threads of a quad with shuffles; each thread keeps a
//   partial l, summed across the quad once at the end.
// * Masks only on the tiles that need one (the diagonal, the window's
//   edge, keys at or past skv_pad): masked scores are -1e30 and their
//   probabilities exactly 0 (a row with no key yet subtracts 0, not
//   -1e30); tiles wholly above the diagonal or outside the window are not
//   visited.  The output is acc / max(l, 1e-30).
// * Ragged tails by TMA's zero fill: q rows at or past sq and kv rows at or
//   past skv read as zero; rows at or past sq are never written.  The
//   output goes straight into (b, sq, h, hd) from the accumulators.
// * Numerics: products of bf16 are exact in f32; P is rounded to bf16
//   before P V (the one new rounding against the CUDA-core kernel), l sums
//   the f32 P.  No atomics and a fixed order of every sum: reruns are
//   bitwise equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;      // query rows per block
constexpr int kBN = 128;      // kv rows per tile
constexpr int kStages = 2;    // K and V ring depth
constexpr int kThreads = 256; // two consumer warpgroups
constexpr int kConsumerWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of a head dim: tiles are column blocks of AW bf16
// (a swizzle atom's width), each block rows x AW, rows AW * 2 bytes apart.
template <int HD>
struct Layout {
  static constexpr int AW = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int NCB = HD / AW;
  static constexpr int ROW_BYTES = AW * 2;
  static constexpr int BLOCK_BYTES = kBN * ROW_BYTES;  // one column block
  static constexpr int TILE_BYTES = NCB * BLOCK_BYTES;  // Q, K or V tile
  static constexpr uint64_t MODE = AW == 64 ? 1 : AW == 32 ? 2 : 3;
  static_assert(kBQ == kBN, "Q, K and V tiles share one box shape");
  static_assert(HD % 16 == 0 && TILE_BYTES % 1024 == 0,
                "tiles stay aligned to the 128 B swizzle repeat");
};

template <int HD>
constexpr size_t smem_bytes() {
  // Q, then the K ring, then the V ring, then the barriers; 1 KB of slack
  // to align the base to the swizzle repeat.
  return (1 + 2 * kStages) * Layout<HD>::TILE_BYTES + 128 + 1024;
}

// Position (1..3) of seq, head and batch among a tensor map's dims.
struct Roles {
  int s, h, b;
};

struct Params {
  __nv_bfloat16* o;
  int64_t o_b, o_h, o_s;  // element strides of the output (b, h, s) view
  Roles rq, rk, rv;
  int groups, sq, skv_pad, causal, window;  // window <= 0: none
  float scale_log2;                         // scale * log2(e)
};

__device__ __forceinline__ int pick(const Roles& r, int dim, int s, int h,
                                    int b) {
  return r.s == dim ? s : r.h == dim ? h : b;
}

// Load one 128-row tile (all column blocks) of one head into dst.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          const Roles& r, uint32_t bar,
                                          int row, int head, int batch) {
  using L = Layout<HD>;
  mbar_expect_tx(bar, L::TILE_BYTES);
#pragma unroll
  for (int cb = 0; cb < L::NCB; ++cb)
    tma_load_4d(dst + cb * L::BLOCK_BYTES, map, bar, cb * L::AW,
                pick(r, 1, row, head, batch), pick(r, 2, row, head, batch),
                pick(r, 3, row, head, batch));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + L::TILE_BYTES;
  const uint32_t v_s = k_s + kStages * L::TILE_BYTES;
  const uint32_t bars = v_s + kStages * L::TILE_BYTES;
  // full_q, full_k[2], full_v[2], empty_k[2], empty_v[2]: 8 bytes each.
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (3 + s); };
  auto empty_k = [&](int s) { return bars + 8 * (5 + s); };
  auto empty_v = [&](int s) { return bars + 8 * (7 + s); };

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int qi = gridDim.z - 1 - blockIdx.z;  // heaviest causal tiles first
  const int kh = hh / p.groups;
  const int q0 = qi * kBQ;

  // The kv tiles this block visits: none wholly above the diagonal of its
  // newest query, none wholly outside the window of its oldest.
  int t_end = (p.skv_pad + kBN - 1) / kBN;
  if (p.causal) t_end = min(t_end, (q0 + kBQ - 1) / kBN + 1);
  int t_begin = 0;
  if (p.window > 0) {
    const int oldest_key = q0 - p.window + 1;
    if (oldest_key > 0) t_begin = oldest_key / kBN;
  }

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    load_tile<HD>(q_s, &tq, p.rq, full_q, q0, hh, bb);
    if (t_begin < t_end) {
      load_tile<HD>(k_s, &tk, p.rk, full_k(0), t_begin * kBN, kh, bb);
      load_tile<HD>(v_s, &tv, p.rv, full_v(0), t_begin * kBN, kh, bb);
    }
  }

  const int wg = threadIdx.x / 128;          // consumer warpgroup
  const int warp = (threadIdx.x % 128) / 32;  // warp within it
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int wq0 = q0 + 64 * wg;              // the warpgroup's first row
  const int r0 = wq0 + 16 * warp + lane / 4;  // this thread's two rows
  const int r1 = r0 + 8;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float s[kBN / 2];
  uint32_t pk[kBN / 16][4];

  mbar_wait(full_q, 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    const int st = i & 1;
    const uint32_t parity = (i >> 1) & 1;
    if (threadIdx.x == 0 && t + 1 < t_end) {
      // Tile t + 1 goes into the other stage once both warpgroups are done
      // with tile t - 1 there.
      const int i1 = i + 1, st1 = i1 & 1;
      if (i1 >= kStages) mbar_wait(empty_k(st1), ((i1 >> 1) - 1) & 1);
      load_tile<HD>(k_s + st1 * L::TILE_BYTES, &tk, p.rk, full_k(st1),
                    (t + 1) * kBN, kh, bb);
      if (i1 >= kStages) mbar_wait(empty_v(st1), ((i1 >> 1) - 1) & 1);
      load_tile<HD>(v_s + st1 * L::TILE_BYTES, &tv, p.rv, full_v(st1),
                    (t + 1) * kBN, kh, bb);
    }
    __syncwarp();

    // S = Q K^T over hd / 16 k16 steps.
    mbar_wait(full_k(st), parity);
    const uint32_t kt = k_s + st * L::TILE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int col = 16 * kk;
      const uint32_t off = (col / L::AW) * L::BLOCK_BYTES + (col % L::AW) * 2;
      const uint64_t da = make_desc(q_s + off + 64 * L::ROW_BYTES * wg, 16,
                                    8 * L::ROW_BYTES, L::MODE);
      const uint64_t db = make_desc(kt + off, 16, 8 * L::ROW_BYTES, L::MODE);
      wgmma_ss_n128(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    if (lane == 0) mbar_arrive(empty_k(st));

    // Masks: element 4j + e of s is row (e < 2 ? r0 : r1), key
    // k0 + 8j + 2 quad + (e & 1).
    const int k0 = t * kBN;
    const bool need_mask = k0 + kBN > p.skv_pad ||
                           (p.causal && k0 + kBN - 1 > wq0) ||
                           (p.window > 0 && wq0 + 63 - k0 >= p.window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * quad + (e & 1);
          const int row = e < 2 ? r0 : r1;
          bool keep = key < p.skv_pad;
          if (p.causal) keep = keep && key <= row;
          if (p.window > 0) keep = keep && row - key < p.window;
          if (!keep) s[4 * j + e] = kNegInf;
        }
    }

    // Online softmax of the two rows.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * p.scale_log2);
    const float alpha1 = exp2f((m1 - mn1) * p.scale_log2);
    m0 = mn0;
    m1 = mn1;
    // A row with no key yet subtracts 0, so its masked p stay exactly 0.
    const float ms0 = (mn0 == kNegInf ? 0.f : mn0) * p.scale_log2;
    const float ms1 = (mn1 == kNegInf ? 0.f : mn1) * p.scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[4 * j] = exp2f(fmaf(s[4 * j], p.scale_log2, -ms0));
      s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], p.scale_log2, -ms0));
      s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], p.scale_log2, -ms1));
      s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], p.scale_log2, -ms1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha0;
      o[4 * j + 1] *= alpha0;
      o[4 * j + 2] *= alpha1;
      o[4 * j + 3] *= alpha1;
    }
    // P as wgmma's A fragments, one per k16 step of P V.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pk[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V over kBN / 16 k16 steps.
    mbar_wait(full_v(st), parity);
    const uint32_t vt = v_s + st * L::TILE_BYTES;
    fence_regs(o);
    fence_regs(pk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t db = make_desc(vt + 16 * kk * L::ROW_BYTES, L::BLOCK_BYTES,
                                    8 * L::ROW_BYTES, L::MODE);
      wgmma_pv<HD>(o, pk[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty_v(st));
  }

  // acc / max(l, 1e-30), rounded to bf16 once, into (b, sq, h, hd).
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* og = p.o + bb * p.o_b + hh * p.o_h;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (r0 < p.sq)
      *reinterpret_cast<uint32_t*>(og + r0 * p.o_s + col) =
          pack_bf16(o[4 * j] / l0, o[4 * j + 1] / l0);
    if (r1 < p.sq)
      *reinterpret_cast<uint32_t*>(og + r1 * p.o_s + col) =
          pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
  }
}

// ---- host side -------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// layout: 9 values for one tensor, its outer dims in stride order: the
// axis of each (0 batch, 1 head, 2 seq), their sizes, their byte strides.
template <int HD>
int encode(CUtensorMap* map, const void* ptr, const int64_t* layout,
           Roles* roles) {
  using L = Layout<HD>;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -2;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(L::AW), 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[1 + i] = static_cast<cuuint64_t>(layout[3 + i]);
    strides[i] = static_cast<cuuint64_t>(layout[6 + i]);
    switch (layout[i]) {
      case 0: roles->b = 1 + i; break;
      case 1: roles->h = 1 + i; break;
      case 2: roles->s = 1 + i; box[1 + i] = kBN; break;
      default: return -1;
    }
  }
  const CUtensorMapSwizzle swizzle =
      L::AW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::AW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // CUresult codes are kept apart from cudaError_t ones by an offset.
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, Params& p,
           const int64_t* layouts, int b, int h, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  static bool configured = false;  // per instantiation, on first launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int err = encode<HD>(&tq, q, layouts, &p.rq);
  if (err == 0) err = encode<HD>(&tk, k, layouts + 9, &p.rk);
  if (err == 0) err = encode<HD>(&tv, v, layouts + 18, &p.rv);
  if (err != 0) return err;
  const dim3 grid(h, b, (p.sq + kBQ - 1) / kBQ);
  flash_tc<HD><<<grid, kThreads, bytes, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layouts: 27 values, 9 for each of q, k, v (see encode); o_strides: the
// output's (b, h, s) element strides, the head dim contiguous.  Returns a
// cudaError_t of the launch (0 on success), 10000 + a CUresult when a
// tensor map is refused, -1 for an unsupported argument, -2 when the
// driver has no cuTensorMapEncodeTiled.
extern "C" int repro_flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int64_t* layouts, const int64_t* o_strides, int b, int h, int kvh,
    int sq, int skv_pad, int hd, float scale, int causal, int window,
    void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 || sq <= 0 ||
      skv_pad <= 0)
    return -1;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_b = o_strides[0];
  p.o_h = o_strides[1];
  p.o_s = o_strides[2];
  p.groups = h / kvh;
  p.sq = sq;
  p.skv_pad = skv_pad;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, p, layouts, b, h, s);
    case 64: return launch<64>(q, k, v, p, layouts, b, h, s);
    case 80: return launch<80>(q, k, v, p, layouts, b, h, s);
    case 128: return launch<128>(q, k, v, p, layouts, b, h, s);
    default: return -1;
  }
}
