// Causal / sliding-window flash attention with GQA (Hopper, sm_90a), the
// f32 route: f32 CUDA-core arithmetic for f32 q, k, v.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// _flash_kernel (reached through flash_attention_bhsd) on f32 inputs:
// blockwise online-softmax attention of q (b, h, sq, hd) against k/v
// (b, kvh, skv, hd), kv_head = h / (h / kvh), all in f32.  bf16 inputs go
// to the tensor-core kernel of flash_attention_tc.cu.
//
// Design
// * One thread block per (q tile of 64 rows, head, batch); 256 threads as
//   16 x 16.  Thread (ty, tx) owns query rows ty + 16 i (i < 4), score
//   columns tx + 16 j (j < 4) of each kv tile, and output columns
//   tx * VEC + 16 * VEC * n (+ e < VEC) of the head dim, VEC being the
//   largest of 4, 2 and 1 that divides hd / 16 (scalar for hd 80).  m, l
//   and the accumulator of its rows stay in registers through the kv loop.
// * The block walks kv tiles of 64 rows.  Q is staged once in shared
//   memory; each K tile, then each V tile, is staged in one shared
//   buffer; the tile's probabilities go through shared memory from the
//   S = Q K^T layout to the P V layout.
//   Row maxima and sums are reduced across the 16 threads of a row with
//   warp shuffles.  Rows are padded by 4 floats so that the float4 reads
//   of 8 consecutive rows hit 32 distinct banks.
// * Block skips with the predicates of the TPU kernel: a kv tile wholly
//   above the causal diagonal of the q tile, or wholly outside the window,
//   is not visited.  Skipping is exact: such a tile would add p = 0 to
//   every row and scale by alpha = 1.  q tiles run heaviest first.
// * Ragged tails by bounds checks, no copies: q rows at or past sq are
//   read as zero and never written; kv rows at or past skv are read as
//   zero, and key positions at or past skv_pad (the reference's kv length
//   padded to its block_kv) are masked.  So the result equals the
//   reference's zero-padded one, whatever the block sizes the caller gave.
// * Masked scores are -1e30 and masked probabilities 0, as in the
//   reference; the output is acc / max(l, 1e-30).
// * No atomics and a fixed order of every sum: reruns are bitwise equal.
//
// Bound on the card: at (4, 16, 4096, 128) causal the work is ~2.7e11
// flops over ~0.5 GB of f32, so the kernel is bound by operations.  It
// does them as f32 FMAs on the CUDA cores (peak 67 TFLOP/s): on the
// tensor cores f32 inputs would need TF32, outside the f32 tolerance held
// against the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRowPad = 4;     // floats of padding per Q/K/V row in shared memory
constexpr int kLdP = kBKV + 16;  // row stride of the P tile: scalar stores
                                 // of two rows land in disjoint banks
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int groups, sq, skv, skv_pad, causal, window;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows [r0, r0 + 64) of one head of x into dst (64 x (HD + pad));
// rows at or past n read as zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* x,
                                          int64_t s_stride, int r0, int n) {
  constexpr int LD = HD + kRowPad;
#pragma unroll 4
  for (int e = threadIdx.x; e < kBKV * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    const int row = r0 + r;
    dst[r * LD + c] =
        row < n ? x[static_cast<int64_t>(row) * s_stride + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(Params p) {
  constexpr int LD = HD + kRowPad;
  constexpr int CW = HD / 16;            // output columns per thread
  // Floats per vector load: the largest of 4, 2 and 1 that divides CW
  // (hd 80 gives CW = 5 and scalar loads).
  constexpr int VEC = CW % 4 == 0 ? 4 : CW % 2 == 0 ? 2 : 1;
  constexpr int NV = CW / VEC;           // vectors per thread and row
  static_assert(kBQ == kBKV, "load_tile stages 64-row tiles");
  static_assert(HD % 16 == 0 && CW % VEC == 0,
                "head dim a multiple of 16, its columns whole vectors");

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][LD]
  float* kvs = qs + kBQ * LD;                   // [kBKV][LD]
  float* ps = kvs + kBKV * LD;                  // [kBQ][kLdP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kh = hh / p.groups;
  const int q0 = qi * kBQ;

  const float* qg = static_cast<const float*>(p.q) + bb * p.q_b + hh * p.q_h;
  const float* kg = static_cast<const float*>(p.k) + bb * p.k_b + kh * p.k_h;
  const float* vg = static_cast<const float*>(p.v) + bb * p.v_b + kh * p.v_h;
  float* og = static_cast<float*>(p.o) + bb * p.o_b + hh * p.o_h;

  load_tile<HD>(qs, qg, p.q_s, q0, p.sq);

  float acc[4][CW];
  float m_row[4], l_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_row[i] = kNegInf;
    l_row[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (p.skv_pad + kBKV - 1) / kBKV;
  if (p.causal) {
    // Tiles whose oldest key is past the newest query of the block are
    // wholly above the diagonal.
    const int last = (q0 + kBQ - 1) / kBKV + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBKV;
    // Wholly outside the window: even the closest pair (oldest q, newest
    // k) is window or more apart.  Uniform across the block.
    if (p.window > 0 && q0 - (k0 + kBKV - 1) >= p.window) continue;

    __syncthreads();  // Q staged; the previous tile's V and P reads done
    load_tile<HD>(kvs, kg, p.k_s, k0, p.skv);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&kvs[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // Mask, then the online-softmax update of each row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = kpos < p.skv_pad;
        if (p.causal) keep = keep && kpos <= qpos;
        if (p.window > 0) keep = keep && (qpos - kpos) < p.window;
        ok[j] = keep;
        s[i][j] = keep ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_row[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pr;
        ps[r * kLdP + tx + 16 * j] = pr;
      }
      const float alpha = expf(m_row[i] - m_new);
      l_row[i] = alpha * l_row[i] + row_sum16(sum);
      m_row[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // K reads done and P written
    load_tile<HD>(kvs, vg, p.v_s, k0, p.skv);
    __syncthreads();

    // acc += P V.
#pragma unroll 2
    for (int j = 0; j < kBKV; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * kLdP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = &kvs[(j + jj) * LD];
        float vv[CW];
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int col = tx * VEC + 16 * VEC * n;
          if constexpr (VEC == 4) {
            const float4 x = *reinterpret_cast<const float4*>(&vrow[col]);
            vv[4 * n] = x.x;
            vv[4 * n + 1] = x.y;
            vv[4 * n + 2] = x.z;
            vv[4 * n + 3] = x.w;
          } else if constexpr (VEC == 2) {
            const float2 x = *reinterpret_cast<const float2*>(&vrow[col]);
            vv[2 * n] = x.x;
            vv[2 * n + 1] = x.y;
          } else {
            vv[n] = vrow[col];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pr = jj == 0 ? pv[i].x
                         : jj == 1 ? pv[i].y
                         : jj == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(pr, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.sq) continue;
    const float l = fmaxf(l_row[i], 1e-30f);
    float* orow = og + static_cast<int64_t>(row) * p.o_s;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[tx * VEC + 16 * VEC * n + e] = acc[i][VEC * n + e] / l;
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + kBKV) * (HD + kRowPad) + kBQ * kLdP);
}

template <int HD>
int launch(const Params& p, int b, int h, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  static bool configured = false;  // per instantiation, on first launch
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, h, b);
  flash_fwd<HD><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and o; the
// head dim is contiguous in all four; all four are f32.  Returns a
// cudaError_t of the launch (0 on success), or -1 for an unsupported head
// dim.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int64_t* strides, int b, int h, int kvh, int sq, int skv,
    int skv_pad, int hd, float scale, int causal, int window,
    void* stream) {
  if (b <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0 || sq <= 0) return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_b = strides[0]; p.q_h = strides[1]; p.q_s = strides[2];
  p.k_b = strides[3]; p.k_h = strides[4]; p.k_s = strides[5];
  p.v_b = strides[6]; p.v_h = strides[7]; p.v_s = strides[8];
  p.o_b = strides[9]; p.o_h = strides[10]; p.o_s = strides[11];
  p.groups = h / kvh;
  p.sq = sq;
  p.skv = skv;
  p.skv_pad = skv_pad;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(p, b, h, s);
    case 64: return launch<64>(p, b, h, s);
    case 80: return launch<80>(p, b, h, s);
    case 128: return launch<128>(p, b, h, s);
    default: return -1;
  }
}
