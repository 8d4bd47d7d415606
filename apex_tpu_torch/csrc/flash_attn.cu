// Flash attention on flat (B, S, NH * D) activations, forward (kernel B4)
// and backward (kernel B5), CUDA C++ for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/flash_attention.py::_fwd_single_kernel_bsh
// (wrapper _flash_fwd_call_bsh) and ::_bwd_fused_kernel_bsh (wrapper
// _flash_bwd_call_bsh), the Pallas TPU kernels behind
// flash_attention_bsh, BERT's attention at S >= flash_min_seq.
//
// Semantics (per batch row b and head h, head h owning columns
// [h * D, (h + 1) * D) of each token row):
//   s[q, k] = (q_q . k_k) * scale, or FILL = -30000 where key k is masked
//             (key_mask[b, k] != 0) or, when causal, k > q; a masked key
//             still counts in the softmax, so a fully masked row is the
//             uniform average over its S keys;
//   p = exp(s - max) / l, l = sum of exp(s - max), lse = max + log(l);
//   dropout: keep[q, k] = bits(seed, ((b * NH + h) * S + q) * S + k) <
//             threshold (csrc/philox.cuh), applied to p before the product
//             with V (scaled by 1 / (1 - rate)); l and lse stay pre-dropout;
//   out = (keep * p / (1 - rate)) V, rounded to the input type, and p is
//             rounded to the input type before that product, as the TPU
//             kernel casts p to V's type;
//   backward: dp = dO V^T (masked by keep and scaled), delta = rowsum(dO *
//             O) per head (computed by the caller), ds = p * (dp - delta) *
//             scale, dV = (keep * p / (1 - rate))^T dO, dQ = ds K, dK = ds^T
//             Q, with p and ds rounded to the input type before their
//             products.
// All arithmetic is fp32; inputs and outputs are fp32 or bf16.
//
// What bounds it on the H100: operations. At the BERT-large shape (B 16,
// S 512, NH 16, D 64) the forward does 17.2 GFLOP of products on 25 MB of
// inputs (bf16 tensor cores could do that in 17 us).
//
// Design. The TPU kernels hold one whole (S x S) score tile per head pair
// in VMEM and read two heads per 128-lane block; neither constraint exists
// here. Every kernel reads its rows of q, k, v straight out of the flat
// layout with a row stride of NH * D, so no transpose or head split is
// ever written, and works on 64 x 64 score tiles. The backward is two
// kernels, so that no sum needs atomics (deterministic): dK/dV with one
// block per 64-key tile looping over the query tiles, and dQ with one
// block per 64-query tile looping over the key tiles; each recomputes s
// and p from q, k and lse and replays the same mask.
//
// bf16 inputs (the training path) run on the tensor cores through WMMA
// bf16 fragments with fp32 accumulation. A block is four warps and each
// warp owns 16 rows of the block's tile: it computes its 16 x 64 scores
// (and dP) into its own fp32 shared-memory rows, applies the mask,
// softmax, dropout and rounding there with its 32 lanes, writes p (or
// ds) back as bf16 and multiplies that with the shared V / dO / Q / K
// tile, accumulating in fragments. Only the tile loads need the whole
// block. The forward makes two passes over the keys: the first finds each
// row's max and sum, the second forms p = exp(s - max) with the final max
// (so the output accumulator is never rescaled, as in the JAX kernel's
// single tile) and accumulates p V.
//
// fp32 inputs run the products as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), from shared memory: 256 threads, thread (ty, tx) computing rows
// 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of a score tile in
// registers from tiles padded to D + 1 floats a row; the forward keeps an
// online softmax (running max and sum per row, the output accumulator
// rescaled per key tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int TI = 4;        // score rows per thread
constexpr int TJ = 4;        // score columns per thread
constexpr int LP = BK + 1;   // padded row of a score tile
constexpr float FILL = -30000.f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* key_mask;  // (B, S), nonzero = masked; may be null
  const void* dout;         // (backward only)
  const float* lse;         // (B, NH, S)
  const float* delta;       // (B, NH, S) (backward only)
  void* out;                // forward: out; dK/dV kernels: dk; dQ: dq
  void* out2;               // dK/dV kernel: dv
  float* lse_out;           // forward only
  int B, S, NH;
  float scale;
  int causal;
  int dropout;
  unsigned int seed;
  unsigned int threshold;
  float inv_keep;
};

// Load rows [r0, r0 + 64) of head h of batch row b (zeros past S) into a
// (64 x (D + 1)) fp32 tile.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int b, int h, int r0, int S,
                                          int NH) {
  constexpr int LD = D + 1;
  const long long hs = static_cast<long long>(NH) * D;
  const float* base = src + static_cast<long long>(b) * S * hs +
                      static_cast<long long>(h) * D;
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * LD + c] =
        r0 + r < S ? base[static_cast<long long>(r0 + r) * hs + c]
                   : 0.f;
  }
}

// Per-key code of a key tile: 0 live, 1 masked (scores FILL), 2 past S
// (excluded from the softmax).
__device__ __forceinline__ void load_codes(int* codes, const Params& p,
                                           int b, int k0) {
  for (int j = threadIdx.x; j < BK; j += kThreads) {
    const int kk = k0 + j;
    codes[j] = kk >= p.S ? 2
               : (p.key_mask && p.key_mask[static_cast<long long>(b) * p.S +
                                           kk])
                   ? 1
                   : 0;
  }
}

// s (rows 4 ty + i, keys 4 tx + j) of the (64 x 64) tile: raw dot products.
template <int D>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bm,
                                          float acc[TI][TJ], int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[TI], bb[TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i) a[i] = A[(ty * TI + i) * LD + d];
#pragma unroll
    for (int j = 0; j < TJ; ++j) bb[j] = Bm[(tx * TJ + j) * LD + d];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// Masked, scaled score of (query qq, key kk) from its raw dot product.
__device__ __forceinline__ float masked_score(float dot, int code, int qq,
                                              int kk, const Params& p) {
  if (code == 2) return -INFINITY;
  if (code == 1 || (p.causal && kk > qq)) return FILL;
  return dot * p.scale;
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  int* codes = reinterpret_cast<int*>(Ps + BQ * LP);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int S = p.S, NH = p.NH;
  load_tile<D>(Qs, static_cast<const float*>(p.q), b, h, q0, S, NH);
  float m[TI], l[TI], o[TI][DJ];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) o[i][jj] = 0.f;
  }
  PhiloxCursor rng(p.seed);
  const unsigned long long head_base =
      static_cast<unsigned long long>(b * NH + h) * S;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's K, V, P are consumed
    load_tile<D>(Ks, static_cast<const float*>(p.k), b, h, k0, S, NH);
    load_tile<D>(Vs, static_cast<const float*>(p.v), b, h, k0, S, NH);
    load_codes(codes, p, b, k0);
    __syncthreads();
    float s[TI][TJ];
    tile_dots<D>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int qq = q0 + ty * TI + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int kj = tx * TJ + j;
        s[i][j] = masked_score(s[i][j], codes[kj], qq, k0 + kj, p);
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        float pav = e;
        if (p.dropout) {
          const int kk = k0 + tx * TJ + j;
          const bool keep =
              qq < S && kk < S &&
              rng.bits((head_base + qq) * S + kk) < p.threshold;
          pav = keep ? e * p.inv_keep : 0.f;
        }
        Ps[(ty * TI + i) * LP + tx * TJ + j] = pav;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) o[i][jj] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TI], vb[DJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) a[i] = Ps[(ty * TI + i) * LP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vb[jj] = Vs[kk * LD + tx * DJ + jj];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          o[i][jj] = fmaf(a[i], vb[jj], o[i][jj]);
    }
  }
  const long long hs = static_cast<long long>(NH) * D;
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int qq = q0 + ty * TI + i;
    if (qq >= S) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    float* row = out + (static_cast<long long>(b) * S + qq) * hs +
             static_cast<long long>(h) * D + tx * DJ;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) row[jj] = o[i][jj] / safe_l;
    if (tx == 0)
      p.lse_out[(static_cast<long long>(b) * NH + h) * S + qq] =
          m[i] + logf(safe_l);
  }
}

// p (pre-dropout), the dropped p that feeds dV, and ds for one score
// element, from its raw dot products q.k and dO.v.
struct BwdElem {
  float pav;
  float ds;
};

__device__ __forceinline__ BwdElem bwd_elem(float dot, float dpv, int code,
                                            int qq, int kk, float lse_q,
                                            float delta_q, const Params& p,
                                            PhiloxCursor& rng,
                                            unsigned long long head_base) {
  BwdElem r;
  if (qq >= p.S || code == 2) {
    r.pav = 0.f;
    r.ds = 0.f;
    return r;
  }
  const float s = masked_score(dot, code, qq, kk, p);
  const float pr = expf(s - lse_q);
  float pav = pr, dp = dpv;
  if (p.dropout) {
    const bool keep = rng.bits((head_base + qq) * p.S + kk) < p.threshold;
    pav = keep ? pr * p.inv_keep : 0.f;
    dp = keep ? dpv * p.inv_keep : 0.f;
  }
  r.pav = pav;
  r.ds = pr * (dp - delta_q) * p.scale;
  return r;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  float* lse_s = dSs + BQ * LP;
  float* delta_s = lse_s + BQ;
  int* codes = reinterpret_cast<int*>(delta_s + BQ);
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int S = p.S, NH = p.NH;
  load_tile<D>(Ks, static_cast<const float*>(p.k), b, h, k0, S, NH);
  load_tile<D>(Vs, static_cast<const float*>(p.v), b, h, k0, S, NH);
  load_codes(codes, p, b, k0);
  float dk[TI][DJ], dv[TI][DJ];  // key rows 4 ty + i, columns tx * DJ + jj
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;
  PhiloxCursor rng(p.seed);
  const long long row_base = (static_cast<long long>(b) * NH + h) * S;
  const unsigned long long head_base = static_cast<unsigned long long>(row_base);
  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();
    load_tile<D>(Qs, static_cast<const float*>(p.q), b, h, q0, S, NH);
    load_tile<D>(dOs, static_cast<const float*>(p.dout), b, h, q0, S, NH);
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? p.lse[row_base + q0 + r] : 0.f;
      delta_s[r] = in ? p.delta[row_base + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[TI][TJ], dpv[TI][TJ];
    tile_dots<D>(Qs, Ks, s, ty, tx);
    tile_dots<D>(dOs, Vs, dpv, ty, tx);
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int qr = ty * TI + i;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int kj = tx * TJ + j;
        const BwdElem e =
            bwd_elem(s[i][j], dpv[i][j], codes[kj], q0 + qr, k0 + kj,
                     lse_s[qr], delta_s[qr], p, rng, head_base);
        Ps[qr * LP + kj] = e.pav;
        dSs[qr * LP + kj] = e.ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pa[TI], da[TI], ob[DJ], qb[DJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        pa[i] = Ps[qq * LP + ty * TI + i];
        da[i] = dSs[qq * LP + ty * TI + i];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        ob[jj] = dOs[qq * LD + tx * DJ + jj];
        qb[jj] = Qs[qq * LD + tx * DJ + jj];
      }
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          dv[i][jj] = fmaf(pa[i], ob[jj], dv[i][jj]);
          dk[i][jj] = fmaf(da[i], qb[jj], dk[i][jj]);
        }
    }
  }
  const long long hs = static_cast<long long>(NH) * D;
  float* dk_out = static_cast<float*>(p.out);
  float* dv_out = static_cast<float*>(p.out2);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int kk = k0 + ty * TI + i;
    if (kk >= S) continue;
    const long long off = (static_cast<long long>(b) * S + kk) * hs +
                          static_cast<long long>(h) * D + tx * DJ;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      dk_out[off + jj] = dk[i][jj];
      dv_out[off + jj] = dv[i][jj];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse_s = dSs + BQ * LP;
  float* delta_s = lse_s + BQ;
  int* codes = reinterpret_cast<int*>(delta_s + BQ);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int S = p.S, NH = p.NH;
  const long long row_base = (static_cast<long long>(b) * NH + h) * S;
  const unsigned long long head_base = static_cast<unsigned long long>(row_base);
  load_tile<D>(Qs, static_cast<const float*>(p.q), b, h, q0, S, NH);
  load_tile<D>(dOs, static_cast<const float*>(p.dout), b, h, q0, S, NH);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? p.lse[row_base + q0 + r] : 0.f;
    delta_s[r] = in ? p.delta[row_base + q0 + r] : 0.f;
  }
  float dq[TI][DJ];  // query rows 4 ty + i, columns tx * DJ + jj
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq[i][jj] = 0.f;
  PhiloxCursor rng(p.seed);
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile<D>(Ks, static_cast<const float*>(p.k), b, h, k0, S, NH);
    load_tile<D>(Vs, static_cast<const float*>(p.v), b, h, k0, S, NH);
    load_codes(codes, p, b, k0);
    __syncthreads();
    float s[TI][TJ], dpv[TI][TJ];
    tile_dots<D>(Qs, Ks, s, ty, tx);
    tile_dots<D>(dOs, Vs, dpv, ty, tx);
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int qr = ty * TI + i;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int kj = tx * TJ + j;
        const BwdElem e =
            bwd_elem(s[i][j], dpv[i][j], codes[kj], q0 + qr, k0 + kj,
                     lse_s[qr], delta_s[qr], p, rng, head_base);
        dSs[qr * LP + kj] = e.ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float da[TI], kb[DJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) da[i] = dSs[(ty * TI + i) * LP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kb[jj] = Ks[kk * LD + tx * DJ + jj];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          dq[i][jj] = fmaf(da[i], kb[jj], dq[i][jj]);
    }
  }
  const long long hs = static_cast<long long>(NH) * D;
  float* dq_out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int qq = q0 + ty * TI + i;
    if (qq >= S) continue;
    const long long off = (static_cast<long long>(b) * S + qq) * hs +
                          static_cast<long long>(h) * D + tx * DJ;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq_out[off + jj] = dq[i][jj];
  }
}

// -- bf16 inputs: tensor cores (WMMA) ----------------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // four warps, 16 tile rows each

template <int D>
struct Tc {
  static constexpr int LDH = D + 8;                  // bf16 tile row
  static constexpr int LDS = (D > BK ? D : BK) + 4;  // fp32 scratch row
  static constexpr int LDP = BK + 8;                 // bf16 p / ds row
  static constexpr int NJ = D / 16;                  // 16-col output frags
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Rows [r0, r0 + 64) of head h of batch row b (zeros past S) into a bf16
// tile with row stride D + 8; 16-byte copies where the source is aligned.
template <int D>
__device__ __forceinline__ void load_tile_tc(bf16* dst, const bf16* src,
                                             int b, int h, int r0, int S,
                                             int NH, bool vec) {
  constexpr int LDH = Tc<D>::LDH;
  const long long hs = static_cast<long long>(NH) * D;
  const bf16* base = src + static_cast<long long>(b) * S * hs +
                     static_cast<long long>(h) * D;
  if (vec) {
    constexpr int CH = D / 8;
    for (int e = threadIdx.x; e < 64 * CH; e += kTcThreads) {
      const int r = e / CH, c = (e % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < S)
        val = *reinterpret_cast<const uint4*>(
            base + static_cast<long long>(r0 + r) * hs + c);
      *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < 64 * D; e += kTcThreads) {
      const int r = e / D, c = e % D;
      dst[r * LDH + c] = r0 + r < S
                             ? base[static_cast<long long>(r0 + r) * hs + c]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// out (16 x 64, fp32, row stride LDS) = A (16 x D rows of a bf16 tile) times
// the transpose of B (64 x D rows of a bf16 tile): raw dot products.
template <int D>
__device__ __forceinline__ void warp_dots(const bf16* A, const bf16* Bt,
                                          float* out) {
  constexpr int LDH = Tc<D>::LDH;
  AccFrag acc[BK / 16];
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) wmma::fill_fragment(acc[t], 0.f);
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + d0, LDH);
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(bt, Bt + t * 16 * LDH + d0, LDH);
      wmma::mma_sync(acc[t], a, bt, acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
    wmma::store_matrix_sync(out + t * 16, acc[t], Tc<D>::LDS,
                            wmma::mem_row_major);
}

// acc[j] += A (16 x 64 bf16, row stride LDP) times B (64 x D rows of a bf16
// tile), output columns [16 j, 16 j + 16).
template <int D>
__device__ __forceinline__ void warp_accumulate(AccFrag* acc, const bf16* A,
                                                const bf16* Bm) {
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + k0, Tc<D>::LDP);
#pragma unroll
    for (int j = 0; j < Tc<D>::NJ; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
      wmma::load_matrix_sync(bm, Bm + k0 * Tc<D>::LDH + j * 16, Tc<D>::LDH);
      wmma::mma_sync(acc[j], a, bm, acc[j]);
    }
  }
}

// Write a warp's 16 x D accumulator rows to rows [r0, r0 + 16) of head h
// (rows past S skipped), through its fp32 scratch rows.
template <int D>
__device__ __forceinline__ void warp_store_rows(AccFrag* acc, float* scratch,
                                                bf16* dst, int b, int h,
                                                int r0, int S, int NH) {
#pragma unroll
  for (int j = 0; j < Tc<D>::NJ; ++j)
    wmma::store_matrix_sync(scratch + j * 16, acc[j], Tc<D>::LDS,
                            wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const long long hs = static_cast<long long>(NH) * D;
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    if (r0 + r < S)
      dst[(static_cast<long long>(b) * S + r0 + r) * hs +
          static_cast<long long>(h) * D + c] =
          __float2bfloat16_rn(scratch[r * Tc<D>::LDS + c]);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(Params p, bool vec) {
  using L = Tc<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * L::LDH;
  bf16* Vs = Ks + BK * L::LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BK * L::LDH);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * L::LDS);
  int* codes = reinterpret_cast<int*>(Ps + BQ * L::LDP);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = p.S, NH = p.NH;
  // lane owns row rr of its warp's 16 and the 32 keys [32 half, + 32) of
  // each key tile
  const int rr = lane >> 1, half = lane & 1;
  const int qq = q0 + 16 * w + rr;
  float* Sw = Ss + 16 * w * L::LDS;
  bf16* Pw = Ps + 16 * w * L::LDP;
  const bf16* Qw = Qs + 16 * w * L::LDH;
  load_tile_tc<D>(Qs, static_cast<const bf16*>(p.q), b, h, q0, S, NH, vec);

  // pass 1: each row's max and sum over all keys
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile_tc<D>(Ks, static_cast<const bf16*>(p.k), b, h, k0, S, NH, vec);
    load_codes(codes, p, b, k0);
    __syncthreads();
    warp_dots<D>(Qw, Ks, Sw);
    __syncwarp();
    float s[32];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 32 * half + j;
      s[j] = masked_score(Sw[rr * L::LDS + c], codes[c], qq, k0 + c, p);
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) rs += expf(s[j] - m_new);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * expf(m - m_new) + rs;
    m = m_new;
    __syncwarp();
  }

  // pass 2: p = exp(s - max), dropped and rounded to bf16, times V
  AccFrag o[L::NJ];
#pragma unroll
  for (int j = 0; j < L::NJ; ++j) wmma::fill_fragment(o[j], 0.f);
  PhiloxCursor rng(p.seed);
  const unsigned long long row_index =
      (static_cast<unsigned long long>(b * NH + h) * S + qq) * S;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile_tc<D>(Ks, static_cast<const bf16*>(p.k), b, h, k0, S, NH, vec);
    load_tile_tc<D>(Vs, static_cast<const bf16*>(p.v), b, h, k0, S, NH, vec);
    load_codes(codes, p, b, k0);
    __syncthreads();
    warp_dots<D>(Qw, Ks, Sw);
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = 32 * half + j, kk = k0 + c;
      const float e =
          expf(masked_score(Sw[rr * L::LDS + c], codes[c], qq, kk, p) - m);
      float pav = e;
      if (p.dropout) {
        const bool keep = qq < S && kk < S &&
                          rng.bits(row_index + kk) < p.threshold;
        pav = keep ? e * p.inv_keep : 0.f;
      }
      Pw[rr * L::LDP + c] = __float2bfloat16_rn(pav);
    }
    __syncwarp();
    warp_accumulate<D>(o, Pw, Vs);
  }
  // out = (p V) / l, lse = max + log(l)
  const float safe_l = l > 0.f ? l : 1.f;
#pragma unroll
  for (int j = 0; j < L::NJ; ++j)
    wmma::store_matrix_sync(Sw + j * 16, o[j], L::LDS, wmma::mem_row_major);
  __syncwarp();
  if (qq < S) {
    const long long hs = static_cast<long long>(NH) * D;
    bf16* row = static_cast<bf16*>(p.out) +
                (static_cast<long long>(b) * S + qq) * hs +
                static_cast<long long>(h) * D + half * (D / 2);
    const float* src = Sw + rr * L::LDS + half * (D / 2);
#pragma unroll 8
    for (int c = 0; c < D / 2; ++c) row[c] = __float2bfloat16_rn(src[c] / safe_l);
    if (half == 0)
      p.lse_out[(static_cast<long long>(b) * NH + h) * S + qq] =
          m + logf(safe_l);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkdv_tc_kernel(Params p, bool vec) {
  using L = Tc<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * L::LDH;
  bf16* Qs = Vs + BK * L::LDH;
  bf16* dOs = Qs + BQ * L::LDH;
  float* St = reinterpret_cast<float*>(dOs + BQ * L::LDH);  // s^T rows
  float* dPt = St + BK * L::LDS;                            // dP^T rows
  bf16* Pt = reinterpret_cast<bf16*>(dPt + BK * L::LDS);
  bf16* dSt = Pt + BK * L::LDP;
  float* lse_s = reinterpret_cast<float*>(dSt + BK * L::LDP);
  float* delta_s = lse_s + BQ;
  int* codes = reinterpret_cast<int*>(delta_s + BQ);
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = p.S, NH = p.NH;
  float* Stw = St + 16 * w * L::LDS;
  float* dPtw = dPt + 16 * w * L::LDS;
  bf16* Ptw = Pt + 16 * w * L::LDP;
  bf16* dStw = dSt + 16 * w * L::LDP;
  load_tile_tc<D>(Ks, static_cast<const bf16*>(p.k), b, h, k0, S, NH, vec);
  load_tile_tc<D>(Vs, static_cast<const bf16*>(p.v), b, h, k0, S, NH, vec);
  load_codes(codes, p, b, k0);
  AccFrag dk[L::NJ], dv[L::NJ];
#pragma unroll
  for (int j = 0; j < L::NJ; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }
  PhiloxCursor rng(p.seed);
  const long long row_base = (static_cast<long long>(b) * NH + h) * S;
  const unsigned long long head_base =
      static_cast<unsigned long long>(row_base);
  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();
    load_tile_tc<D>(Qs, static_cast<const bf16*>(p.q), b, h, q0, S, NH, vec);
    load_tile_tc<D>(dOs, static_cast<const bf16*>(p.dout), b, h, q0, S, NH,
                    vec);
    for (int r = threadIdx.x; r < BQ; r += kTcThreads) {
      const bool in = q0 + r < S;
      lse_s[r] = in ? p.lse[row_base + q0 + r] : 0.f;
      delta_s[r] = in ? p.delta[row_base + q0 + r] : 0.f;
    }
    __syncthreads();
    // this warp's 16 keys against the tile's 64 queries, transposed
    warp_dots<D>(Ks + 16 * w * L::LDH, Qs, Stw);
    warp_dots<D>(Vs + 16 * w * L::LDH, dOs, dPtw);
    __syncwarp();
    // lane owns queries 2 lane, 2 lane + 1 and the warp's 16 keys (four
    // consecutive keys share one Philox call)
#pragma unroll
    for (int qi = 0; qi < 2; ++qi) {
      const int qc = 2 * lane + qi;
      const float lse_q = lse_s[qc], delta_q = delta_s[qc];
#pragma unroll 4
      for (int kr = 0; kr < 16; ++kr) {
        const BwdElem e = bwd_elem(Stw[kr * L::LDS + qc],
                                   dPtw[kr * L::LDS + qc], codes[16 * w + kr],
                                   q0 + qc, k0 + 16 * w + kr, lse_q, delta_q,
                                   p, rng, head_base);
        Ptw[kr * L::LDP + qc] = __float2bfloat16_rn(e.pav);
        dStw[kr * L::LDP + qc] = __float2bfloat16_rn(e.ds);
      }
    }
    __syncwarp();
    warp_accumulate<D>(dv, Ptw, dOs);
    warp_accumulate<D>(dk, dStw, Qs);
  }
  warp_store_rows<D>(dk, Stw, static_cast<bf16*>(p.out), b, h,
                     k0 + 16 * w, S, NH);
  warp_store_rows<D>(dv, Stw, static_cast<bf16*>(p.out2), b, h,
                     k0 + 16 * w, S, NH);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_tc_kernel(Params p, bool vec) {
  using L = Tc<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * L::LDH;
  bf16* Ks = dOs + BQ * L::LDH;
  bf16* Vs = Ks + BK * L::LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BK * L::LDH);
  float* dPs = Ss + BQ * L::LDS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + BQ * L::LDS);
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * L::LDP);
  float* delta_s = lse_s + BQ;
  int* codes = reinterpret_cast<int*>(delta_s + BQ);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = p.S, NH = p.NH;
  const int rr = lane >> 1, half = lane & 1;
  const int qr = 16 * w + rr, qq = q0 + qr;
  float* Sw = Ss + 16 * w * L::LDS;
  float* dPw = dPs + 16 * w * L::LDS;
  bf16* dSw = dSs + 16 * w * L::LDP;
  const long long row_base = (static_cast<long long>(b) * NH + h) * S;
  const unsigned long long head_base =
      static_cast<unsigned long long>(row_base);
  load_tile_tc<D>(Qs, static_cast<const bf16*>(p.q), b, h, q0, S, NH, vec);
  load_tile_tc<D>(dOs, static_cast<const bf16*>(p.dout), b, h, q0, S, NH,
                  vec);
  for (int r = threadIdx.x; r < BQ; r += kTcThreads) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? p.lse[row_base + q0 + r] : 0.f;
    delta_s[r] = in ? p.delta[row_base + q0 + r] : 0.f;
  }
  AccFrag dq[L::NJ];
#pragma unroll
  for (int j = 0; j < L::NJ; ++j) wmma::fill_fragment(dq[j], 0.f);
  PhiloxCursor rng(p.seed);
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile_tc<D>(Ks, static_cast<const bf16*>(p.k), b, h, k0, S, NH, vec);
    load_tile_tc<D>(Vs, static_cast<const bf16*>(p.v), b, h, k0, S, NH, vec);
    load_codes(codes, p, b, k0);
    __syncthreads();
    warp_dots<D>(Qs + 16 * w * L::LDH, Ks, Sw);
    warp_dots<D>(dOs + 16 * w * L::LDH, Vs, dPw);
    __syncwarp();
    const float lse_q = lse_s[qr], delta_q = delta_s[qr];
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = 32 * half + j;
      const BwdElem e =
          bwd_elem(Sw[rr * L::LDS + c], dPw[rr * L::LDS + c], codes[c], qq,
                   k0 + c, lse_q, delta_q, p, rng, head_base);
      dSw[rr * L::LDP + c] = __float2bfloat16_rn(e.ds);
    }
    __syncwarp();
    warp_accumulate<D>(dq, dSw, Ks);
  }
  warp_store_rows<D>(dq, Sw, static_cast<bf16*>(p.out), b, h, q0 + 16 * w, S,
                     NH);
}

template <int D>
constexpr size_t fwd_tc_smem() {
  using L = Tc<D>;
  return 2 * (3 * 64 * L::LDH + 64 * L::LDP) + 4 * 64 * L::LDS + 4 * BK;
}
template <int D>
constexpr size_t dkdv_tc_smem() {
  using L = Tc<D>;
  return 2 * (4 * 64 * L::LDH + 2 * 64 * L::LDP) + 4 * 2 * 64 * L::LDS +
         4 * 2 * BQ + 4 * BK;
}
template <int D>
constexpr size_t dq_tc_smem() {
  using L = Tc<D>;
  return 2 * (4 * 64 * L::LDH + 64 * L::LDP) + 4 * 2 * 64 * L::LDS +
         4 * 2 * BQ + 4 * BK;
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LP) +
         sizeof(int) * BK;
}
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
             (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * LP + 2 * BQ) +
         sizeof(int) * BK;
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) *
             (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LP + 2 * BQ) +
         sizeof(int) * BK;
}

template <typename K, typename... Args>
int launch_kernel(K kernel, size_t smem, dim3 grid, int threads,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// fp32: the CUDA-core kernels; bf16: the tensor-core kernels
template <int D>
int fwd(const Params& p, bool bf16_in, bool vec, cudaStream_t s) {
  dim3 grid((p.S + BQ - 1) / BQ, p.NH, p.B);
  if (bf16_in)
    return launch_kernel(flash_fwd_tc_kernel<D>, fwd_tc_smem<D>(), grid,
                         kTcThreads, s, p, vec);
  return launch_kernel(flash_fwd_kernel<D>, fwd_smem<D>(), grid,
                       kThreads, s, p);
}

template <int D>
int bwd(const Params& p, void* dq, bool bf16_in, bool vec, cudaStream_t s) {
  dim3 grid_k((p.S + BK - 1) / BK, p.NH, p.B);
  Params pq = p;
  pq.out = dq;
  pq.out2 = nullptr;
  dim3 grid_q((p.S + BQ - 1) / BQ, p.NH, p.B);
  if (bf16_in) {
    int err = launch_kernel(flash_bwd_dkdv_tc_kernel<D>, dkdv_tc_smem<D>(),
                            grid_k, kTcThreads, s, p, vec);
    if (err != 0) return err;
    return launch_kernel(flash_bwd_dq_tc_kernel<D>, dq_tc_smem<D>(), grid_q,
                         kTcThreads, s, pq, vec);
  }
  int err = launch_kernel(flash_bwd_dkdv_kernel<D>, dkdv_smem<D>(),
                          grid_k, kThreads, s, p);
  if (err != 0) return err;
  return launch_kernel(flash_bwd_dq_kernel<D>, dq_smem<D>(), grid_q,
                       kThreads, s, pq);
}

int dispatch_fwd(int D, const Params& p, bool bf16_in, bool vec,
                 cudaStream_t s) {
  switch (D) {
    case 32: return fwd<32>(p, bf16_in, vec, s);
    case 64: return fwd<64>(p, bf16_in, vec, s);
    case 128: return fwd<128>(p, bf16_in, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_bwd(int D, const Params& p, void* dq, bool bf16_in, bool vec,
                 cudaStream_t s) {
  switch (D) {
    case 32: return bwd<32>(p, dq, bf16_in, vec, s);
    case 64: return bwd<64>(p, dq, bf16_in, vec, s);
    case 128: return bwd<128>(p, dq, bf16_in, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* key_mask, int B, int S, int NH, float scale,
                   int causal, int dropout, unsigned int seed,
                   unsigned int threshold, float inv_keep) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.key_mask = static_cast<const uint8_t*>(key_mask);
  p.B = B;
  p.S = S;
  p.NH = NH;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.seed = seed;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  return p;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v, out). q, k, v, out are
// contiguous (B, S, NH * D); key_mask (B, S) uint8 or null; lse (B, NH, S)
// fp32. D in {32, 64, 128}.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, void* lse,
                              int B, int S, int NH, int D, int dtype,
                              float scale, int causal, int dropout,
                              unsigned int seed, unsigned int threshold,
                              float inv_keep, void* stream) {
  if (B < 1 || S < 1 || NH < 1) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, key_mask, B, S, NH, scale, causal, dropout,
                         seed, threshold, inv_keep);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v);
  return dispatch_fwd(D, p, dtype == 1, vec, s);
}

// The backward: dq, dk, dv (B, S, NH * D) in the input dtype, from q, k,
// v, dout, the forward's lse and delta = rowsum(dout * out) per head
// (B, NH, S) fp32.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* key_mask, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              void* dk, void* dv, int B, int S, int NH, int D,
                              int dtype, float scale, int causal, int dropout,
                              unsigned int seed, unsigned int threshold,
                              float inv_keep, void* stream) {
  if (B < 1 || S < 1 || NH < 1) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, key_mask, B, S, NH, scale, causal, dropout,
                         seed, threshold, inv_keep);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = dk;
  p.out2 = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool vec =
      aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout);
  return dispatch_bwd(D, p, dq, dtype == 1, vec, s);
}
