// Flash attention, forward and backward, on (B, NH, S, D) operands read by
// stride, CUDA C++ for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of apex_tpu/ops/flash_attention.py:
//   _fwd_single_kernel_bsh (B4) and _bwd_fused_kernel_bsh (B5), behind
//     flash_attention_bsh in its single-tile regime (S <= 512);
//   _fwd_kernel (B9, tiled online softmax), _bwd_dq_kernel (B11a) and
//     _bwd_dkv_kernel (B11b), behind flash_attention beyond one tile and
//     flash_attention_bsh's fallback (GPT-2 at S 1024);
//   _fwd_single_kernel (B10) and _bwd_fused_kernel (B12), flash_attention
//     in its single-tile regime (contrib multihead_attn).
// The TPU needs five kernels because its blocks must tile 128 lanes and its
// grid carries sums from step to step; here one forward per input width
// (fp32 below; bf16 and fp16 in csrc/flash_fwd_sm90.cu) and one two-kernel
// backward take any Sq, Sk and strides, so the five share one source of
// truth for the mask, the Philox numbering and the rounding. The wrappers
// count each call under the name of the TPU kernel it stands in for.
//
// Semantics (per batch row b and head h; q rows 0 .. Sq - 1, keys 0 .. Sk-1):
//   s[q, k] = (q_q . k_k) * scale, or FILL = -30000 where key k is masked
//             (key_mask[b, k] != 0) or, when causal, k > q (absolute
//             indices, Sq != Sk allowed); a masked key still counts in the
//             softmax, so a fully masked row is the uniform average over
//             its Sk keys;
//   p = exp(s - max) / l, l = sum of exp(s - max), lse = max + log(l);
//   dropout: keep[q, k] = bits(seed, ((b * NH + h) * Sq + q) * Sk + k) <
//             threshold (csrc/philox.cuh), applied to p before the product
//             with V (scaled by 1 / (1 - rate)); l and lse stay pre-dropout;
//   out = (keep * p / (1 - rate)) V, rounded to the input type, and p is
//             rounded to the input type before that product, as the TPU
//             kernels cast p to V's type;
//   backward: dp = dO V^T (masked by keep and scaled), delta = rowsum(dO *
//             O) - dlse per head (computed by the caller), ds = p * (dp -
//             delta) * scale, dV = (keep * p / (1 - rate))^T dO, dQ = ds K,
//             dK = ds^T Q, with p and ds rounded to the input type before
//             their products.
// All arithmetic is fp32; inputs and outputs are fp32, bf16 or fp16.
//
// Causal skip: with causal on and no key mask, a key tile wholly above the
// diagonal contributes exp(FILL - m) = 0 in fp32 to every row (each row
// keeps key 0 live, so its max is far above FILL), and the forward and dQ
// kernels stop before it; the dK/dV kernel starts at the first query tile
// that reaches its keys. With a key mask a row may have every live key
// masked, its max is then FILL and JAX averages over all Sk keys, causal
// ones included, so nothing is skipped.
//
// What bounds it on the H100: operations. At GPT-2 small's shape (B 8,
// S 1024, NH 12, D 64, causal) the forward needs 12.9 GFLOP of products
// (25.8 without the causal half) on 38 MB of inputs.
//
// Design. The TPU kernels hold (512 x 512) score tiles in VMEM and read
// head pairs per 128-lane block; neither constraint exists here. Every
// kernel reads its rows of q, k, v through (batch, head, row) element
// strides with the head dim contiguous, so the flat (B, S, NH * D)
// activations of the bsh entry, the (B, NH, S, D) tensors of
// flash_attention and the sequence-first (T, B, NH, D) views of the contrib
// modules are all read in place, and works on 64 x 64 score tiles. The
// backward is two kernels, so that no sum needs atomics (deterministic):
// dK/dV with one block per 64-key tile looping over the query tiles, and dQ
// with one block per 64-query tile looping over the key tiles; each
// recomputes s and p from q, k and lse and replays the same mask.
//
// The 16-bit backward (bf16, the training path, and fp16) runs on the
// tensor cores through WMMA fragments of the input type with fp32
// accumulation. A block is four warps and each warp owns 16 rows of the
// block's tile: it computes its 16 x 64 scores (and dP) into its own fp32
// shared-memory rows, applies the mask, softmax, dropout and rounding
// there with its 32 lanes, writes p (or ds) back in the input type and
// multiplies that with the shared V / dO / Q / K tile, accumulating in
// fragments. Only the tile loads need the whole block. The 16-bit forward
// is csrc/flash_fwd_sm90.cu (wgmma, TMA, one pass with an online softmax).
//
// fp32 inputs run the products as fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), from shared memory: 256 threads, thread (ty, tx) computing rows
// 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of a score tile in
// registers from tiles padded to D + 1 floats a row; the forward keeps an
// online softmax (running max and sum per row, the output accumulator
// rescaled per key tile), as JAX's tiled kernel does. The backward kernels
// keep their own 64 x 64 tiles (BQ, BK, query_start): the 16-bit forward's
// tile size is its own.

#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"
#include "flash_common.cuh"
#include "philox.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int TI = 4;        // score rows per thread
constexpr int TJ = 4;        // score columns per thread
constexpr int LP = BK + 1;   // padded row of a score tile
using flash::FILL;
using flash::Layout;
using flash::Params;

template <typename T>
__device__ __forceinline__ const T* head_base(const void* ptr,
                                              const Layout& L, int b, int h) {
  return static_cast<const T*>(ptr) + b * L.b + h * L.h;
}

template <typename T>
__device__ __forceinline__ T* head_base_out(void* ptr, const Layout& L, int b,
                                            int h) {
  return static_cast<T*>(ptr) + b * L.b + h * L.h;
}

// One past the last key a query tile starting at q0 must visit.
__device__ __forceinline__ int key_end(const Params& p, int q0) {
  return p.skip ? min(p.Sk, q0 + BQ) : p.Sk;
}

// The first query tile that reaches a key tile starting at k0.
__device__ __forceinline__ int query_start(const Params& p, int k0) {
  return p.skip ? (k0 / BQ) * BQ : 0;
}

// Load rows [r0, r0 + 64) (zeros at rows >= n) of a head into a
// (64 x (D + 1)) fp32 tile.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long rs, int r0, int n) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < 64 * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * LD + c] = r0 + r < n ? base[(r0 + r) * rs + c] : 0.f;
  }
}

// Per-key code of a key tile: 0 live, 1 masked (scores FILL), 2 past Sk
// (excluded from the softmax).
__device__ __forceinline__ void load_codes(int* codes, const Params& p,
                                           int b, int k0, int nthreads) {
  for (int j = threadIdx.x; j < BK; j += nthreads) {
    const int kk = k0 + j;
    codes[j] = kk >= p.Sk ? 2
               : (p.key_mask &&
                  p.key_mask[static_cast<long long>(b) * p.Sk + kk])
                   ? 1
                   : 0;
  }
}

// Per-row lse and delta of a query tile (zeros past Sq).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const Params& p,
                                               long long row_base, int q0,
                                               int nthreads) {
  for (int r = threadIdx.x; r < BQ; r += nthreads) {
    const bool in = q0 + r < p.Sq;
    lse_s[r] = in ? __ldg(p.lse + row_base + q0 + r) : 0.f;
    delta_s[r] = in ? __ldg(p.delta + row_base + q0 + r) : 0.f;
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
  const int Sq = p.Sq, Sk = p.Sk;
  const float* qb = head_base<float>(p.q, p.lq, b, h);
  const float* kb = head_base<float>(p.k, p.lk, b, h);
  const float* vb = head_base<float>(p.v, p.lv, b, h);
  load_tile<D>(Qs, qb, p.lq.r, q0, Sq);
  float m[TI], l[TI], o[TI][DJ];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) o[i][jj] = 0.f;
  }
  PhiloxCursor rng(p.seed);
  const unsigned long long head_rows =
      static_cast<unsigned long long>(b * p.NH + h) * Sq;
  const int kend = key_end(p, q0);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K, V, P are consumed
    load_tile<D>(Ks, kb, p.lk.r, k0, Sk);
    load_tile<D>(Vs, vb, p.lv.r, k0, Sk);
    load_codes(codes, p, b, k0, kThreads);
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
              qq < Sq && kk < Sk &&
              rng.bits((head_rows + qq) * Sk + kk) < p.threshold;
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
      float a[TI], vr[DJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) a[i] = Ps[(ty * TI + i) * LP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vr[jj] = Vs[kk * LD + tx * DJ + jj];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          o[i][jj] = fmaf(a[i], vr[jj], o[i][jj]);
    }
  }
  float* ob = head_base_out<float>(p.out, p.lo, b, h);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int qq = q0 + ty * TI + i;
    if (qq >= Sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    float* row = ob + qq * p.lo.r + tx * DJ;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) row[jj] = o[i][jj] / safe_l;
    if (tx == 0) p.lse_out[head_rows + qq] = m[i] + logf(safe_l);
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
                                            unsigned long long head_rows) {
  BwdElem r;
  if (qq >= p.Sq || code == 2) {
    r.pav = 0.f;
    r.ds = 0.f;
    return r;
  }
  const float s = masked_score(dot, code, qq, kk, p);
  const float pr = expf(s - lse_q);
  float pav = pr, dp = dpv;
  if (p.dropout) {
    const bool keep =
        rng.bits((head_rows + qq) * p.Sk + kk) < p.threshold;
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
  const int Sq = p.Sq, Sk = p.Sk;
  const float* qb = head_base<float>(p.q, p.lq, b, h);
  const float* dob = head_base<float>(p.dout, p.ldo, b, h);
  load_tile<D>(Ks, head_base<float>(p.k, p.lk, b, h), p.lk.r, k0, Sk);
  load_tile<D>(Vs, head_base<float>(p.v, p.lv, b, h), p.lv.r, k0, Sk);
  load_codes(codes, p, b, k0, kThreads);
  float dk[TI][DJ], dv[TI][DJ];  // key rows 4 ty + i, columns tx * DJ + jj
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;
  PhiloxCursor rng(p.seed);
  const long long row_base = (static_cast<long long>(b) * p.NH + h) * Sq;
  const unsigned long long head_rows =
      static_cast<unsigned long long>(row_base);
  for (int q0 = query_start(p, k0); q0 < Sq; q0 += BQ) {
    __syncthreads();
    load_tile<D>(Qs, qb, p.lq.r, q0, Sq);
    load_tile<D>(dOs, dob, p.ldo.r, q0, Sq);
    load_row_stats(lse_s, delta_s, p, row_base, q0, kThreads);
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
                     lse_s[qr], delta_s[qr], p, rng, head_rows);
        Ps[qr * LP + kj] = e.pav;
        dSs[qr * LP + kj] = e.ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pa[TI], da[TI], ob[DJ], qr[DJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        pa[i] = Ps[qq * LP + ty * TI + i];
        da[i] = dSs[qq * LP + ty * TI + i];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        ob[jj] = dOs[qq * LD + tx * DJ + jj];
        qr[jj] = Qs[qq * LD + tx * DJ + jj];
      }
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          dv[i][jj] = fmaf(pa[i], ob[jj], dv[i][jj]);
          dk[i][jj] = fmaf(da[i], qr[jj], dk[i][jj]);
        }
    }
  }
  float* dkb = head_base_out<float>(p.out, p.lo, b, h);
  float* dvb = head_base_out<float>(p.out2, p.lo2, b, h);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int kk = k0 + ty * TI + i;
    if (kk >= Sk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      dkb[kk * p.lo.r + tx * DJ + jj] = dk[i][jj];
      dvb[kk * p.lo2.r + tx * DJ + jj] = dv[i][jj];
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
  const int Sq = p.Sq, Sk = p.Sk;
  const long long row_base = (static_cast<long long>(b) * p.NH + h) * Sq;
  const unsigned long long head_rows =
      static_cast<unsigned long long>(row_base);
  const float* kb = head_base<float>(p.k, p.lk, b, h);
  const float* vb = head_base<float>(p.v, p.lv, b, h);
  load_tile<D>(Qs, head_base<float>(p.q, p.lq, b, h), p.lq.r, q0, Sq);
  load_tile<D>(dOs, head_base<float>(p.dout, p.ldo, b, h), p.ldo.r, q0, Sq);
  load_row_stats(lse_s, delta_s, p, row_base, q0, kThreads);
  float dq[TI][DJ];  // query rows 4 ty + i, columns tx * DJ + jj
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq[i][jj] = 0.f;
  PhiloxCursor rng(p.seed);
  const int kend = key_end(p, q0);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_tile<D>(Ks, kb, p.lk.r, k0, Sk);
    load_tile<D>(Vs, vb, p.lv.r, k0, Sk);
    load_codes(codes, p, b, k0, kThreads);
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
                     lse_s[qr], delta_s[qr], p, rng, head_rows);
        dSs[qr * LP + kj] = e.ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float da[TI], kr[DJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) da[i] = dSs[(ty * TI + i) * LP + kk];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) kr[jj] = Ks[kk * LD + tx * DJ + jj];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          dq[i][jj] = fmaf(da[i], kr[jj], dq[i][jj]);
    }
  }
  float* dqb = head_base_out<float>(p.out, p.lo, b, h);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int qq = q0 + ty * TI + i;
    if (qq >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      dqb[qq * p.lo.r + tx * DJ + jj] = dq[i][jj];
  }
}

// -- 16-bit backward: tensor cores (WMMA) ------------------------------------

namespace wmma = nvcuda::wmma;
constexpr int kTcThreads = 128;  // four warps, 16 tile rows each

template <int D>
struct Tc {
  static constexpr int LDH = D + 8;                  // 16-bit tile row
  static constexpr int LDS = (D > BK ? D : BK) + 4;  // fp32 scratch row
  static constexpr int LDP = BK + 8;                 // 16-bit p / ds row
  static constexpr int NJ = D / 16;                  // 16-col output frags
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Rows [r0, r0 + 64) of a head (zeros at rows >= n), a 16-bit tile with
// row stride D + 8 once stored. Where the source rows are 16-byte aligned
// a thread fetches its chunks into registers (read-only loads, __ldg) and
// stores them after; callers fetch two tiles before storing either, so all
// of a thread's loads are in flight together (a load through a plain
// pointer may not move above an earlier shared store, which serialised
// them).
template <int D>
struct TileRegs {
  static constexpr int CH = D / 8;                  // 16-byte chunks a row
  static constexpr int PER = 64 * CH / kTcThreads;  // chunks a thread
  static_assert(64 * CH % kTcThreads == 0, "whole chunks per thread");
  uint4 v[PER];
};

template <typename T, int D>
__device__ __forceinline__ void fetch_tile_tc(TileRegs<D>& t, const T* base,
                                              long long rs, int r0, int n) {
  constexpr int CH = TileRegs<D>::CH;
#pragma unroll
  for (int i = 0; i < TileRegs<D>::PER; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / CH, c = (e % CH) * 8;
    t.v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      t.v[i] = __ldg(reinterpret_cast<const uint4*>(base + (r0 + r) * rs + c));
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_tile_tc(T* dst, const TileRegs<D>& t) {
  constexpr int CH = TileRegs<D>::CH;
#pragma unroll
  for (int i = 0; i < TileRegs<D>::PER; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    *reinterpret_cast<uint4*>(dst + (e / CH) * Tc<D>::LDH + (e % CH) * 8) =
        t.v[i];
  }
}

// The element-wise path, for sources that are not 16-byte aligned.
template <typename T, int D>
__device__ __forceinline__ void load_tile_tc_scalar(T* dst, const T* base,
                                                    long long rs, int r0,
                                                    int n) {
  for (int e = threadIdx.x; e < 64 * D; e += kTcThreads) {
    const int r = e / D, c = e % D;
    dst[r * Tc<D>::LDH + c] =
        r0 + r < n ? base[(r0 + r) * rs + c] : from_f32<T>(0.f);
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_tile_tc(T* dst, const T* base,
                                             long long rs, int r0, int n,
                                             bool vec) {
  if (vec) {
    TileRegs<D> t;
    fetch_tile_tc<T, D>(t, base, rs, r0, n);
    store_tile_tc<T, D>(dst, t);
  } else {
    load_tile_tc_scalar<T, D>(dst, base, rs, r0, n);
  }
}

// Two tiles of the same rows (K and V, or Q and dO), both fetched before
// either is stored; at D = 128 one after the other, to spare registers.
template <typename T, int D>
__device__ __forceinline__ void load_tiles_tc(T* dst0, const T* base0,
                                              long long rs0, T* dst1,
                                              const T* base1, long long rs1,
                                              int r0, int n, bool vec) {
  if constexpr (D <= 64) {
    if (vec) {
      TileRegs<D> t0, t1;
      fetch_tile_tc<T, D>(t0, base0, rs0, r0, n);
      fetch_tile_tc<T, D>(t1, base1, rs1, r0, n);
      store_tile_tc<T, D>(dst0, t0);
      store_tile_tc<T, D>(dst1, t1);
      return;
    }
  }
  load_tile_tc<T, D>(dst0, base0, rs0, r0, n, vec);
  load_tile_tc<T, D>(dst1, base1, rs1, r0, n, vec);
}

// out (16 x 64, fp32, row stride LDS) = A (16 x D rows of a 16-bit tile)
// times the transpose of B (64 x D rows of a 16-bit tile): raw dot
// products.
template <typename T, int D>
__device__ __forceinline__ void warp_dots(const T* A, const T* Bt,
                                          float* out) {
  constexpr int LDH = Tc<D>::LDH;
  AccFrag acc[BK / 16];
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) wmma::fill_fragment(acc[t], 0.f);
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + d0, LDH);
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bt;
      wmma::load_matrix_sync(bt, Bt + t * 16 * LDH + d0, LDH);
      wmma::mma_sync(acc[t], a, bt, acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
    wmma::store_matrix_sync(out + t * 16, acc[t], Tc<D>::LDS,
                            wmma::mem_row_major);
}

// acc[j] += A (16 x 64, 16-bit, row stride LDP) times B (64 x D rows of a
// 16-bit tile), output columns [16 j, 16 j + 16).
template <typename T, int D>
__device__ __forceinline__ void warp_accumulate(AccFrag* acc, const T* A,
                                                const T* Bm) {
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + k0, Tc<D>::LDP);
#pragma unroll
    for (int j = 0; j < Tc<D>::NJ; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bm;
      wmma::load_matrix_sync(bm, Bm + k0 * Tc<D>::LDH + j * 16, Tc<D>::LDH);
      wmma::mma_sync(acc[j], a, bm, acc[j]);
    }
  }
}

// Write a warp's 16 x D accumulator rows to rows [r0, r0 + 16) of a head
// (rows >= n skipped), through its fp32 scratch rows.
template <typename T, int D>
__device__ __forceinline__ void warp_store_rows(AccFrag* acc, float* scratch,
                                                T* dst, long long rs, int r0,
                                                int n) {
#pragma unroll
  for (int j = 0; j < Tc<D>::NJ; ++j)
    wmma::store_matrix_sync(scratch + j * 16, acc[j], Tc<D>::LDS,
                            wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    if (r0 + r < n)
      dst[(r0 + r) * rs + c] = from_f32<T>(scratch[r * Tc<D>::LDS + c]);
  }
  __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkdv_tc_kernel(Params p, bool vec) {
  using L = Tc<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BK * L::LDH;
  T* Qs = Vs + BK * L::LDH;
  T* dOs = Qs + BQ * L::LDH;
  float* St = reinterpret_cast<float*>(dOs + BQ * L::LDH);  // s^T rows
  float* dPt = St + BK * L::LDS;                            // dP^T rows
  T* Pt = reinterpret_cast<T*>(dPt + BK * L::LDS);
  T* dSt = Pt + BK * L::LDP;
  float* lse_s = reinterpret_cast<float*>(dSt + BK * L::LDP);
  float* delta_s = lse_s + BQ;
  int* codes = reinterpret_cast<int*>(delta_s + BQ);
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sq = p.Sq, Sk = p.Sk;
  float* Stw = St + 16 * w * L::LDS;
  float* dPtw = dPt + 16 * w * L::LDS;
  T* Ptw = Pt + 16 * w * L::LDP;
  T* dStw = dSt + 16 * w * L::LDP;
  const T* qb = head_base<T>(p.q, p.lq, b, h);
  const T* dob = head_base<T>(p.dout, p.ldo, b, h);
  load_tiles_tc<T, D>(Ks, head_base<T>(p.k, p.lk, b, h), p.lk.r, Vs,
                      head_base<T>(p.v, p.lv, b, h), p.lv.r, k0, Sk, vec);
  load_codes(codes, p, b, k0, kTcThreads);
  AccFrag dk[L::NJ], dv[L::NJ];
#pragma unroll
  for (int j = 0; j < L::NJ; ++j) {
    wmma::fill_fragment(dk[j], 0.f);
    wmma::fill_fragment(dv[j], 0.f);
  }
  PhiloxCursor rng(p.seed);
  const long long row_base = (static_cast<long long>(b) * p.NH + h) * Sq;
  const unsigned long long head_rows =
      static_cast<unsigned long long>(row_base);
  for (int q0 = query_start(p, k0); q0 < Sq; q0 += BQ) {
    __syncthreads();
    load_tiles_tc<T, D>(Qs, qb, p.lq.r, dOs, dob, p.ldo.r, q0, Sq, vec);
    load_row_stats(lse_s, delta_s, p, row_base, q0, kTcThreads);
    __syncthreads();
    // this warp's 16 keys against the tile's 64 queries, transposed
    warp_dots<T, D>(Ks + 16 * w * L::LDH, Qs, Stw);
    warp_dots<T, D>(Vs + 16 * w * L::LDH, dOs, dPtw);
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
                                   p, rng, head_rows);
        Ptw[kr * L::LDP + qc] = from_f32<T>(e.pav);
        dStw[kr * L::LDP + qc] = from_f32<T>(e.ds);
      }
    }
    __syncwarp();
    warp_accumulate<T, D>(dv, Ptw, dOs);
    warp_accumulate<T, D>(dk, dStw, Qs);
  }
  warp_store_rows<T, D>(dk, Stw, head_base_out<T>(p.out, p.lo, b, h),
                        p.lo.r, k0 + 16 * w, Sk);
  warp_store_rows<T, D>(dv, Stw, head_base_out<T>(p.out2, p.lo2, b, h),
                        p.lo2.r, k0 + 16 * w, Sk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_tc_kernel(Params p, bool vec) {
  using L = Tc<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BQ * L::LDH;
  T* Ks = dOs + BQ * L::LDH;
  T* Vs = Ks + BK * L::LDH;
  float* Ss = reinterpret_cast<float*>(Vs + BK * L::LDH);
  float* dPs = Ss + BQ * L::LDS;
  T* dSs = reinterpret_cast<T*>(dPs + BQ * L::LDS);
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * L::LDP);
  float* delta_s = lse_s + BQ;
  int* codes = reinterpret_cast<int*>(delta_s + BQ);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Sq = p.Sq, Sk = p.Sk;
  const int rr = lane >> 1, side = lane & 1;
  const int qr = 16 * w + rr, qq = q0 + qr;
  float* Sw = Ss + 16 * w * L::LDS;
  float* dPw = dPs + 16 * w * L::LDS;
  T* dSw = dSs + 16 * w * L::LDP;
  const long long row_base = (static_cast<long long>(b) * p.NH + h) * Sq;
  const unsigned long long head_rows =
      static_cast<unsigned long long>(row_base);
  const T* kb = head_base<T>(p.k, p.lk, b, h);
  const T* vb = head_base<T>(p.v, p.lv, b, h);
  load_tiles_tc<T, D>(Qs, head_base<T>(p.q, p.lq, b, h), p.lq.r, dOs,
                      head_base<T>(p.dout, p.ldo, b, h), p.ldo.r, q0, Sq,
                      vec);
  load_row_stats(lse_s, delta_s, p, row_base, q0, kTcThreads);
  AccFrag dq[L::NJ];
#pragma unroll
  for (int j = 0; j < L::NJ; ++j) wmma::fill_fragment(dq[j], 0.f);
  PhiloxCursor rng(p.seed);
  const int kend = key_end(p, q0);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_tiles_tc<T, D>(Ks, kb, p.lk.r, Vs, vb, p.lv.r, k0, Sk, vec);
    load_codes(codes, p, b, k0, kTcThreads);
    __syncthreads();
    warp_dots<T, D>(Qs + 16 * w * L::LDH, Ks, Sw);
    warp_dots<T, D>(dOs + 16 * w * L::LDH, Vs, dPw);
    __syncwarp();
    const float lse_q = lse_s[qr], delta_q = delta_s[qr];
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int c = 32 * side + j;
      const BwdElem e =
          bwd_elem(Sw[rr * L::LDS + c], dPw[rr * L::LDS + c], codes[c], qq,
                   k0 + c, lse_q, delta_q, p, rng, head_rows);
      dSw[rr * L::LDP + c] = from_f32<T>(e.ds);
    }
    __syncwarp();
    warp_accumulate<T, D>(dq, dSw, Ks);
  }
  warp_store_rows<T, D>(dq, Sw, head_base_out<T>(p.out, p.lo, b, h), p.lo.r,
                        q0 + 16 * w, Sq);
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

// parts: 1 the dK/dV kernel (p.out = dk, p.out2 = dv), 2 the dQ kernel
// (pq.out = dq). fp32: the CUDA-core kernels; T 16-bit: the tensor-core
// ones.
template <typename T, int D>
int bwd(const Params& p, const Params& pq, int parts, bool vec,
        cudaStream_t s) {
  constexpr bool tc = !std::is_same<T, float>::value;
  dim3 grid_k((p.Sk + BK - 1) / BK, p.NH, p.B);
  dim3 grid_q((p.Sq + BQ - 1) / BQ, p.NH, p.B);
  int err = 0;
  if (parts & 1) {
    if constexpr (tc)
      err = launch_kernel(flash_bwd_dkdv_tc_kernel<T, D>, dkdv_tc_smem<D>(),
                          grid_k, kTcThreads, s, p, vec);
    else
      err = launch_kernel(flash_bwd_dkdv_kernel<D>, dkdv_smem<D>(), grid_k,
                          kThreads, s, p);
    if (err != 0) return err;
  }
  if (parts & 2) {
    if constexpr (tc)
      err = launch_kernel(flash_bwd_dq_tc_kernel<T, D>, dq_tc_smem<D>(),
                          grid_q, kTcThreads, s, pq, vec);
    else
      err = launch_kernel(flash_bwd_dq_kernel<D>, dq_smem<D>(), grid_q,
                          kThreads, s, pq);
  }
  return err;
}

// fp32: the CUDA-core forward; 16-bit: the Hopper forward
// (csrc/flash_fwd_sm90.cu)
int dispatch_fwd(int D, const Params& p, int dtype, bool vec,
                 cudaStream_t s) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (dtype != 0) return flash::fwd_sm90(p, D, dtype, vec, s);
  dim3 grid((p.Sq + BQ - 1) / BQ, p.NH, p.B);
  switch (D) {
    case 32:
      return launch_kernel(flash_fwd_kernel<32>, fwd_smem<32>(), grid,
                           kThreads, s, p);
    case 64:
      return launch_kernel(flash_fwd_kernel<64>, fwd_smem<64>(), grid,
                           kThreads, s, p);
  }
  return launch_kernel(flash_fwd_kernel<128>, fwd_smem<128>(), grid,
                       kThreads, s, p);
}

template <typename T>
int bwd_for_d(int D, const Params& p, const Params& pq, int parts, bool vec,
              cudaStream_t s) {
  switch (D) {
    case 32: return bwd<T, 32>(p, pq, parts, vec, s);
    case 64: return bwd<T, 64>(p, pq, parts, vec, s);
    case 128: return bwd<T, 128>(p, pq, parts, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_bwd(int D, const Params& p, const Params& pq, int parts,
                 int dtype, bool vec, cudaStream_t s) {
  switch (dtype) {
    case 0: return bwd_for_d<float>(D, p, pq, parts, vec, s);
    case 1: return bwd_for_d<__nv_bfloat16>(D, p, pq, parts, vec, s);
    case 2: return bwd_for_d<__half>(D, p, pq, parts, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

Layout layout_at(const long long* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// 16-byte row loads need an aligned base and strides of whole 8-element
// (16-bit) chunks.
bool vec_ok(const void* ptr, const Layout& L) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && L.b % 8 == 0 &&
         L.h % 8 == 0 && L.r % 8 == 0;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* key_mask, int B, int Sq, int Sk, int NH,
                   float scale, int causal, int dropout, unsigned int seed,
                   unsigned int threshold, float inv_keep) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.key_mask = static_cast<const uint8_t*>(key_mask);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.NH = NH;
  p.scale = scale;
  p.causal = causal;
  p.skip = causal && key_mask == nullptr;
  p.dropout = dropout;
  p.seed = seed;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  return p;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (q, k, v, out). strides: 12
// element strides, (batch, head, row) of q, k, v and out, each a (B, NH,
// rows, D) operand whose D columns are contiguous. key_mask (B, Sk) uint8
// or null; lse (B, NH, Sq) fp32. D in {32, 64, 128}.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, void* lse,
                              const long long* strides, int B, int Sq, int Sk,
                              int NH, int D, int dtype, float scale,
                              int causal, int dropout, unsigned int seed,
                              unsigned int threshold, float inv_keep,
                              void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || NH < 1) return (int)cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, key_mask, B, Sq, Sk, NH, scale, causal,
                         dropout, seed, threshold, inv_keep);
  p.lq = layout_at(strides, 0);
  p.lk = layout_at(strides, 1);
  p.lv = layout_at(strides, 2);
  p.lo = layout_at(strides, 3);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  const bool vec = vec_ok(q, p.lq) && vec_ok(k, p.lk) && vec_ok(v, p.lv);
  return dispatch_fwd(D, p, dtype, vec, static_cast<cudaStream_t>(stream));
}

// The backward: dq (B, NH, Sq, D), dk, dv (B, NH, Sk, D) in the input
// dtype, from q, k, v, dout, the forward's lse and delta = rowsum(dout *
// out) - dlse per head (B, NH, Sq) fp32. strides: 21 element strides,
// (batch, head, row) of q, k, v, dout, dq, dk and dv. parts: 1 the dK/dV
// kernel, 2 the dQ kernel, 3 both.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* key_mask, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              void* dk, void* dv, const long long* strides,
                              int B, int Sq, int Sk, int NH, int D, int dtype,
                              float scale, int causal, int dropout,
                              unsigned int seed, unsigned int threshold,
                              float inv_keep, int parts, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || NH < 1) return (int)cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  if (parts < 1 || parts > 3) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, key_mask, B, Sq, Sk, NH, scale, causal,
                         dropout, seed, threshold, inv_keep);
  p.lq = layout_at(strides, 0);
  p.lk = layout_at(strides, 1);
  p.lv = layout_at(strides, 2);
  p.ldo = layout_at(strides, 3);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = dk;
  p.lo = layout_at(strides, 5);
  p.out2 = dv;
  p.lo2 = layout_at(strides, 6);
  Params pq = p;
  pq.out = dq;
  pq.lo = layout_at(strides, 4);
  pq.out2 = nullptr;
  const bool vec = vec_ok(q, p.lq) && vec_ok(k, p.lk) && vec_ok(v, p.lv) &&
                   vec_ok(dout, p.ldo);
  return dispatch_bwd(D, p, pq, parts, dtype, vec,
                      static_cast<cudaStream_t>(stream));
}
