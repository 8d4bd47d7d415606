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
// grid carries sums from step to step; here one forward and one two-kernel
// backward per input width (fp32 in this file; bf16 and fp16 in
// csrc/flash_fwd_sm90.cu and csrc/flash_bwd_sm90.cu) take any Sq, Sk and
// strides, so the five share one source of truth for the mask, the Philox
// numbering and the rounding. The wrappers count each call under the name
// of the TPU kernel it stands in for.
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
// modules are all read in place. The backward is two kernels, so that no
// sum needs atomics (deterministic): dK/dV walking the query tiles of a key
// tile, and dQ walking the key tiles of a query tile; each recomputes s and
// p from q, k and lse and replays the same mask.
//
// This file holds the entry points and the fp32 kernels. fp32 inputs run
// the products as fp32 FMAs on the CUDA cores (67 TFLOP/s peak), on 64 x 64
// score tiles from shared memory: 256 threads, thread (ty, tx) computing
// rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3 of a score tile in
// registers from tiles padded to D + 1 floats a row; the forward keeps an
// online softmax (running max and sum per row, the output accumulator
// rescaled per key tile), as JAX's tiled kernel does. The dK/dV kernel
// takes one block per 64-key tile, the dQ kernel one per 64-query tile
// (BQ, BK, query_start). The 16-bit inputs (bf16, the training path, and
// fp16) run on the tensor cores in the Hopper kernels: the forward in
// csrc/flash_fwd_sm90.cu (wgmma, TMA, one pass with an online softmax),
// the backward's dK/dV and dQ kernels in csrc/flash_bwd_sm90.cu (wgmma,
// TMA, p and dS formed in registers), with tile sizes of their own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
using flash::head_base;
using flash::head_base_out;
using flash::Layout;
using flash::Params;

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
// (pq.out = dq); fp32 only (16-bit: csrc/flash_bwd_sm90.cu).
template <int D>
int bwd(const Params& p, const Params& pq, int parts, cudaStream_t s) {
  dim3 grid_k((p.Sk + BK - 1) / BK, p.NH, p.B);
  dim3 grid_q((p.Sq + BQ - 1) / BQ, p.NH, p.B);
  int err = 0;
  if (parts & 1) {
    err = launch_kernel(flash_bwd_dkdv_kernel<D>, dkdv_smem<D>(), grid_k,
                        kThreads, s, p);
    if (err != 0) return err;
  }
  if (parts & 2)
    err = launch_kernel(flash_bwd_dq_kernel<D>, dq_smem<D>(), grid_q,
                        kThreads, s, pq);
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

// fp32: the CUDA-core kernels; 16-bit: the Hopper pair
// (csrc/flash_bwd_sm90.cu)
int dispatch_bwd(int D, const Params& p, const Params& pq, int parts,
                 int dtype, bool vec, cudaStream_t s) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (dtype != 0) return flash::bwd_sm90(p, pq, parts, D, dtype, vec, s);
  switch (D) {
    case 32: return bwd<32>(p, pq, parts, s);
    case 64: return bwd<64>(p, pq, parts, s);
  }
  return bwd<128>(p, pq, parts, s);
}

Layout layout_at(const long long* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// TMA (16-bit inputs) needs a 16-byte aligned base and strides of whole
// 16-byte chunks.
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
