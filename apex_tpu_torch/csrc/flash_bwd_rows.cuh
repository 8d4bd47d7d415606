// The per-thread row bookkeeping that the flash backward kernels share:
// csrc/flash_bwd_sm90.cu (bf16/fp16, wgmma) and csrc/flash_bwd_f32.cu (fp32,
// mma.sync), and with them the fp32 forward (csrc/flash_fwd_f32.cu, the
// dQ kernels' half). All keep their score tiles in the same register
// layout: a warp owns 16 rows, a thread rows lane / 4 and lane / 4 + 8, and
// element 4 j + e of a tile of N columns is column 8 j + 2 (lane % 4) + (e
// & 1) of row half e / 2 (the m16n8 accumulator of mma.sync, which wgmma's
// m64nN accumulator repeats per warp). The dK/dV kernels hold S^T (keys
// along the rows, queries along the columns), the dQ kernels and the
// forward S (queries along the rows). Here: the masked scores and
// exponentials of a tile and its Philox keep bits in that layout.
#pragma once

#include <math.h>
#include <stdint.h>

#include "philox.cuh"
#include "sm90_common.cuh"

namespace flash {
namespace {

// y[m] = x[m ^ i] for a lane-dependent i in 0 .. 3, by selects.
__device__ __forceinline__ void xor_perm(uint32_t (&x)[4], int i) {
  const bool s1 = i & 1, s2 = i & 2;
  const uint32_t a0 = s1 ? x[1] : x[0], a1 = s1 ? x[0] : x[1];
  const uint32_t a2 = s1 ? x[3] : x[2], a3 = s1 ? x[2] : x[3];
  x[0] = s2 ? a2 : a0;
  x[1] = s2 ? a3 : a1;
  x[2] = s2 ? a0 : a2;
  x[3] = s2 ? a1 : a3;
}

// -- the dK/dV kernels: S^T, keys along the rows ---------------------------

// What a dK/dV thread knows of its keys: the accumulator rows
// ka and kb = ka + 8 (queries run along the columns 8 j + 2 quad + {0, 1}),
// their key mask, the warp's highest key, and for the Philox groups the
// first key kg of the four lanes that share them (ka = kg + i4) and the
// head's first row of the element numbering.
struct KeyRows {
  int ka, kb, kg, i4, quad, warp_hi;
  bool dead_a, dead_b, any_dead;
  unsigned long long head_rows;
};

// p^T = exp(s - lse) of one tile from its raw dots (in s), queries q0 ..;
// the mask only where it can bite (kMasked).
template <int N, bool kMasked>
__device__ __forceinline__ void probs_t(float (&s)[N / 2], const KeyRows& r,
                                        const float* lse, int q0,
                                        const Params& p) {
  const float scale = p.scale;
  const bool causal = p.causal != 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l =
        *reinterpret_cast<const float2*>(lse + 8 * j + 2 * r.quad);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * j + e] * scale;
      if constexpr (kMasked) {
        const int col = q0 + 8 * j + 2 * r.quad + (e & 1);
        const int key = (e & 2) ? r.kb : r.ka;
        const bool dead =
            ((e & 2) ? r.dead_b : r.dead_a) | (causal & (key > col));
        v = dead ? FILL : v;
      }
      s[4 * j + e] = ex2((v - ((e & 1) ? l.y : l.x)) * kLog2e);
    }
  }
}

// The keep bits of one tile (bit 4 j + e: accumulator element 4 j + e).
template <int N>
__device__ __forceinline__ uint64_t keep_t(const KeyRows& r, int q0,
                                           const Params& p) {
  const unsigned long long Sk = static_cast<unsigned long long>(p.Sk);
  uint64_t km = 0;
  if (p.Sk % 4 == 0) {
    // The four lanes i4 = 0 .. 3 (same quad) hold keys kg + i4 (+ 8) of the
    // same queries: each group of four keys is one Philox call whose word
    // i4 lane i4 needs. In round t the lanes draw the groups of columns n0
    // + i4 of one row half and exchange: lane i4 sends word i4 ^ d of its
    // group to lane i4 ^ d.
    constexpr int kRounds = N / 8, kHalf = kRounds / 2;
#pragma unroll
    for (int t = 0; t < kRounds; ++t) {
      const int h = t / kHalf, n0 = 4 * (t % kHalf);
      const int n = n0 + r.i4;
      const int col = q0 + 8 * (n >> 1) + 2 * r.quad + (n & 1);
      const uint4 w = philox4x32_10(
          ((r.head_rows + col) * Sk + r.kg + 8 * h) >> 2, p.seed);
      uint32_t u[4] = {w.x, w.y, w.z, w.w};
      xor_perm(u, r.i4);
      uint32_t v[4] = {u[0], __shfl_xor_sync(0xffffffffu, u[1], 4),
                       __shfl_xor_sync(0xffffffffu, u[2], 8),
                       __shfl_xor_sync(0xffffffffu, u[3], 12)};
      xor_perm(v, r.i4);  // v[m]: this lane's word of column n0 + m
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int nn = n0 + m;
        const int idx = 4 * (nn >> 1) + 2 * h + (nn & 1);
        km |= static_cast<uint64_t>(v[m] < p.threshold) << idx;
      }
    }
  } else {  // a group may straddle two queries: bits score by score
#pragma unroll
    for (int idx = 0; idx < N / 2; ++idx) {
      const int col = q0 + 8 * (idx / 4) + 2 * r.quad + (idx & 1);
      const unsigned long long e =
          (r.head_rows + col) * Sk + ((idx & 2) ? r.kb : r.ka);
      const uint32_t bits =
          philox_word(philox4x32_10(e >> 2, p.seed), static_cast<int>(e & 3));
      km |= static_cast<uint64_t>(bits < p.threshold) << idx;
    }
  }
  return km;
}

// -- the dQ kernels: S, queries along the rows -------------------------------

// What a dQ thread (or an fp32 forward thread) knows of its rows: queries
// qa and qb = qa + 8 (keys run along the columns), their lse and delta
// (the backward's), the warp's lowest query, the rows' Philox element
// offsets, and the key mask row.
struct QueryRows {
  int qa, qb, quad, lane, warp_lo;
  float lse_a, lse_b, delta_a, delta_b;
  unsigned long long ia, ib;
  const uint8_t* kmask;
};

// The key mask of the tile's keys k0 ..: bit 2 j + c for column 8 j + 2
// quad + c; any is set when a key of the tile is masked.
template <int N>
__device__ __forceinline__ uint32_t col_mask(const QueryRows& r, int k0,
                                             int Sk, bool& any) {
  static_assert(N >= 64, "a column pair's two keys sit in one lane");
  constexpr int kPer = N / 32;  // keys a lane reads, a byte each
  uint32_t mword = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int c = k0 + kPer * r.lane + e;
    const uint32_t hit = c < Sk ? r.kmask[c] != 0 : 0u;
    mword |= hit << (8 * e);
  }
  any = __any_sync(0xffffffffu, mword != 0);
  uint32_t colmask = 0;
  if (any) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * r.quad;  // even: both bytes in one lane
      const uint32_t mw = __shfl_sync(0xffffffffu, mword, c / kPer);
      const int sh = 8 * (c % kPer);
      colmask |= (((mw >> sh) & 1u) | (((mw >> (sh + 8)) & 1u) << 1))
                 << (2 * j);
    }
  }
  return colmask;
}

// The scores of one tile from its raw dots (in s), keys k0 ..: scaled,
// FILL where the key is masked (colmask) or, when causal, above the
// diagonal, -inf past Sk; the mask and the Sk bound only where they can
// bite (kMasked). The fp32 forward and every dQ kernel take their mask
// from here.
template <int N, bool kMasked>
__device__ __forceinline__ void scores_q(float (&s)[N / 2],
                                         const QueryRows& r, int k0,
                                         uint32_t colmask, const Params& p) {
  const float scale = p.scale;
  const bool causal = p.causal != 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * j + e] * scale;
      if constexpr (kMasked) {
        const int col = k0 + 8 * j + 2 * r.quad + (e & 1);
        const int row = (e & 2) ? r.qb : r.qa;
        const bool dead =
            ((colmask >> (2 * j + (e & 1))) & 1u) | (causal & (col > row));
        v = dead ? FILL : v;
        v = col < p.Sk ? v : -INFINITY;
      }
      s[4 * j + e] = v;
    }
  }
}

// p = exp(s - lse) of one tile from its raw dots (in s), keys k0 ..; the
// mask as scores_q.
template <int N, bool kMasked>
__device__ __forceinline__ void probs_q(float (&s)[N / 2], const QueryRows& r,
                                        int k0, uint32_t colmask,
                                        const Params& p) {
  scores_q<N, kMasked>(s, r, k0, colmask, p);
#pragma unroll
  for (int idx = 0; idx < N / 2; ++idx)
    s[idx] = ex2((s[idx] - ((idx & 2) ? r.lse_b : r.lse_a)) * kLog2e);
}

// The keep bits of one tile (bit 4 j + e: accumulator element 4 j + e),
// drawn as the forward draws them.
template <int N>
__device__ __forceinline__ uint64_t keep_q(const QueryRows& r, int k0,
                                           const Params& p) {
  uint64_t km = 0;
  if (p.Sk % 4 == 0) {
    // the pair of lanes (2c, 2c + 1) of a quad covers one group of four
    // columns of rows qa and qb: the even lane draws qa's group, the odd
    // lane qb's, and each passes the other half
    const bool odd = r.lane & 1;
    const unsigned long long mine = odd ? r.ib : r.ia;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint4 w =
          philox4x32_10((mine + k0 + 8 * j + 4 * (r.quad >> 1)) >> 2, p.seed);
      const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
      const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
      const uint32_t bits[4] = {odd ? got0 : w.x, odd ? got1 : w.y,
                                odd ? w.z : got0, odd ? w.w : got1};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        km |= static_cast<uint64_t>(bits[e] < p.threshold) << (4 * j + e);
    }
  } else {  // a group may straddle two rows: bits element by element
    PhiloxCursor ca(p.seed), cb(p.seed);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * r.quad + (e & 1);
        const uint32_t bits =
            (e & 2) ? cb.bits(r.ib + col) : ca.bits(r.ia + col);
        km |= static_cast<uint64_t>(bits < p.threshold) << (4 * j + e);
      }
    }
  }
  return km;
}

}  // namespace
}  // namespace flash
