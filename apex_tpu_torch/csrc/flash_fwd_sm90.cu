// The 16-bit flash attention forward for Hopper (sm_90a): bf16 and fp16
// q, k, v read by (batch, head, row) strides, the kernel behind the
// forward of apex_tpu/ops/flash_attention.py's _fwd_single_kernel_bsh
// (B4), _fwd_kernel (B9) and _fwd_single_kernel (B10) for 16-bit inputs.
// The fp32 kernels and the entry point flash_attn_fwd are in
// csrc/flash_attn.cu, the 16-bit backward in csrc/flash_bwd_sm90.cu, the
// PTX, wgmma and TMA pieces the two share in csrc/sm90_common.cuh.
// csrc/flash_attn.cu's header states the semantics this kernel keeps:
// the FILL mask, keys past Sk excluded, a fully masked row averaged over
// its Sk keys, lse = m + log(l) before dropout, the Philox keep bits of
// element ((b * NH + h) * Sq + q) * Sk + k, and p rounded to the input
// type before its product with V.
//
// What bounds it on the H100: at D 64 the special-function unit and the
// issue rate, not the tensor cores. GPT-2 small's causal shape (B 8, S
// 1024, NH 12, D 64) needs 12.9 GFLOP of products on 50 MB of inputs and
// outputs: 13 us at 989 TFLOP/s, 15 us at 3.35 TB/s. But every score also
// takes one exp2 on the SFU (16 a cycle an SM: as long as the score's 256
// FLOPs of products at D 64) and a dozen other instructions, and, with
// dropout, a quarter of a Philox4x32-10 call (about forty more).
//
// Design:
// - One pass over the keys with an online softmax, as JAX's tiled kernel
//   (B9): per row a running max m and sum l in registers, the output
//   accumulator rescaled by exp(m_old - m_new) for each key tile, and p
//   rounded against the running max (B4/B10's single-tile TPU kernels
//   round against the final max: bf16 results differ by rounding).
// - Persistent blocks, one an SM: a block walks work items (128 query
//   rows of one head: two consumer warpgroups of 64 rows) while one
//   producer warpgroup loads the next item's Q and key tiles as the
//   consumers finish the last, so an item's start and end overlap its
//   neighbours'. Registers move from the producer to the consumers
//   (setmaxnreg). Items are taken longest first (the last query tiles
//   under a causal mask), block c taking items c, c + #blocks, ...
// - The producer's one thread keeps 128-key K and V tiles in flight by TMA
//   (cp.async.bulk.tensor, 4-D maps over (D, rows, heads, batch) built on
//   the host from the strides, 128-byte swizzle, 64-byte at D 32) into a
//   ring of three stages (two at D 128), with mbarriers for full and empty
//   stages; Q arrives the same way once an item, into a buffer the
//   consumers release after their last Q K^T. Inputs TMA cannot describe
//   (a base or a stride off 16 bytes) are loaded by the producer's 128
//   threads element by element into the same swizzled layout.
// - S = Q K^T is wgmma.m64n128k16 with Q and K from shared memory (both
//   K-major); O += P V is wgmma.m64n{D}k16 with P from registers: the fp32
//   accumulator of S, converted to the input type, is the A operand in
//   place, and V (MN-major) is read with the transpose flag.
// - The two consumer warpgroups take turns to issue their products (named
//   barriers): a turn issues S of tile i and P V of tile i - 1, so one
//   warpgroup's softmax runs while the other's products do. The two are
//   committed apart: the warpgroup waits for S alone, forms the max and
//   the exponentials while its own P V runs on, and rescales O and packs
//   P once that is done. No wgmma sits under a branch (ptxas serialises
//   those): the first turn and the last are peeled off the loop.
// - The softmax runs on the accumulator in registers: a row's 128 scores
//   sit in the four lanes of a quad (two shuffles for its max and none for
//   its sum until the end); exp2 with log2(e) folded into the scale; the
//   mask and the Sk bound are applied only in tiles where they bite (a key
//   mask with a masked key in the tile, the last key tile, the causal
//   diagonal). Its branches are taken once a tile and the per-score work
//   is straight-line selects: a branch a score had cost more than the
//   score's arithmetic (the softmax ran 2.6x longer).
// - Dropout in registers: a thread's two columns of a row share a Philox
//   group of four with the neighbouring lane, so each lane computes the
//   group of one of its two rows and passes half of it by __shfl_xor.
//   When Sk % 4 != 0 a group may straddle two rows and every element draws
//   its own bits.

#include <math.h>

#include "philox.cuh"
#include "sm90_common.cuh"

namespace flash {
namespace {

constexpr int kBQ = 128;   // query rows a block: two warpgroups of 64
constexpr int kBK = 128;   // keys a tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);

template <int D>
struct Fwd {
  static_assert(kBQ == kBK, "Q and K/V tiles share one shape");
  using G = Geo<D, kBK>;
  static constexpr int kStages = D == 128 ? 2 : 3;  // K/V tiles in the ring
  // 1 KB to align the base (the swizzle repeats every 1024 bytes), Q, the
  // K and V rings, the mbarriers
  static constexpr size_t kSmem =
      1024 + (1 + 2 * kStages) * G::kTileBytes + 128;
};

// The consumers' turns to issue products: warpgroup w waits on barrier
// 2 + w and, once its products are issued, hands the turn to the other.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory");
}

// What a consumer thread knows of its rows: qa and qb = qa + 8, its two
// columns of each 8-key block (2 quad, 2 quad + 1; the wgmma accumulator
// layout), the key mask row, and the rows' Philox element offsets.
struct Rows {
  int qa, qb, quad, lane, warp_lo;
  const uint8_t* kmask;
  unsigned long long ia, ib;
};

// Each row's running max m and sum l (l is this thread's share of the
// row until the end).
struct Stats {
  float m_a, m_b, l_a, l_b;
};

// From a tile's raw scores s (keys k0 ..): the mask where it can bite, the
// online max and sum, and p = exp(s - m) with dropout, in s. Touches
// neither O nor P, so it runs while the last tile's P V is in flight;
// returns the rows' rescale factors for rescale_pack.
template <typename T, int D>
__device__ __forceinline__ float2 softmax_tile(float (&s)[kBK / 2],
                                               Stats& st, const Rows& r,
                                               const Params& p, int k0) {
  const int Sk = p.Sk, quad = r.quad;
  const float scale = p.scale;
  // Every branch below is uniform across the warp and taken once a tile;
  // the per-score work is straight-line selects (a branch a score costs
  // more than the score's arithmetic).
  bool masked = k0 + kBK > Sk || (p.causal && k0 + kBK - 1 > r.warp_lo) ||
                !(scale > 0.f);
  // bit 2 j + c: the key mask of column 8 j + 2 quad + c of this tile
  uint32_t colmask = 0;
  if (r.kmask != nullptr) {
    // lane l reads keys k0 + 4 l .. + 3, a byte each
    uint32_t mword = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = k0 + 4 * r.lane + e;
      const uint32_t hit = c < Sk ? r.kmask[c] != 0 : 0u;
      mword |= hit << (8 * e);
    }
    if (__any_sync(0xffffffffu, mword != 0)) {
      masked = true;
      const int sh = 16 * (quad & 1);  // the quad's two bytes of a word
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint32_t mw =
            __shfl_sync(0xffffffffu, mword, 2 * j + quad / 2);
        colmask |= (((mw >> sh) & 1u) | (((mw >> (sh + 8)) & 1u) << 1))
                   << (2 * j);
      }
    }
  }
  // row maxes and sums over four partials each (shorter dependency
  // chains); partial c takes the 8-key blocks j = c mod 4
  float mx_a[4], mx_b[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mx_a[c] = mx_b[c] = -INFINITY;
  if (masked) {
    const bool causal = p.causal;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * quad + (e & 1);
        const int row = (e & 2) ? r.qb : r.qa;
        const bool dead =
            ((colmask >> (2 * j + (e & 1))) & 1u) | (causal & (col > row));
        float v = dead ? FILL : s[4 * j + e] * scale;
        v = col < Sk ? v : -INFINITY;
        s[4 * j + e] = v;
        if (e & 2)
          mx_b[j % 4] = fmaxf(mx_b[j % 4], v);
        else
          mx_a[j % 4] = fmaxf(mx_a[j % 4], v);
      }
    }
  } else {
#pragma unroll
    for (int idx = 0; idx < kBK / 2; ++idx) {
      const int c = (idx / 4) % 4;
      if (idx & 2)
        mx_b[c] = fmaxf(mx_b[c], s[idx]);
      else
        mx_a[c] = fmaxf(mx_a[c], s[idx]);
    }
  }
  float mxa = fmaxf(fmaxf(mx_a[0], mx_a[1]), fmaxf(mx_a[2], mx_a[3]));
  float mxb = fmaxf(fmaxf(mx_b[0], mx_b[1]), fmaxf(mx_b[2], mx_b[3]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
  }
  if (!masked) {  // the max of the raw dots, scaled (scale > 0)
    mxa *= scale;
    mxb *= scale;
  }
  const float mn_a = fmaxf(st.m_a, mxa), mn_b = fmaxf(st.m_b, mxb);
  const float alpha_a = ex2((st.m_a - mn_a) * kLog2e);
  const float alpha_b = ex2((st.m_b - mn_b) * kLog2e);
  // rounded apart, so that a score equal to the max gives exactly 1
  const float ml_a = __fmul_rn(mn_a, kLog2e);
  const float ml_b = __fmul_rn(mn_b, kLog2e);
  float sm_a[4] = {0.f, 0.f, 0.f, 0.f}, sm_b[4] = {0.f, 0.f, 0.f, 0.f};
  if (masked) {
#pragma unroll
    for (int idx = 0; idx < kBK / 2; ++idx) {
      const float e =
          ex2(__fmul_rn(s[idx], kLog2e) - ((idx & 2) ? ml_b : ml_a));
      s[idx] = e;
      if (idx & 2)
        sm_b[(idx / 4) % 4] += e;
      else
        sm_a[(idx / 4) % 4] += e;
    }
  } else {
    const float sl2 = scale * kLog2e;
#pragma unroll
    for (int idx = 0; idx < kBK / 2; ++idx) {
      const float e = ex2(fmaf(s[idx], sl2, (idx & 2) ? -ml_b : -ml_a));
      s[idx] = e;
      if (idx & 2)
        sm_b[(idx / 4) % 4] += e;
      else
        sm_a[(idx / 4) % 4] += e;
    }
  }
  const float sum_a = (sm_a[0] + sm_a[1]) + (sm_a[2] + sm_a[3]);
  const float sum_b = (sm_b[0] + sm_b[1]) + (sm_b[2] + sm_b[3]);
  st.l_a = st.l_a * alpha_a + sum_a;
  st.l_b = st.l_b * alpha_b + sum_b;
  st.m_a = mn_a;
  st.m_b = mn_b;

  // dropout on p (l stays pre-dropout)
  if (p.dropout) {
    if (Sk % 4 == 0) {
      // the pair of lanes (2c, 2c + 1) of a quad covers one group of four
      // columns of rows qa and qb: the even lane draws qa's group, the odd
      // lane qb's, and each passes the other half
      const bool odd = r.lane & 1;
      const unsigned long long mine = odd ? r.ib : r.ia;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint4 w = philox4x32_10(
            (mine + k0 + 8 * j + 4 * (quad >> 1)) >> 2, p.seed);
        const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        const uint32_t bits[4] = {odd ? got0 : w.x, odd ? got1 : w.y,
                                  odd ? w.z : got0, odd ? w.w : got1};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] =
              bits[e] < p.threshold ? s[4 * j + e] * p.inv_keep : 0.f;
      }
    } else {  // a group may straddle two rows: bits element by element
      PhiloxCursor ca(p.seed), cb(p.seed);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * quad + (e & 1);
          const uint32_t bits =
              (e & 2) ? cb.bits(r.ib + col) : ca.bits(r.ia + col);
          s[4 * j + e] = bits < p.threshold ? s[4 * j + e] * p.inv_keep : 0.f;
        }
      }
    }
  }

  return make_float2(alpha_a, alpha_b);
}

// Once the last P V is done: O rescaled by the rows' factors, and P (p of
// this tile, in s) in the input type in pa, the A operand of the next
// P V.
template <typename T, int D>
__device__ __forceinline__ void rescale_pack(const float (&s)[kBK / 2],
                                             float (&o)[D / 2],
                                             uint32_t (&pa)[kBK / 4],
                                             float2 alpha) {
#pragma unroll
  for (int idx = 0; idx < D / 2; ++idx)
    o[idx] *= (idx & 2) ? alpha.y : alpha.x;
  pack_a<T, kBK>(s, pa);
}

// A work item: query rows [q0, q0 + kBQ) of head h of batch row b, and
// the key tiles they visit. Item w takes query tile nq - 1 - w / (NH B),
// so the longest causal rows go first.
struct Work {
  int q0, h, b, ntiles;
};

__device__ __forceinline__ Work work_item(int w, const Params& p) {
  const int nq = (p.Sq + kBQ - 1) / kBQ, heads = p.NH * p.B;
  Work k;
  k.q0 = (nq - 1 - w / heads) * kBQ;
  k.h = (w % heads) % p.NH;
  k.b = (w % heads) / p.NH;
  const int kend = p.skip ? min(p.Sk, k.q0 + kBQ) : p.Sk;
  k.ntiles = (kend + kBK - 1) / kBK;
  return k;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const Params p, int tma, int out_vec) {
  using G = typename Fwd<D>::G;
  constexpr int kStages = Fwd<D>::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sQ = raw + pad;
  const uint32_t sK = sQ + G::kTileBytes;  // stage st at + st * kTileBytes
  const uint32_t sV = sK + kStages * G::kTileBytes;
  // mbarriers: Q full, Q consumed; K full and V full per stage; stage
  // consumed
  const uint32_t bar_q = sV + kStages * G::kTileBytes;
  const uint32_t bar_qe = bar_q + 8;
  const uint32_t bar_k = bar_qe + 8, bar_v = bar_k + 8 * kStages;
  const uint32_t bar_e = bar_v + 8 * kStages;
  // the block walks items blockIdx.x, + gridDim.x, ...; the ring's stage
  // and phase follow the block's running count of key tiles
  const int nwork = ((p.Sq + kBQ - 1) / kBQ) * p.NH * p.B;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 4 * kConsumers);  // one arrival a consumer warp
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // -- producer: each item's Q, then its K and V tiles into the ring ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int t = threadIdx.x - 128 * kConsumers;
    if (tma && t != 0) return;  // one thread issues every copy
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
      const Work wk = work_item(w, p);
      mbar_wait(bar_qe, (n & 1) ^ 1);  // the last item's Q is consumed
      if (tma) {
        mbar_expect_tx(bar_q, G::kTileBytes);
        for (int sl = 0; sl < G::kSlabs; ++sl)
          tma_load(sQ + sl * G::kSlabBytes, &qmap, bar_q, sl * G::kSlabCols,
                   wk.q0, wk.h, wk.b);
      } else {
        load_tile_elems<T, D, kBK>(
            base, static_cast<const T*>(p.q) + wk.b * p.lq.b + wk.h * p.lq.h,
            p.lq.r, wk.q0, p.Sq, t);
        fence_proxy_async();
        producer_sync();
        if (t == 0) mbar_arrive(bar_q);
      }
      for (int i = 0; i < wk.ntiles; ++i, ++tile) {
        const int st = tile % kStages;
        const uint32_t fk = bar_k + 8 * st, fv = bar_v + 8 * st;
        mbar_wait(bar_e + 8 * st, ((tile / kStages) & 1) ^ 1);
        if (tma) {
          mbar_expect_tx(fk, G::kTileBytes);
          for (int sl = 0; sl < G::kSlabs; ++sl)
            tma_load(sK + st * G::kTileBytes + sl * G::kSlabBytes, &kmap, fk,
                     sl * G::kSlabCols, i * kBK, wk.h, wk.b);
          mbar_expect_tx(fv, G::kTileBytes);
          for (int sl = 0; sl < G::kSlabs; ++sl)
            tma_load(sV + st * G::kTileBytes + sl * G::kSlabBytes, &vmap, fv,
                     sl * G::kSlabCols, i * kBK, wk.h, wk.b);
        } else {
          load_tile_elems<T, D, kBK>(
              base + (1 + st) * G::kTileBytes,
              static_cast<const T*>(p.k) + wk.b * p.lk.b + wk.h * p.lk.h,
              p.lk.r, i * kBK, p.Sk, t);
          fence_proxy_async();
          producer_sync();
          if (t == 0) mbar_arrive(fk);
          load_tile_elems<T, D, kBK>(
              base + (1 + kStages + st) * G::kTileBytes,
              static_cast<const T*>(p.v) + wk.b * p.lv.b + wk.h * p.lv.h,
              p.lv.r, i * kBK, p.Sk, t);
          fence_proxy_async();
          producer_sync();
          if (t == 0) mbar_arrive(fv);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows of each item a warpgroup -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const uint32_t sQw = sQ + 64 * wg * G::kRowBytes;
    float o[D / 2];
    float s[kBK / 2];
    uint32_t pa[kBK / 4];  // P of the last tile, the A operand of P V
    // Turn i issues S = Q K^T of tile i and O += P V of tile i - 1 (no
    // product under a branch: ptxas serialises those), then forms P of
    // tile i while the other warpgroup issues its turn. Both warpgroups
    // take ntiles + 1 turns an item.
    if (wg == 1) turn_pass(1);  // warpgroup 0 issues first
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
      const Work wk = work_item(w, p);
      const int q0 = wk.q0, h = wk.h, b = wk.b, ntiles = wk.ntiles;
      Rows r;
      r.quad = quad;
      r.lane = lane;
      r.warp_lo = q0 + 64 * wg + 16 * warp;
      r.qa = r.warp_lo + lane / 4;
      r.qb = r.qa + 8;
      r.kmask = p.key_mask ? p.key_mask + static_cast<long long>(b) * p.Sk
                           : nullptr;
      const unsigned long long head_rows =
          static_cast<unsigned long long>(b * p.NH + h) * p.Sq;
      r.ia = (head_rows + r.qa) * p.Sk;
      r.ib = (head_rows + r.qb) * p.Sk;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      Stats stt{-INFINITY, -INFINITY, 0.f, 0.f};
      mbar_wait(bar_q, n & 1);
      {
        const int st = tile % kStages;
        mbar_wait(bar_k + 8 * st, (tile / kStages) & 1);
        turn_wait(wg);
        wgmma_fence();
        issue_ss<T, D, kBK, kBQ, kBK>(s, sQw, sK + st * G::kTileBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(s);
        if (ntiles == 1) {  // Q is consumed
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_qe);
        }
        rescale_pack<T, D>(s, o, pa, softmax_tile<T, D>(s, stt, r, p, 0));
      }
      for (int i = 1; i < ntiles; ++i) {
        const int ti = tile + i;
        const int st = ti % kStages;
        const int sp = (ti - 1) % kStages;
        mbar_wait(bar_k + 8 * st, (ti / kStages) & 1);
        mbar_wait(bar_v + 8 * sp, ((ti - 1) / kStages) & 1);
        turn_wait(wg);
        fence_regs(o);
        wgmma_fence();
        issue_ss<T, D, kBK, kBQ, kBK>(s, sQw, sK + st * G::kTileBytes);
        wgmma_commit();
        issue_rs<T, D, kBK, kBK>(o, pa, sV + sp * G::kTileBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();  // S of tile i; P V of tile i - 1 runs on
        fence_regs(s);
        if (i == ntiles - 1) {  // Q is consumed
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_qe);
        }
        const float2 alpha = softmax_tile<T, D>(s, stt, r, p, i * kBK);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * sp);  // tile i - 1 consumed
        rescale_pack<T, D>(s, o, pa, alpha);
      }
      {
        const int ti = tile + ntiles - 1;
        const int sp = ti % kStages;
        mbar_wait(bar_v + 8 * sp, (ti / kStages) & 1);
        turn_wait(wg);
        fence_regs(o);
        wgmma_fence();
        issue_rs<T, D, kBK, kBK>(o, pa, sV + sp * G::kTileBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * sp);  // the last tile too
      }
      tile += ntiles;

      // out = O / l in the input type, lse = m + log(l)
      float l_a = stt.l_a, l_b = stt.l_b;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const float safe_a = l_a > 0.f ? l_a : 1.f;
      const float safe_b = l_b > 0.f ? l_b : 1.f;
      T* ob = static_cast<T*>(p.out) + b * p.lo.b + h * p.lo.h;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int q = hb ? r.qb : r.qa;
        if (q < p.Sq) {
          const float inv = 1.f / (hb ? safe_b : safe_a);
          T* row = ob + q * p.lo.r + 2 * quad;
          if (out_vec) {
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              *reinterpret_cast<uint32_t*>(row + 8 * j) = pack2<T>(
                  o[4 * j + 2 * hb] * inv, o[4 * j + 2 * hb + 1] * inv);
          } else {
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
              row[8 * j] = from_f32<T>(o[4 * j + 2 * hb] * inv);
              row[8 * j + 1] = from_f32<T>(o[4 * j + 2 * hb + 1] * inv);
            }
          }
          if (quad == 0)
            p.lse_out[head_rows + q] =
                (hb ? stt.m_b : stt.m_a) + logf(hb ? safe_b : safe_a);
        }
      }
    }
    if (wg == 0) turn_wait(0);  // take warpgroup 1's last pass
  }
}

// -- host ---------------------------------------------------------------------

template <typename T, int D>
int launch(const Params& p, bool vec, int dtype, cudaStream_t s) {
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const bool tma =
      vec && make_map<D>(&maps[0], p.q, p.lq, p.Sq, p.NH, p.B, dtype, kBK) &&
      make_map<D>(&maps[1], p.k, p.lk, p.Sk, p.NH, p.B, dtype, kBK) &&
      make_map<D>(&maps[2], p.v, p.lv, p.Sk, p.NH, p.B, dtype, kBK);
  const bool out_vec = pairs_ok(p.out, p.lo);
  auto kernel = flash_fwd_sm90_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Fwd<D>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one block an SM, each walking its share of the items
  const int sms = sm_count();
  const long long items =
      static_cast<long long>((p.Sq + kBQ - 1) / kBQ) * p.NH * p.B;
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, kThreads, Fwd<D>::kSmem, s>>>(
      maps[0], maps[1], maps[2], p, tma ? 1 : 0, out_vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_d(const Params& p, int D, bool vec, int dtype,
                 cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, vec, dtype, s);
    case 64: return launch<T, 64>(p, vec, dtype, s);
    case 128: return launch<T, 128>(p, vec, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int fwd_sm90(const Params& p, int D, int dtype, bool vec, cudaStream_t s) {
  if (dtype == 1) return launch_for_d<__nv_bfloat16>(p, D, vec, dtype, s);
  if (dtype == 2) return launch_for_d<__half>(p, D, vec, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
