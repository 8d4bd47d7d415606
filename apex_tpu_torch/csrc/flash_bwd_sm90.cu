// The 16-bit flash attention backward for Hopper (sm_90a): bf16 and fp16
// q, k, v, dout read by (batch, head, row) strides, dq, dk, dv written by
// strides into the caller's layout. It stands in for the backward kernels
// of apex_tpu/ops/flash_attention.py on 16-bit inputs:
//   _bwd_fused_kernel_bsh (B5, BERT-large at S 512, flat (B, S, NH * D));
//   _bwd_dq_kernel (B11a) and _bwd_dkv_kernel (B11b), the tiled backward
//     (GPT-2 small at S 1024, causal);
//   _bwd_fused_kernel (B12), the single-tile backward (contrib
//     multihead_attn, sequence-first (T, B, NH, D) views).
// csrc/flash_attn.cu holds the entry point flash_attn_bwd, which sends
// 16-bit inputs here, the fp32 kernels, and the header that states the
// semantics kept: s = q.k * scale, or FILL for a masked key or, when
// causal, k > q; p = exp(s - lse) from the forward's lse; the Philox keep
// bits of element ((b * NH + h) * Sq + q) * Sk + k scaled by 1 / (1 -
// rate); dp = dO.v masked and scaled alike; ds = p (dp - delta) scale for
// masked keys too; p and ds rounded to the input type before their
// products, dK, dV and dQ summed in fp32 and rounded once; no tile is
// skipped under a key mask, so a fully masked row is averaged over all Sk
// keys.
//
// What bounds it on the H100: the CUDA cores and latency, not the tensor
// cores or the memory. GPT-2 small's causal shape (B 8, S 1024, NH 12,
// D 64) needs 7 products of 2 D FLOPs per live score across the two
// kernels (45 GFLOP: 46 us at 989 TFLOP/s) and moves at least 89 MB (27
// us at 3.35 TB/s); each live score also takes two exp2 (one a kernel),
// a few dozen other instructions and, with dropout, two shares of a
// Philox4x32-10 call. On an H100 SXM (700 W) the pair takes ~0.18 ms
// there without dropout, one tile's chain of products, exponentials and
// products with two consumer warpgroups in flight an SM, and ~0.36 ms at
// rate 0.1, where each kernel's Philox replay is half its time.
//
// Design. Two kernels, so that every sum is taken in a fixed order by one
// thread's registers and no atomics are needed (the results are the same
// bit for bit from run to run); each recomputes s and p from q, k and the
// forward's lse. Both have the shape of the forward (csrc/flash_fwd_sm90.cu):
// - persistent blocks, one an SM, walking work items longest first; one
//   producer warpgroup (its registers given to the consumers by setmaxnreg)
//   and two consumer warpgroups of 64 rows each;
// - the producer's one thread streams tiles by TMA (4-D maps over (D, rows,
//   heads, batch) built from the strides, so the flat bsh layout, (B, NH,
//   S, D) and the sequence-first views are read in place; zeros past the
//   end of a head) into a ring of stages with mbarriers for full and empty
//   stages; inputs TMA cannot describe (a base or stride off 16 bytes) are
//   loaded by the producer's 128 threads element by element into the same
//   swizzled layout;
// - the products are wgmma: the two score-like products from shared memory
//   (both operands K-major), the gradient products with the A operand from
//   registers (the fp32 accumulator of p or ds rounded in place) and B
//   MN-major with the transpose flag. The mask, the exponentials and
//   dropout run on the accumulators in registers; mask branches are taken
//   once a tile (where the mask can bite) and the per-score work is
//   straight-line selects.
// Kernel 1, dK and dV (B11b; the dK/dV half of B5 and B12): an item is 128
// keys of one head, K and V resident in shared memory; the consumers own
// 64 keys each and walk the query tiles (64 rows, 32 at D 128 for
// registers: dK and dV then take 128 of them), whose Q, dO, lse and delta
// stream through a ring of four stages. S^T = K Q^T and dP^T = V dO^T;
// P^T and dS^T in registers; dV += P^T dO, dK += dS^T Q. Under the causal
// tile skip the walk starts at the first query tile that reaches the keys.
// In the transposed accumulator four consecutive keys (one Philox group)
// lie in four lanes: each lane draws a quarter of the groups its four
// lanes need and the words are exchanged by three shuffles; with Sk % 4 !=
// 0 a group may straddle two queries and each score draws its own bits.
// Kernel 2, dQ (B11a; the dQ half of B5 and B12): an item is 128 queries
// of one head, Q, dO and the rows' lse and delta resident; K and V tiles
// (128 keys, 64 at D 128) stream through a ring of three stages. S = Q
// K^T and dP = dO V^T; dS in registers; dQ += dS K. Under the causal tile
// skip the walk stops at the last key tile the queries reach. Dropout bits
// are shared by lane pairs, as in the forward.

#include <math.h>

#include "philox.cuh"
#include "sm90_common.cuh"

namespace flash {
namespace {

constexpr int kRes = 128;  // resident rows an item: 64 a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);

template <int D>
struct Dkdv {  // kernel 1: query rows a streamed tile, stages, shared memory
  static constexpr int kN = D == 128 ? 32 : 64;
  static constexpr int kStages = 4;
  static constexpr int kStatsOff =
      2 * Geo<D, kRes>::kTileBytes + 2 * kStages * Geo<D, kN>::kTileBytes;
  // 1 KB to align the base, K, V, the Q and dO rings, lse and delta of
  // each stage, the mbarriers
  static constexpr size_t kSmem =
      1024 + kStatsOff + 2 * kStages * kN * 4 + 8 * (2 + 2 * kStages);
};

template <int D>
struct Dq {  // kernel 2: keys a streamed tile, stages, shared memory
  static constexpr int kN = D == 128 ? 64 : 128;
  static constexpr int kStages = 3;
  static constexpr size_t kSmem = 1024 + 2 * Geo<D, kRes>::kTileBytes +
                                  2 * kStages * Geo<D, kN>::kTileBytes +
                                  8 * (2 + 2 * kStages);
};

// Write an fp32 accumulator (64 x D, the wgmma layout) of rows ra and
// ra + 8 (rows >= n skipped) into a head of the output by its row stride:
// pairs of columns as one 4-byte store where vec, else element by element.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* head, long long rs,
                                           const float (&o)[D / 2], int ra,
                                           int n, int quad, bool vec) {
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int r = ra + 8 * hb;
    if (r >= n) continue;
    T* row = head + r * rs + 2 * quad;
    if (vec) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack2<T>(o[4 * j + 2 * hb], o[4 * j + 2 * hb + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        row[8 * j] = from_f32<T>(o[4 * j + 2 * hb]);
        row[8 * j + 1] = from_f32<T>(o[4 * j + 2 * hb + 1]);
      }
    }
  }
}

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

// -- kernel 1: dK and dV ------------------------------------------------------

// An item of kernel 1: keys [k0, k0 + 128) of head h of batch row b, and
// the query tiles of N rows it visits from q0.
struct KeyItem {
  int k0, h, b, q0, ntiles;
};

__device__ __forceinline__ KeyItem key_item(int w, const Params& p, int N) {
  const int heads = p.NH * p.B;
  KeyItem it;
  it.k0 = (w / heads) * kRes;  // the longest walks (under the skip) first
  it.h = (w % heads) % p.NH;
  it.b = (w % heads) / p.NH;
  it.q0 = p.skip ? (it.k0 / N) * N : 0;
  it.ntiles = it.q0 < p.Sq ? (p.Sq - it.q0 + N - 1) / N : 0;
  return it;
}

// What a kernel-1 consumer thread knows of its keys: the accumulator rows
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

// From p^T (in s) and the raw dP^T (in dp): the dropped p^T that feeds dV
// and dS^T = p^T (dp^T - delta) scale, rounded to T as A operands.
template <typename T, int N>
__device__ __forceinline__ void grads_t(float (&s)[N / 2], float (&dp)[N / 2],
                                        uint32_t (&pa)[N / 4],
                                        uint32_t (&da)[N / 4],
                                        const float* delta, uint64_t keep,
                                        float inv, int quad, float scale) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 dl =
        *reinterpret_cast<const float2*>(delta + 8 * j + 2 * quad);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = 4 * j + e;
      const bool kept = (keep >> idx) & 1;
      const float pr = s[idx];
      const float d = kept ? dp[idx] * inv : 0.f;
      s[idx] = kept ? pr * inv : 0.f;
      dp[idx] = pr * (d - ((e & 1) ? dl.y : dl.x)) * scale;
    }
  }
  pack_a<T, N>(s, pa);
  pack_a<T, N>(dp, da);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap omap,
                               const Params p, int tma, int out_vec) {
  using C = Dkdv<D>;
  constexpr int N = C::kN, ST = C::kStages;
  using GR = Geo<D, kRes>;  // K, V
  using GS = Geo<D, N>;     // Q, dO
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sK = raw + pad;
  const uint32_t sV = sK + GR::kTileBytes;
  const uint32_t sQ = sV + GR::kTileBytes;       // stage st at + st * tile
  const uint32_t sO = sQ + ST * GS::kTileBytes;  // the dO ring
  float* lse_s = reinterpret_cast<float*>(base + C::kStatsOff);  // [ST][N]
  float* delta_s = lse_s + ST * N;
  // mbarriers: K and V full, K and V consumed; stage full (the tiles and
  // the 32 lanes that write lse and delta), stage consumed
  const uint32_t bar_kv = smem_u32(delta_s + ST * N);
  const uint32_t bar_kve = bar_kv + 8;
  const uint32_t bar_f = bar_kve + 8, bar_e = bar_f + 8 * ST;
  const int nwork = ((p.Sk + kRes - 1) / kRes) * p.NH * p.B;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kve, 4 * kConsumers);  // one arrival a consumer warp
    for (int st = 0; st < ST; ++st) {
      mbar_init(bar_f + 8 * st, 1 + 32);
      mbar_init(bar_e + 8 * st, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // -- producer: each item's K and V, then its Q, dO, lse, delta tiles --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int t = threadIdx.x - 128 * kConsumers;
    if (tma && t >= 32) return;  // one thread copies, one warp the stats
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
      const KeyItem it = key_item(w, p, N);
      const long long rows =
          static_cast<long long>(it.b * p.NH + it.h) * p.Sq;
      mbar_wait(bar_kve, (n & 1) ^ 1);  // the last item's K and V are done
      if (tma) {
        if (t == 0) {
          mbar_expect_tx(bar_kv, 2 * GR::kTileBytes);
          for (int sl = 0; sl < GR::kSlabs; ++sl) {
            tma_load(sK + sl * GR::kSlabBytes, &kmap, bar_kv,
                     sl * GR::kSlabCols, it.k0, it.h, it.b);
            tma_load(sV + sl * GR::kSlabBytes, &vmap, bar_kv,
                     sl * GR::kSlabCols, it.k0, it.h, it.b);
          }
        }
      } else {
        load_tile_elems<T, D, kRes>(base, head_base<T>(p.k, p.lk, it.b, it.h),
                                    p.lk.r, it.k0, p.Sk, t);
        load_tile_elems<T, D, kRes>(base + (sV - sK),
                                    head_base<T>(p.v, p.lv, it.b, it.h),
                                    p.lv.r, it.k0, p.Sk, t);
        fence_proxy_async();
        producer_sync();
        if (t == 0) mbar_arrive(bar_kv);
      }
      for (int i = 0; i < it.ntiles; ++i, ++tile) {
        const int st = tile % ST, q0 = it.q0 + i * N;
        const uint32_t full = bar_f + 8 * st;
        const uint32_t q_dst = sQ + st * GS::kTileBytes;
        const uint32_t o_dst = sO + st * GS::kTileBytes;
        mbar_wait(bar_e + 8 * st, ((tile / ST) & 1) ^ 1);
        if (tma) {
          if (t == 0) {
            mbar_expect_tx(full, 2 * GS::kTileBytes);
            for (int sl = 0; sl < GS::kSlabs; ++sl) {
              tma_load(q_dst + sl * GS::kSlabBytes, &qmap, full,
                       sl * GS::kSlabCols, q0, it.h, it.b);
              tma_load(o_dst + sl * GS::kSlabBytes, &omap, full,
                       sl * GS::kSlabCols, q0, it.h, it.b);
            }
          }
        } else {
          load_tile_elems<T, D, N>(base + (q_dst - sK),
                                   head_base<T>(p.q, p.lq, it.b, it.h), p.lq.r,
                                   q0, p.Sq, t);
          load_tile_elems<T, D, N>(base + (o_dst - sK),
                                   head_base<T>(p.dout, p.ldo, it.b, it.h),
                                   p.ldo.r, q0, p.Sq, t);
          fence_proxy_async();
          producer_sync();
          if (t == 0) mbar_arrive(full);
        }
        if (t < 32) {
          for (int r = t; r < N; r += 32) {
            const int q = q0 + r;
            const bool in = q < p.Sq;
            lse_s[st * N + r] = in ? __ldg(p.lse + rows + q) : 0.f;
            delta_s[st * N + r] = in ? __ldg(p.delta + rows + q) : 0.f;
          }
          mbar_arrive(full);
        }
      }
    }
  } else {
    // -- consumers: 64 keys of each item a warpgroup ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const uint32_t sKw = sK + 64 * wg * GR::kRowBytes;
    const uint32_t sVw = sV + 64 * wg * GR::kRowBytes;
    const bool causal = p.causal != 0;
    const float inv = p.dropout ? p.inv_keep : 1.f;
    float dk[D / 2], dv[D / 2], s[N / 2], dp[N / 2];
    uint32_t pa[N / 4], da[N / 4];
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
      const KeyItem it = key_item(w, p, N);
      const int wbase = it.k0 + 64 * wg + 16 * warp;
      KeyRows r;
      r.quad = quad;
      r.i4 = (lane >> 2) & 3;
      r.ka = wbase + lane / 4;
      r.kb = r.ka + 8;
      r.kg = wbase + 4 * (lane >> 4);
      r.warp_hi = wbase + 15;
      const uint8_t* km =
          p.key_mask ? p.key_mask + static_cast<long long>(it.b) * p.Sk
                     : nullptr;
      r.dead_a = km != nullptr && r.ka < p.Sk && km[r.ka] != 0;
      r.dead_b = km != nullptr && r.kb < p.Sk && km[r.kb] != 0;
      r.any_dead = __any_sync(0xffffffffu, r.dead_a || r.dead_b);
      r.head_rows =
          static_cast<unsigned long long>(it.b * p.NH + it.h) * p.Sq;
#pragma unroll
      for (int c = 0; c < D / 2; ++c) dk[c] = dv[c] = 0.f;
      mbar_wait(bar_kv, n & 1);
      if (it.ntiles == 0) warp_arrive(bar_kve, lane);
      // One turn a query tile; no product sits under a branch (ptxas
      // serialises every wgmma of the kernel then).
      for (int i = 0; i < it.ntiles; ++i) {
        const int ti = tile + i, st = ti % ST, q0 = it.q0 + i * N;
        const uint32_t sQs = sQ + st * GS::kTileBytes;
        const uint32_t sOs = sO + st * GS::kTileBytes;
        mbar_wait(bar_f + 8 * st, (ti / ST) & 1);
        wgmma_fence();
        issue_ss<T, D, N, kRes, N>(s, sKw, sQs);   // S^T = K Q^T
        wgmma_commit();
        issue_ss<T, D, N, kRes, N>(dp, sVw, sOs);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<1>();  // S^T; dP^T runs on
        fence_regs(s);
        if (r.any_dead || (causal && r.warp_hi > q0))
          probs_t<N, true>(s, r, lse_s + st * N, q0, p);
        else
          probs_t<N, false>(s, r, lse_s + st * N, q0, p);
        const uint64_t keep = p.dropout ? keep_t<N>(r, q0, p) : ~0ull;
        wgmma_wait<0>();
        fence_regs(dp);
        if (i == it.ntiles - 1) warp_arrive(bar_kve, lane);  // K, V done
        grads_t<T, N>(s, dp, pa, da, delta_s + st * N, keep, inv, quad,
                      p.scale);
        wgmma_fence();
        issue_rs<T, D, N, N>(dv, pa, sOs);  // dV += P^T dO
        issue_rs<T, D, N, N>(dk, da, sQs);  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        warp_arrive(bar_e + 8 * st, lane);  // the stage is consumed
      }
      tile += it.ntiles;
      store_rows<T, D>(head_base_out<T>(p.out, p.lo, it.b, it.h), p.lo.r, dk,
                       r.ka, p.Sk, quad, out_vec);
      store_rows<T, D>(head_base_out<T>(p.out2, p.lo2, it.b, it.h), p.lo2.r, dv,
                       r.ka, p.Sk, quad, out_vec);
    }
  }
}

// -- kernel 2: dQ -------------------------------------------------------------

// An item of kernel 2: queries [q0, q0 + 128) of head h of batch row b, and
// the key tiles of N keys it visits.
struct QueryItem {
  int q0, h, b, ntiles;
};

__device__ __forceinline__ QueryItem query_item(int w, const Params& p,
                                                int N) {
  const int nq = (p.Sq + kRes - 1) / kRes, heads = p.NH * p.B;
  QueryItem it;
  it.q0 = (nq - 1 - w / heads) * kRes;  // the longest walks (causal) first
  it.h = (w % heads) % p.NH;
  it.b = (w % heads) / p.NH;
  const int kend = p.skip ? min(p.Sk, it.q0 + kRes) : p.Sk;
  it.ntiles = (kend + N - 1) / N;
  return it;
}

// What a kernel-2 consumer thread knows of its rows: queries qa and qb =
// qa + 8 (keys run along the columns), their lse and delta, the warp's
// lowest query, the rows' Philox element offsets, and the key mask row.
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

// p = exp(s - lse) of one tile from its raw dots (in s), keys k0 ..; the
// mask and the Sk bound only where they can bite (kMasked).
template <int N, bool kMasked>
__device__ __forceinline__ void probs_q(float (&s)[N / 2], const QueryRows& r,
                                        int k0, uint32_t colmask,
                                        const Params& p) {
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
      s[4 * j + e] = ex2((v - ((e & 2) ? r.lse_b : r.lse_a)) * kLog2e);
    }
  }
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

// dS = p (dp - delta) scale from p (in s) and the raw dP (in dp), rounded
// to T as the A operand of dS K.
template <typename T, int N>
__device__ __forceinline__ void grads_q(const float (&s)[N / 2],
                                        float (&dp)[N / 2],
                                        uint32_t (&da)[N / 4], uint64_t keep,
                                        float inv, const QueryRows& r,
                                        float scale) {
#pragma unroll
  for (int idx = 0; idx < N / 2; ++idx) {
    const bool kept = (keep >> idx) & 1;
    const float d = kept ? dp[idx] * inv : 0.f;
    dp[idx] = s[idx] * (d - ((idx & 2) ? r.delta_b : r.delta_a)) * scale;
  }
  pack_a<T, N>(dp, da);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap omap,
                             const Params p, int tma, int out_vec) {
  using C = Dq<D>;
  constexpr int N = C::kN, ST = C::kStages;
  using GR = Geo<D, kRes>;  // Q, dO
  using GS = Geo<D, N>;     // K, V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sQ = raw + pad;
  const uint32_t sO = sQ + GR::kTileBytes;
  const uint32_t sK = sO + GR::kTileBytes;       // stage st at + st * tile
  const uint32_t sV = sK + ST * GS::kTileBytes;  // the V ring
  // mbarriers: Q and dO full, Q and dO consumed; stage full, consumed
  const uint32_t bar_q = sV + ST * GS::kTileBytes;
  const uint32_t bar_qe = bar_q + 8;
  const uint32_t bar_f = bar_qe + 8, bar_e = bar_f + 8 * ST;
  const int nwork = ((p.Sq + kRes - 1) / kRes) * p.NH * p.B;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 4 * kConsumers);
    for (int st = 0; st < ST; ++st) {
      mbar_init(bar_f + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // -- producer: each item's Q and dO, then its K and V tiles ------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int t = threadIdx.x - 128 * kConsumers;
    if (tma && t != 0) return;  // one thread issues every copy
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
      const QueryItem it = query_item(w, p, N);
      mbar_wait(bar_qe, (n & 1) ^ 1);  // the last item's Q and dO are done
      if (tma) {
        mbar_expect_tx(bar_q, 2 * GR::kTileBytes);
        for (int sl = 0; sl < GR::kSlabs; ++sl) {
          tma_load(sQ + sl * GR::kSlabBytes, &qmap, bar_q, sl * GR::kSlabCols,
                   it.q0, it.h, it.b);
          tma_load(sO + sl * GR::kSlabBytes, &omap, bar_q, sl * GR::kSlabCols,
                   it.q0, it.h, it.b);
        }
      } else {
        load_tile_elems<T, D, kRes>(base, head_base<T>(p.q, p.lq, it.b, it.h),
                                    p.lq.r, it.q0, p.Sq, t);
        load_tile_elems<T, D, kRes>(base + (sO - sQ),
                                    head_base<T>(p.dout, p.ldo, it.b, it.h),
                                    p.ldo.r, it.q0, p.Sq, t);
        fence_proxy_async();
        producer_sync();
        if (t == 0) mbar_arrive(bar_q);
      }
      for (int i = 0; i < it.ntiles; ++i, ++tile) {
        const int st = tile % ST;
        const uint32_t full = bar_f + 8 * st;
        const uint32_t k_dst = sK + st * GS::kTileBytes;
        const uint32_t v_dst = sV + st * GS::kTileBytes;
        mbar_wait(bar_e + 8 * st, ((tile / ST) & 1) ^ 1);
        if (tma) {
          mbar_expect_tx(full, 2 * GS::kTileBytes);
          for (int sl = 0; sl < GS::kSlabs; ++sl) {
            tma_load(k_dst + sl * GS::kSlabBytes, &kmap, full,
                     sl * GS::kSlabCols, i * N, it.h, it.b);
            tma_load(v_dst + sl * GS::kSlabBytes, &vmap, full,
                     sl * GS::kSlabCols, i * N, it.h, it.b);
          }
        } else {
          load_tile_elems<T, D, N>(base + (k_dst - sQ),
                                   head_base<T>(p.k, p.lk, it.b, it.h), p.lk.r,
                                   i * N, p.Sk, t);
          load_tile_elems<T, D, N>(base + (v_dst - sQ),
                                   head_base<T>(p.v, p.lv, it.b, it.h), p.lv.r,
                                   i * N, p.Sk, t);
          fence_proxy_async();
          producer_sync();
          if (t == 0) mbar_arrive(full);
        }
      }
    }
  } else {
    // -- consumers: 64 queries of each item a warpgroup ---------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const uint32_t sQw = sQ + 64 * wg * GR::kRowBytes;
    const uint32_t sOw = sO + 64 * wg * GR::kRowBytes;
    const bool causal = p.causal != 0;
    const float inv = p.dropout ? p.inv_keep : 1.f;
    float dq[D / 2], s[N / 2], dp[N / 2];
    uint32_t da[N / 4];
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
      const QueryItem it = query_item(w, p, N);
      QueryRows r;
      r.quad = quad;
      r.lane = lane;
      r.warp_lo = it.q0 + 64 * wg + 16 * warp;
      r.qa = r.warp_lo + lane / 4;
      r.qb = r.qa + 8;
      const long long rows =
          static_cast<long long>(it.b * p.NH + it.h) * p.Sq;
      const bool in_a = r.qa < p.Sq, in_b = r.qb < p.Sq;
      r.lse_a = in_a ? __ldg(p.lse + rows + r.qa) : 0.f;
      r.lse_b = in_b ? __ldg(p.lse + rows + r.qb) : 0.f;
      r.delta_a = in_a ? __ldg(p.delta + rows + r.qa) : 0.f;
      r.delta_b = in_b ? __ldg(p.delta + rows + r.qb) : 0.f;
      r.ia = static_cast<unsigned long long>(rows + r.qa) * p.Sk;
      r.ib = static_cast<unsigned long long>(rows + r.qb) * p.Sk;
      r.kmask = p.key_mask
                    ? p.key_mask + static_cast<long long>(it.b) * p.Sk
                    : nullptr;
#pragma unroll
      for (int c = 0; c < D / 2; ++c) dq[c] = 0.f;
      mbar_wait(bar_q, n & 1);
      for (int i = 0; i < it.ntiles; ++i) {
        const int ti = tile + i, st = ti % ST, k0 = i * N;
        const uint32_t sKs = sK + st * GS::kTileBytes;
        const uint32_t sVs = sV + st * GS::kTileBytes;
        mbar_wait(bar_f + 8 * st, (ti / ST) & 1);
        wgmma_fence();
        issue_ss<T, D, N, kRes, N>(s, sQw, sKs);   // S = Q K^T
        wgmma_commit();
        issue_ss<T, D, N, kRes, N>(dp, sOw, sVs);  // dP = dO V^T
        wgmma_commit();
        bool any = false;
        const uint32_t colmask =
            r.kmask != nullptr ? col_mask<N>(r, k0, p.Sk, any) : 0u;
        wgmma_wait<1>();  // S; dP runs on
        fence_regs(s);
        if (any || k0 + N > p.Sk || (causal && k0 + N - 1 > r.warp_lo))
          probs_q<N, true>(s, r, k0, colmask, p);
        else
          probs_q<N, false>(s, r, k0, colmask, p);
        const uint64_t keep = p.dropout ? keep_q<N>(r, k0, p) : ~0ull;
        wgmma_wait<0>();
        fence_regs(dp);
        if (i == it.ntiles - 1) warp_arrive(bar_qe, lane);  // Q, dO done
        grads_q<T, N>(s, dp, da, keep, inv, r, p.scale);
        wgmma_fence();
        issue_rs<T, D, N, N>(dq, da, sKs);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
        warp_arrive(bar_e + 8 * st, lane);  // the stage is consumed
      }
      tile += it.ntiles;
      store_rows<T, D>(head_base_out<T>(p.out, p.lo, it.b, it.h), p.lo.r, dq,
                       r.qa, p.Sq, quad, out_vec);
    }
  }
}

// -- host ---------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int D>
int launch(const Params& p, const Params& pq, int parts, bool vec, int dtype,
           cudaStream_t s) {
  const int sms = sm_count();
  const long long heads = static_cast<long long>(p.NH) * p.B;
  if (parts & 1) {
    using C = Dkdv<D>;
    CUtensorMap m[4];
    memset(m, 0, sizeof(m));
    const bool tma =
        vec &&
        make_map<D>(&m[0], p.q, p.lq, p.Sq, p.NH, p.B, dtype, C::kN) &&
        make_map<D>(&m[1], p.k, p.lk, p.Sk, p.NH, p.B, dtype, kRes) &&
        make_map<D>(&m[2], p.v, p.lv, p.Sk, p.NH, p.B, dtype, kRes) &&
        make_map<D>(&m[3], p.dout, p.ldo, p.Sq, p.NH, p.B, dtype, C::kN);
    const bool out_vec = pairs_ok(p.out, p.lo) && pairs_ok(p.out2, p.lo2);
    auto kernel = flash_bwd_dkdv_sm90_kernel<T, D>;
    int err = set_smem(kernel, C::kSmem);
    if (err != 0) return err;
    const long long items = ((p.Sk + kRes - 1) / kRes) * heads;
    const int grid = static_cast<int>(items < sms ? items : sms);
    kernel<<<grid, kThreads, C::kSmem, s>>>(m[0], m[1], m[2], m[3], p,
                                            tma ? 1 : 0, out_vec ? 1 : 0);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (parts & 2) {
    using C = Dq<D>;
    CUtensorMap m[4];
    memset(m, 0, sizeof(m));
    const bool tma =
        vec &&
        make_map<D>(&m[0], pq.q, pq.lq, pq.Sq, pq.NH, pq.B, dtype, kRes) &&
        make_map<D>(&m[1], pq.k, pq.lk, pq.Sk, pq.NH, pq.B, dtype, C::kN) &&
        make_map<D>(&m[2], pq.v, pq.lv, pq.Sk, pq.NH, pq.B, dtype, C::kN) &&
        make_map<D>(&m[3], pq.dout, pq.ldo, pq.Sq, pq.NH, pq.B, dtype, kRes);
    auto kernel = flash_bwd_dq_sm90_kernel<T, D>;
    int err = set_smem(kernel, C::kSmem);
    if (err != 0) return err;
    const long long items = ((pq.Sq + kRes - 1) / kRes) * heads;
    const int grid = static_cast<int>(items < sms ? items : sms);
    kernel<<<grid, kThreads, C::kSmem, s>>>(
        m[0], m[1], m[2], m[3], pq, tma ? 1 : 0,
        pairs_ok(pq.out, pq.lo) ? 1 : 0);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

template <typename T>
int launch_for_d(const Params& p, const Params& pq, int parts, int D,
                 bool vec, int dtype, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, pq, parts, vec, dtype, s);
    case 64: return launch<T, 64>(p, pq, parts, vec, dtype, s);
    case 128: return launch<T, 128>(p, pq, parts, vec, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int bwd_sm90(const Params& p, const Params& pq, int parts, int D, int dtype,
             bool vec, cudaStream_t s) {
  if (dtype == 1)
    return launch_for_d<__nv_bfloat16>(p, pq, parts, D, vec, dtype, s);
  if (dtype == 2) return launch_for_d<__half>(p, pq, parts, D, vec, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
