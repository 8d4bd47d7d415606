// The fp32 flash attention backward on the tensor cores: fp32 q, k, v,
// dout read by (batch, head, row) strides, fp32 dq, dk, dv written by
// strides into the caller's layout. It stands in for the backward kernels
// of apex_tpu/ops/flash_attention.py on fp32 inputs:
//   _bwd_fused_kernel_bsh (B5), _bwd_dq_kernel (B11a) and _bwd_dkv_kernel
//   (B11b), _bwd_fused_kernel (B12; contrib multihead_attn in fp32, the
//   fp32 card-vs-CPU checks of every training phase).
// csrc/flash_attn.cu holds the entry point flash_attn_bwd, which sends
// fp32 inputs here, and the header that states the semantics kept (FILL
// for masked keys, -inf past Sk, a fully masked row averaged over all Sk
// keys, the causal tile skip only without a key mask, ds = p (dp - delta)
// scale, the Philox keep bits of element ((b NH + h) Sq + q) Sk + k).
//
// Products: 3xTF32 on mma.sync.m16n8k8 (fp32 accumulators). Each fp32
// operand a is split as it is loaded into a fragment into hi = a rounded
// to TF32 and lo = a - hi (read by the tensor core cut to TF32), and a
// product is lo hi + hi lo + hi hi, summed in that order into the fp32
// accumulator: within about 2^-20 of |a| |b| per product (1xTF32 would be
// 2^-11). No 1xTF32 product is taken.
//
// What bounds it on the H100: operations. The recompute backward takes 14
// D FLOPs a score over the two kernels (at the contrib shape, T 512, B 8,
// NH 16, D 64: 30 GFLOP, 0.45 ms on the CUDA cores at their 67 TFLOP/s
// peak), three times that on the tensor cores (0.18 ms at 495 TFLOP/s
// dense TF32), plus the split (three instructions an operand element a
// fragment load), the exponentials and, with dropout, the Philox replay.
//
// Design. Two kernels, as the 16-bit pair of csrc/flash_bwd_sm90.cu, so
// that every sum is taken in a fixed order in one thread's registers (no
// atomics; reruns are bit-identical): a block of 4 warps owns 64 resident
// rows (16 a warp) and walks the other side's tiles, staged by 16-byte
// cp.async copies into a double-buffered pair of tiles (element loads
// where the inputs are not whole 16-byte rows from a 16-byte base), rows
// padded to D + 4 floats so that every fragment load is free of bank
// conflicts. Operands stay fp32 in shared memory and are split in
// registers: a split stored beside each tile would double the shared
// bytes every fragment load reads, and the loads, not the split's
// arithmetic, would then bound the kernel. The score tile of a warp lives
// in the accumulator layout of csrc/flash_bwd_rows.cuh, which the 16-bit
// kernels share (the mask, the exponentials and the Philox keep bits come
// from there); p and dS feed the gradient products straight from those
// registers, their columns taken in the order (2 c, 2 c + 1) -> (c, c + 4)
// that the m16n8 accumulator gives, with the B operand's rows read in the
// same order.
// Kernel 1, dK and dV: 64 keys resident (K, V), query tiles of 32 streamed
// with their lse and delta (tiles of 64 hold 2 blocks an SM, of 32 three,
// and take ~20% longer); S^T = K Q^T, dP^T
// = V dO^T, p^T and dS^T in registers, dV += P^T dO, dK += dS^T Q. Under
// the causal tile skip the walk starts at the first query tile that
// reaches the keys.
// Kernel 2, dQ: 64 queries resident (Q, dO, the rows' lse and delta), key
// tiles of 64 streamed; S = Q K^T, dP = dO V^T, dS in registers, dQ += dS
// K; under the causal tile skip the walk stops at the last key tile the
// queries reach.

#include <math.h>

#include "flash_bwd_rows.cuh"
#include "philox.cuh"
#include "sm90_common.cuh"
#include "tf32x3.cuh"

namespace flash {
namespace {

template <int D>
struct DkdvF32 {  // kernel 1: queries a streamed tile, shared memory
  static constexpr int kN = 32;
  static constexpr int LD = D + 4;
  static constexpr int kTile = kN * LD;  // floats
  // K and V; two stages of Q, dO; two stages of lse and delta
  static constexpr size_t kSmem = 4 * (2 * kRows * LD + 4 * kTile + 4 * kN);
};

template <int D>
struct DqF32 {  // kernel 2: keys a streamed tile, shared memory
  static constexpr int kN = 64;
  static constexpr int LD = D + 4;
  static constexpr int kTile = kN * LD;
  // Q and dO; two stages of K, V
  static constexpr size_t kSmem = 4 * (2 * kRows * LD + 4 * kTile);
};

template <int D>
__global__ void __launch_bounds__(kThreadsF)
    flash_bwd_dkdv_f32_kernel(const Params p, int vec) {
  using C = DkdvF32<D>;
  constexpr int N = C::kN, LD = C::LD;
  extern __shared__ __align__(16) float smem_f[];
  float* Ks = smem_f;
  float* Vs = Ks + kRows * LD;
  float* tiles = Vs + kRows * LD;         // stage st: Q, then dO
  float* stats = tiles + 4 * C::kTile;    // stage st: lse, then delta
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int Sq = p.Sq;
  const float* qb = head_base<float>(p.q, p.lq, b, h);
  const float* dob = head_base<float>(p.dout, p.ldo, b, h);
  const long long row_base = static_cast<long long>(b * p.NH + h) * Sq;
  stage_rows<D, kRows>(Ks, head_base<float>(p.k, p.lk, b, h), p.lk.r, k0,
                       p.Sk, vec);
  stage_rows<D, kRows>(Vs, head_base<float>(p.v, p.lv, b, h), p.lv.r, k0,
                       p.Sk, vec);
  const int qs0 = p.skip ? (k0 / N) * N : 0;
  const int ntiles = qs0 < Sq ? (Sq - qs0 + N - 1) / N : 0;
  auto stage = [&](int i) {  // query tile i into stage i % 2
    const int q0 = qs0 + i * N;
    float* q_dst = tiles + (i % 2) * 2 * C::kTile;
    stage_rows<D, N>(q_dst, qb, p.lq.r, q0, Sq, vec);
    stage_rows<D, N>(q_dst + C::kTile, dob, p.ldo.r, q0, Sq, vec);
    float* st = stats + (i % 2) * 2 * N;
    for (int r = threadIdx.x; r < N; r += kThreadsF) {
      const bool in = q0 + r < Sq;
      const long long at = row_base + (in ? q0 + r : 0);
      cp_async4(st + r, p.lse + at, in);
      cp_async4(st + N + r, p.delta + at, in);
    }
  };
  if (ntiles > 0) stage(0);
  cp_async_commit();

  KeyRows r;
  const int wbase = k0 + 16 * warp;
  r.quad = quad;
  r.i4 = (lane >> 2) & 3;
  r.ka = wbase + lane / 4;
  r.kb = r.ka + 8;
  r.kg = wbase + 4 * (lane >> 4);
  r.warp_hi = wbase + 15;
  const uint8_t* km =
      p.key_mask ? p.key_mask + static_cast<long long>(b) * p.Sk : nullptr;
  r.dead_a = km != nullptr && r.ka < p.Sk && km[r.ka] != 0;
  r.dead_b = km != nullptr && r.kb < p.Sk && km[r.kb] != 0;
  r.any_dead = __any_sync(0xffffffffu, r.dead_a || r.dead_b);
  r.head_rows = static_cast<unsigned long long>(row_base);
  const bool causal = p.causal != 0;
  const float inv = p.dropout ? p.inv_keep : 1.f;
  const float* Kw = Ks + 16 * warp * LD;
  const float* Vw = Vs + 16 * warp * LD;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) dk[c] = dv[c] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) stage(i + 1);  // its stage was consumed at i - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile i (and K, V) landed for every thread
    const int q0 = qs0 + i * N;
    const float* Qt = tiles + (i % 2) * 2 * C::kTile;
    const float* Ot = Qt + C::kTile;
    const float* lse = stats + (i % 2) * 2 * N;
    const float* delta = lse + N;
    float s[N / 2], dp[N / 2];
#pragma unroll
    for (int c = 0; c < N / 2; ++c) s[c] = dp[c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {  // S^T = K Q^T, dP^T = V dO^T
      uint32_t kh[4], kl[4], vh[4], vl[4];
      frag_a(Kw, LD, 8 * kk, lane, kh, kl);
      frag_a(Vw, LD, 8 * kk, lane, vh, vl);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_d(Qt, LD, 8 * j, 8 * kk, lane, bh, bl);
        mma3(s + 4 * j, kh, kl, bh, bl);
        frag_b_d(Ot, LD, 8 * j, 8 * kk, lane, bh, bl);
        mma3(dp + 4 * j, vh, vl, bh, bl);
      }
    }
    if (r.any_dead || (causal && r.warp_hi > q0))
      probs_t<N, true>(s, r, lse, q0, p);
    else
      probs_t<N, false>(s, r, lse, q0, p);
    const uint64_t keep = p.dropout ? keep_t<N>(r, q0, p) : ~0ull;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {  // dropped p^T; dS^T
      const float2 dd =
          *reinterpret_cast<const float2*>(delta + 8 * j + 2 * quad);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * j + e;
        const bool kept = (keep >> idx) & 1;
        const float pr = s[idx];
        const float d = kept ? dp[idx] * inv : 0.f;
        s[idx] = kept ? pr * inv : 0.f;
        dp[idx] = pr * (d - ((e & 1) ? dd.y : dd.x)) * p.scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {  // dV += P^T dO, dK += dS^T Q
      uint32_t ph[4], pl[4], dh[4], dl[4];
      frag_a_regs(s, kk, ph, pl);
      frag_a_regs(dp, kk, dh, dl);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_rows(Ot, LD, 8 * kk, 8 * j, lane, bh, bl);
        mma3(dv + 4 * j, ph, pl, bh, bl);
        frag_b_rows(Qt, LD, 8 * kk, 8 * j, lane, bh, bl);
        mma3(dk + 4 * j, dh, dl, bh, bl);
      }
    }
    __syncthreads();  // stage i % 2 is consumed
  }
  cp_async_wait<0>();  // K and V of a block that walks no tile
  store_acc<D>(head_base_out<float>(p.out, p.lo, b, h), p.lo.r, dk, r.ka,
               p.Sk, quad);
  store_acc<D>(head_base_out<float>(p.out2, p.lo2, b, h), p.lo2.r, dv, r.ka,
               p.Sk, quad);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF)
    flash_bwd_dq_f32_kernel(const Params p, int vec) {
  using C = DqF32<D>;
  constexpr int N = C::kN, LD = C::LD;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;
  float* Os = Qs + kRows * LD;
  float* tiles = Os + kRows * LD;  // stage st: K, then V
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int Sq = p.Sq, Sk = p.Sk;
  const float* kb = head_base<float>(p.k, p.lk, b, h);
  const float* vb = head_base<float>(p.v, p.lv, b, h);
  stage_rows<D, kRows>(Qs, head_base<float>(p.q, p.lq, b, h), p.lq.r, q0, Sq,
                       vec);
  stage_rows<D, kRows>(Os, head_base<float>(p.dout, p.ldo, b, h), p.ldo.r,
                       q0, Sq, vec);
  const int kend = p.skip ? min(Sk, q0 + kRows) : Sk;
  const int ntiles = (kend + N - 1) / N;
  auto stage = [&](int i) {  // key tile i into stage i % 2
    float* k_dst = tiles + (i % 2) * 2 * C::kTile;
    stage_rows<D, N>(k_dst, kb, p.lk.r, i * N, Sk, vec);
    stage_rows<D, N>(k_dst + C::kTile, vb, p.lv.r, i * N, Sk, vec);
  };
  stage(0);
  cp_async_commit();

  QueryRows r;
  r.quad = quad;
  r.lane = lane;
  r.warp_lo = q0 + 16 * warp;
  r.qa = r.warp_lo + lane / 4;
  r.qb = r.qa + 8;
  const long long rows = static_cast<long long>(b * p.NH + h) * Sq;
  const bool in_a = r.qa < Sq, in_b = r.qb < Sq;
  r.lse_a = in_a ? __ldg(p.lse + rows + r.qa) : 0.f;
  r.lse_b = in_b ? __ldg(p.lse + rows + r.qb) : 0.f;
  r.delta_a = in_a ? __ldg(p.delta + rows + r.qa) : 0.f;
  r.delta_b = in_b ? __ldg(p.delta + rows + r.qb) : 0.f;
  r.ia = static_cast<unsigned long long>(rows + r.qa) * Sk;
  r.ib = static_cast<unsigned long long>(rows + r.qb) * Sk;
  r.kmask =
      p.key_mask ? p.key_mask + static_cast<long long>(b) * Sk : nullptr;
  const bool causal = p.causal != 0;
  const float inv = p.dropout ? p.inv_keep : 1.f;
  const float* Qw = Qs + 16 * warp * LD;
  const float* Ow = Os + 16 * warp * LD;
  float dq[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) dq[c] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) stage(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = i * N;
    const float* Kt = tiles + (i % 2) * 2 * C::kTile;
    const float* Vt = Kt + C::kTile;
    float s[N / 2], dp[N / 2];
#pragma unroll
    for (int c = 0; c < N / 2; ++c) s[c] = dp[c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {  // S = Q K^T, dP = dO V^T
      uint32_t qh[4], ql[4], oh[4], ol[4];
      frag_a(Qw, LD, 8 * kk, lane, qh, ql);
      frag_a(Ow, LD, 8 * kk, lane, oh, ol);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_d(Kt, LD, 8 * j, 8 * kk, lane, bh, bl);
        mma3(s + 4 * j, qh, ql, bh, bl);
        frag_b_d(Vt, LD, 8 * j, 8 * kk, lane, bh, bl);
        mma3(dp + 4 * j, oh, ol, bh, bl);
      }
    }
    bool any = false;
    const uint32_t colmask =
        r.kmask != nullptr ? col_mask<N>(r, k0, Sk, any) : 0u;
    if (any || k0 + N > Sk || (causal && k0 + N - 1 > r.warp_lo))
      probs_q<N, true>(s, r, k0, colmask, p);
    else
      probs_q<N, false>(s, r, k0, colmask, p);
    const uint64_t keep = p.dropout ? keep_q<N>(r, k0, p) : ~0ull;
#pragma unroll
    for (int idx = 0; idx < N / 2; ++idx) {  // dS
      const bool kept = (keep >> idx) & 1;
      const float d = kept ? dp[idx] * inv : 0.f;
      dp[idx] = s[idx] * (d - ((idx & 2) ? r.delta_b : r.delta_a)) * p.scale;
    }
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {  // dQ += dS K
      uint32_t dh[4], dl[4];
      frag_a_regs(dp, kk, dh, dl);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_rows(Kt, LD, 8 * kk, 8 * j, lane, bh, bl);
        mma3(dq + 4 * j, dh, dl, bh, bl);
      }
    }
    __syncthreads();
  }
  store_acc<D>(head_base_out<float>(p.out, p.lo, b, h), p.lo.r, dq, r.qa, Sq,
               quad);
}

template <typename K>
int launch_f32(K kernel, size_t smem, dim3 grid, const Params& p, int vec,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreadsF, smem, s>>>(p, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd(const Params& p, const Params& pq, int parts, bool vec,
        cudaStream_t s) {
  if (parts & 1) {
    const int err = launch_f32(
        flash_bwd_dkdv_f32_kernel<D>, DkdvF32<D>::kSmem,
        dim3((p.Sk + kRows - 1) / kRows, p.NH, p.B), p, vec ? 1 : 0, s);
    if (err != 0) return err;
  }
  if (parts & 2)
    return launch_f32(flash_bwd_dq_f32_kernel<D>, DqF32<D>::kSmem,
                      dim3((pq.Sq + kRows - 1) / kRows, pq.NH, pq.B), pq,
                      vec ? 1 : 0, s);
  return 0;
}

}  // namespace

int bwd_f32(const Params& p, const Params& pq, int parts, int D, bool vec,
            cudaStream_t s) {
  switch (D) {
    case 32: return bwd<32>(p, pq, parts, vec, s);
    case 64: return bwd<64>(p, pq, parts, vec, s);
    case 128: return bwd<128>(p, pq, parts, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
