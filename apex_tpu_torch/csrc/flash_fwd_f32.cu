// The fp32 flash attention forward on the tensor cores: fp32 q, k, v read
// by (batch, head, row) strides, fp32 out written by strides into the
// caller's layout, fp32 lse. It stands in for the forward kernels of
// apex_tpu/ops/flash_attention.py on fp32 inputs:
//   _fwd_single_kernel_bsh (B4), _fwd_kernel (B9, the tiled online
//   softmax) and _fwd_single_kernel (B10; contrib multihead_attn in fp32,
//   the fp32 card-vs-CPU checks of every training phase).
// csrc/flash_attn.cu holds the entry point flash_attn_fwd, which sends
// fp32 inputs here, and the header that states the semantics kept (FILL
// for masked keys, -inf past Sk, a fully masked row averaged over all Sk
// keys, the causal tile skip only without a key mask, l and lse before
// dropout, the Philox keep bits of element ((b NH + h) Sq + q) Sk + k).
//
// Products: 3xTF32 on mma.sync.m16n8k8 (csrc/tf32x3.cuh): both S = Q K^T
// and O += P V split every fp32 operand into a TF32 hi and lo and sum lo
// hi + hi lo + hi hi into fp32 accumulators, within about 2^-20 of |a| |b|
// per product. No 1xTF32 product is taken, so the products stay
// fp32-class, as the JAX kernels' fp32 dots.
//
// What bounds it on the H100: operations. The forward takes 4 D FLOPs a
// score (at the contrib shape, T 512, B 8, NH 16, D 64: 8.6 GFLOP, 0.128
// ms on the CUDA cores at their 67 TFLOP/s peak; three TF32 products a
// product at 495 TFLOP/s dense TF32: 0.052 ms), plus the split (three
// instructions an operand element a fragment load), an exponential a
// score and, with dropout, a quarter of a Philox4x32-10 call a score.
//
// Design. The dQ kernel of csrc/flash_bwd_f32.cu without dP, plus an
// online softmax and O += P V: a block of 4 warps owns 64 resident
// queries (16 a warp), staged once by cp.async, and walks key tiles of 64
// whose K and V are double-buffered by stage_rows (16-byte cp.async
// copies; element loads where the inputs are not whole 16-byte rows from
// a 16-byte base), rows padded to D + 4 floats. A warp's S tile lives in
// the m16n8 accumulator layout of csrc/flash_bwd_rows.cuh, whose
// scores_q applies the mask the dQ kernels apply and whose keep_q draws
// the keep bits the fp32 backward replays. The online softmax runs in
// registers: rows qa and qb of a thread are reduced across the quad by
// two __shfl_xor each, each new tile rescales O and l by exp(m_old -
// m_new), and l sums p before dropout (lse = m + log(l)). P goes from the
// accumulator registers straight into the A fragments of O += P V
// (frag_a_regs, split into hi and lo), with V's rows read in the same
// order (frag_b_rows). Every sum is taken in a fixed order in one
// thread's registers: reruns are bit-identical. Under the causal tile
// skip the walk stops at the last key tile the queries reach.

#include <math.h>

#include "flash_bwd_rows.cuh"
#include "philox.cuh"
#include "sm90_common.cuh"
#include "tf32x3.cuh"

namespace flash {
namespace {

template <int D>
struct FwdF32 {  // keys a streamed tile, shared memory
  static constexpr int kN = 64;
  static constexpr int LD = D + 4;
  static constexpr int kTile = kN * LD;  // floats
  // Q; two stages of K, V
  static constexpr size_t kSmem = 4 * (kRows * LD + 4 * kTile);
};

template <int D>
__global__ void __launch_bounds__(kThreadsF)
    flash_fwd_f32_kernel(const Params p, int vec) {
  using C = FwdF32<D>;
  constexpr int N = C::kN, LD = C::LD;
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;
  float* tiles = Qs + kRows * LD;  // stage st: K, then V
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int Sq = p.Sq, Sk = p.Sk;
  const float* kb = head_base<float>(p.k, p.lk, b, h);
  const float* vb = head_base<float>(p.v, p.lv, b, h);
  stage_rows<D, kRows>(Qs, head_base<float>(p.q, p.lq, b, h), p.lq.r, q0, Sq,
                       vec);
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
  r.lse_a = r.lse_b = r.delta_a = r.delta_b = 0.f;  // the backward's
  const long long rows = static_cast<long long>(b * p.NH + h) * Sq;
  r.ia = static_cast<unsigned long long>(rows + r.qa) * Sk;
  r.ib = static_cast<unsigned long long>(rows + r.qb) * Sk;
  r.kmask =
      p.key_mask ? p.key_mask + static_cast<long long>(b) * Sk : nullptr;
  const bool causal = p.causal != 0;
  const float* Qw = Qs + 16 * warp * LD;
  float o[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) o[c] = 0.f;
  // each row's running max m and sum l (l is this thread's share of the
  // row until the end)
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) stage(i + 1);  // its stage was consumed at i - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile i (and Q) landed for every thread
    const int k0 = i * N;
    const float* Kt = tiles + (i % 2) * 2 * C::kTile;
    const float* Vt = Kt + C::kTile;
    float s[N / 2];
#pragma unroll
    for (int c = 0; c < N / 2; ++c) s[c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {  // S = Q K^T
      uint32_t qh[4], ql[4];
      frag_a(Qw, LD, 8 * kk, lane, qh, ql);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_d(Kt, LD, 8 * j, 8 * kk, lane, bh, bl);
        mma3(s + 4 * j, qh, ql, bh, bl);
      }
    }
    bool any = false;
    const uint32_t colmask =
        r.kmask != nullptr ? col_mask<N>(r, k0, Sk, any) : 0u;
    if (any || k0 + N > Sk || (causal && k0 + N - 1 > r.warp_lo))
      scores_q<N, true>(s, r, k0, colmask, p);
    else
      scores_q<N, false>(s, r, k0, colmask, p);
    // the online softmax: every tile has a key below Sk, so each row's
    // tile max is finite and m_old - m_new is never inf - inf
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int idx = 0; idx < N / 2; ++idx) {
      if (idx & 2)
        mx_b = fmaxf(mx_b, s[idx]);
      else
        mx_a = fmaxf(mx_a, s[idx]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = ex2((m_a - mn_a) * kLog2e);
    const float alpha_b = ex2((m_b - mn_b) * kLog2e);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int idx = 0; idx < N / 2; ++idx) {
      const float e = ex2((s[idx] - ((idx & 2) ? mn_b : mn_a)) * kLog2e);
      s[idx] = e;
      if (idx & 2)
        sum_b += e;
      else
        sum_a += e;
    }
    l_a = l_a * alpha_a + sum_a;  // before dropout
    l_b = l_b * alpha_b + sum_b;
    if (p.dropout) {
      const uint64_t keep = keep_q<N>(r, k0, p);
#pragma unroll
      for (int idx = 0; idx < N / 2; ++idx)
        s[idx] = ((keep >> idx) & 1) ? s[idx] * p.inv_keep : 0.f;
    }
#pragma unroll
    for (int idx = 0; idx < D / 2; ++idx)
      o[idx] *= (idx & 2) ? alpha_b : alpha_a;
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {  // O += P V
      uint32_t ph[4], pl[4];
      frag_a_regs(s, kk, ph, pl);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_rows(Vt, LD, 8 * kk, 8 * j, lane, bh, bl);
        mma3(o + 4 * j, ph, pl, bh, bl);
      }
    }
    __syncthreads();  // stage i % 2 is consumed
  }

  // out = O / l, lse = m + log(l)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float safe_a = l_a > 0.f ? l_a : 1.f;
  const float safe_b = l_b > 0.f ? l_b : 1.f;
#pragma unroll
  for (int idx = 0; idx < D / 2; ++idx)
    o[idx] = o[idx] / ((idx & 2) ? safe_b : safe_a);
  store_acc<D>(head_base_out<float>(p.out, p.lo, b, h), p.lo.r, o, r.qa, Sq,
               quad);
  if (quad == 0) {
    if (r.qa < Sq) p.lse_out[rows + r.qa] = m_a + logf(safe_a);
    if (r.qb < Sq) p.lse_out[rows + r.qb] = m_b + logf(safe_b);
  }
}

template <int D>
int fwd(const Params& p, bool vec, cudaStream_t s) {
  auto kernel = flash_fwd_f32_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(FwdF32<D>::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.Sq + kRows - 1) / kRows, p.NH, p.B), kThreadsF,
           FwdF32<D>::kSmem, s>>>(p, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int fwd_f32(const Params& p, int D, bool vec, cudaStream_t s) {
  switch (D) {
    case 32: return fwd<32>(p, vec, s);
    case 64: return fwd<64>(p, vec, s);
    case 128: return fwd<128>(p, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
