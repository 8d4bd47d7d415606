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
// backward per input width (fp32 in csrc/flash_fwd_f32.cu and
// csrc/flash_bwd_f32.cu; bf16 and fp16 in csrc/flash_fwd_sm90.cu and
// csrc/flash_bwd_sm90.cu) take any Sq, Sk and strides, so the five share
// one source of truth for the mask, the Philox numbering and the rounding.
// The wrappers count each call under the name of the TPU kernel it stands
// in for.
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
// modules are all read in place. The forward is one pass over the keys
// with an online softmax (a running max and sum per row, the output
// accumulator rescaled per key tile), as JAX's tiled kernel does. The
// backward is two kernels, so that no sum needs atomics (deterministic):
// dK/dV walking the query tiles of a key tile, and dQ walking the key
// tiles of a query tile; each recomputes s and p from q, k and lse and
// replays the same mask.
//
// This file holds the entry points; every kernel runs on the tensor
// cores. fp32 inputs take the 3xTF32 kernels (mma.sync m16n8k8, each fp32
// operand split into two TF32 halves, three products; csrc/tf32x3.cuh):
// the forward in csrc/flash_fwd_f32.cu, the backward in
// csrc/flash_bwd_f32.cu, both on 64 resident rows a block of 4 warps with
// the other side's tiles double-buffered by cp.async. The 16-bit inputs
// (bf16, the training path, and fp16) run in the Hopper kernels: the
// forward in csrc/flash_fwd_sm90.cu (wgmma, TMA, persistent blocks), the
// backward's dK/dV and dQ kernels in csrc/flash_bwd_sm90.cu (wgmma, TMA,
// p and dS formed in registers), with tile sizes of their own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::Layout;
using flash::Params;

// fp32: the 3xTF32 forward (csrc/flash_fwd_f32.cu); 16-bit: the Hopper
// forward (csrc/flash_fwd_sm90.cu). vec: q, k and v start on 16-byte
// boundaries with strides of whole 16-byte chunks.
int dispatch_fwd(int D, const Params& p, int dtype, bool vec,
                 cudaStream_t s) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (dtype != 0) return flash::fwd_sm90(p, D, dtype, vec, s);
  return flash::fwd_f32(p, D, vec, s);
}

// fp32: the 3xTF32 pair (csrc/flash_bwd_f32.cu); 16-bit: the Hopper pair
// (csrc/flash_bwd_sm90.cu). vec: every input's base and strides are whole
// 16-byte chunks.
int dispatch_bwd(int D, const Params& p, const Params& pq, int parts,
                 int dtype, bool vec, cudaStream_t s) {
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (dtype != 0) return flash::bwd_sm90(p, pq, parts, D, dtype, vec, s);
  return flash::bwd_f32(p, pq, parts, D, vec, s);
}

Layout layout_at(const long long* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

// TMA (16-bit inputs) and the fp32 kernels' cp.async copies need a
// 16-byte aligned base and strides of whole 16-byte chunks (per: elements
// a chunk).
bool vec_ok(const void* ptr, const Layout& L, int per) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && L.b % per == 0 &&
         L.h % per == 0 && L.r % per == 0;
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
  const int per = dtype == 0 ? 4 : 8;
  const bool vec =
      vec_ok(q, p.lq, per) && vec_ok(k, p.lk, per) && vec_ok(v, p.lv, per);
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
  const int per = dtype == 0 ? 4 : 8;
  const bool vec = vec_ok(q, p.lq, per) && vec_ok(k, p.lk, per) &&
                   vec_ok(v, p.lv, per) && vec_ok(dout, p.ldo, per);
  return dispatch_bwd(D, p, pq, parts, dtype, vec,
                      static_cast<cudaStream_t>(stream));
}
