// What csrc/flash_attn.cu (the entry points), csrc/flash_fwd_sm90.cu (the
// 16-bit forward), csrc/flash_bwd_sm90.cu (the 16-bit backward),
// csrc/flash_fwd_f32.cu (the fp32 forward) and csrc/flash_bwd_f32.cu (the
// fp32 backward) share: the launch parameters and the masked fill.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float FILL = -30000.f;

// Element strides of a (B, NH, rows, D) operand; the D columns of a row are
// contiguous.
struct Layout {
  long long b, h, r;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* key_mask;  // (B, Sk), nonzero = masked; may be null
  const void* dout;         // (backward only)
  const float* lse;         // (B, NH, Sq)
  const float* delta;       // (B, NH, Sq) (backward only)
  void* out;                // forward: out; dK/dV kernel: dk; dQ: dq
  void* out2;               // dK/dV kernel: dv
  float* lse_out;           // forward only
  Layout lq, lk, lv, ldo, lo, lo2;
  int B, Sq, Sk, NH;
  float scale;
  int causal;
  int skip;                 // causal and no key mask: skip dead tiles
  int dropout;
  unsigned int seed;
  unsigned int threshold;
  float inv_keep;
};

// Head (b, h) of an operand laid out by L.
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

// The 16-bit forward (dtype 1 bfloat16, 2 float16; D 32, 64 or 128) on
// the stream; returns a cudaError_t. vec: q, k and v start on 16-byte
// boundaries with strides of whole 16-byte chunks (TMA's rule).
int fwd_sm90(const Params& p, int D, int dtype, bool vec, cudaStream_t s);

// The 16-bit backward, as fwd_sm90: parts 1 the dK/dV kernel (p.out = dk,
// p.out2 = dv), 2 the dQ kernel (pq.out = dq), 3 both; vec also covers
// dout.
int bwd_sm90(const Params& p, const Params& pq, int parts, int D, int dtype,
             bool vec, cudaStream_t s);

// The fp32 forward (csrc/flash_fwd_f32.cu), as fwd_sm90; vec: q, k and v
// start on 16-byte boundaries with strides of whole 16-byte chunks (the
// cp.async copies' rule).
int fwd_f32(const Params& p, int D, bool vec, cudaStream_t s);

// The fp32 backward (csrc/flash_bwd_f32.cu), as bwd_sm90; vec: q, k, v and
// dout start on 16-byte boundaries with strides of whole 16-byte chunks.
int bwd_f32(const Params& p, const Params& pq, int parts, int D, bool vec,
            cudaStream_t s);

}  // namespace flash
