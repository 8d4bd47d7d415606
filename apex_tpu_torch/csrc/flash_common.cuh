// What csrc/flash_attn.cu (the entry points, the fp32 kernels and the
// backward) and csrc/flash_fwd_sm90.cu (the 16-bit forward) share: the
// launch parameters and the masked fill.
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

// The 16-bit forward (dtype 1 bfloat16, 2 float16; D 32, 64 or 128) on
// the stream; returns a cudaError_t. vec: q, k and v start on 16-byte
// boundaries with strides of whole 16-byte chunks (TMA's rule).
int fwd_sm90(const Params& p, int D, int dtype, bool vec, cudaStream_t s);

}  // namespace flash
