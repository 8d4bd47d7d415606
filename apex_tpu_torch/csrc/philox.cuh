// Philox4x32-10 counter-based generator shared by the port's dropout
// kernels (csrc/dropout.cu, csrc/flash_attn.cu) and the quantized KV
// write (csrc/kv_quant_write.cu).
//
// Salmon et al., "Parallel random numbers: as easy as 1, 2, 3" (SC'11),
// with the Random123 constants. The dropout stream is keyed the same way
// as the plain PyTorch version in apex_tpu_torch/ops/_common.py::
// philox_bits: counter = (element index / 4 as a 64-bit value in the
// first two words, 0, 0), key = (seed, 0), and element i takes word i % 4
// of its counter's output. A kernel and its plain version therefore draw
// the same bits for the same element, and a backward pass regenerates the
// forward's mask from the seed alone: no mask is ever stored. The KV
// write keys its noise through the general form, philox4x32_10_words:
// counter (element / 4, token position, 0, 0), key (seed, stream).
#pragma once

#include <stdint.h>

// Ten rounds on counter (c0, c1, 0, 0) under key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10_words(unsigned int c0,
                                                     unsigned int c1,
                                                     unsigned int k0,
                                                     unsigned int k1) {
  unsigned int c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned int hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned int lo0 = 0xD2511F53u * c0;
    const unsigned int hi1 = __umulhi(0xCD9E8D57u, c2);
    const unsigned int lo1 = 0xCD9E8D57u * c2;
    const unsigned int n0 = hi1 ^ c1 ^ k0;
    const unsigned int n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The dropout streams: counter (group as 64 bits, 0, 0), key (seed, 0).
__device__ __forceinline__ uint4 philox4x32_10(unsigned long long group,
                                               unsigned int seed) {
  return philox4x32_10_words(static_cast<unsigned int>(group),
                             static_cast<unsigned int>(group >> 32), seed,
                             0u);
}

__device__ __forceinline__ unsigned int philox_word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The bits of one element of the stream, reusing the last counter's
// output while consecutive elements share it (four elements per call).
struct PhiloxCursor {
  unsigned int seed;
  unsigned long long group = ~0ull;
  uint4 out;

  __device__ explicit PhiloxCursor(unsigned int s) : seed(s) {}

  __device__ __forceinline__ unsigned int bits(unsigned long long index) {
    const unsigned long long g = index >> 2;
    if (g != group) {
      out = philox4x32_10(g, seed);
      group = g;
    }
    return philox_word(out, static_cast<int>(index & 3ull));
  }
};
