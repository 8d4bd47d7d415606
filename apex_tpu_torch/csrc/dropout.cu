// Fused elementwise dropout (kernel B3) and the flash attention keep mask
// (kernel B13), CUDA C++ for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/dropout.py::_kernel (wrapper _call), the Pallas
// TPU dropout behind fused_dropout and the models' hidden-dropout sites;
// and apex_tpu/ops/flash_attention.py::flash_dropout_keep_mask's
// mask_kernel, which writes the exact (B, H, Sq, Sk) keep mask the flash
// kernels apply, so that a composed reference can use it.
//
// Computes y[i] = bits(seed, i) < threshold ? T(float(x[i]) * scale) : 0
// for a contiguous fp32, bf16 or fp16 tensor, where bits(seed, i) is element i
// of the Philox4x32-10 stream (csrc/philox.cuh), threshold is
// keep_threshold(rate) and scale is 1 / (1 - rate) already rounded to T
// by the caller (the JAX kernel multiplies by the weakly typed Python
// constant, which JAX rounds to x's dtype first). The backward is this
// kernel on the gradient with the same seed: the mask is replayed, never
// stored.
//
// What bounds it on the H100: one read and one write of x (bf16 BERT-large
// site: 16 x 512 x 1024 elements, 33.5 MB, ~10 us at 3.35 TB/s). Philox
// costs ~40 integer operations per four elements, far below the memory
// time.
//
// Design: a grid-stride loop over groups of four elements; one Philox call
// gives the four elements' bits. Where the tensor is 16-byte aligned and
// the group is whole, the four elements move as one vector (8 bytes bf16
// or fp16, 16 bytes fp32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec4;  // four elements moved as one load/store
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
};
template <>
struct Vec4<__half> {
  using type = uint2;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   unsigned int seed, unsigned int threshold, float scale) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += stride) {
    const uint4 r = philox4x32_10(static_cast<unsigned long long>(g), seed);
    const unsigned int bits[4] = {r.x, r.y, r.z, r.w};
    const long long base = g * 4;
    if (VEC && base + 4 <= n) {
      using V = typename Vec4<T>::type;
      V raw = *reinterpret_cast<const V*>(x + base);
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = from_f32<T>(bits[j] < threshold ? to_f32(e[j]) * scale : 0.f);
      *reinterpret_cast<V*>(y + base) = raw;
    } else {
      for (int j = 0; j < 4 && base + j < n; ++j)
        y[base + j] = from_f32<T>(
            bits[j] < threshold ? to_f32(x[base + j]) * scale : 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, unsigned int seed,
           unsigned int threshold, float scale, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  if (blocks > cap) blocks = cap;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (vec)
    dropout_kernel<T, true><<<(int)blocks, kThreads, 0, stream>>>(
        xs, ys, n, seed, threshold, scale);
  else
    dropout_kernel<T, false><<<(int)blocks, kThreads, 0, stream>>>(
        xs, ys, n, seed, threshold, scale);
  return (int)cudaGetLastError();
}

// Kernel B13: out[i] = bits(seed, i) < threshold as a bool byte, i over
// the (B, H, Sq, Sk) mask in row-major order: element ((b * H + h) * Sq +
// q) * Sk + k is the bit the flash kernels (csrc/flash_attn.cu) draw for
// that score. The one byte written per element bounds it (GPT-2 small's
// B 8 x 12 heads x 1024 x 1024: 100.7 MB, 0.030 ms at 3.35 TB/s); four
// elements share one Philox call and one 4-byte store.
__global__ void __launch_bounds__(kThreads)
    keep_mask_kernel(uint8_t* __restrict__ out, long long n,
                     unsigned int seed, unsigned int threshold) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       g < groups; g += stride) {
    const uint4 r = philox4x32_10(static_cast<unsigned long long>(g), seed);
    const unsigned int bits[4] = {r.x, r.y, r.z, r.w};
    const long long base = g * 4;
    if (base + 4 <= n) {
      unsigned int word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (bits[j] < threshold ? 1u : 0u) << (8 * j);
      *reinterpret_cast<unsigned int*>(out + base) = word;
    } else {
      for (int j = 0; base + j < n; ++j)
        out[base + j] = bits[j] < threshold ? 1 : 0;
    }
  }
}

int grid_blocks(long long groups) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  return static_cast<int>(blocks > cap ? cap : blocks);
}

}  // namespace

// out: n bool bytes, 4-byte aligned (a fresh torch.bool tensor).
extern "C" int flash_keep_mask(void* out, long long n, unsigned int seed,
                               unsigned int threshold, void* stream) {
  if (n < 1 || reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  keep_mask_kernel<<<grid_blocks((n + 3) / 4), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), n, seed, threshold);
  return (int)cudaGetLastError();
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16. x and y contiguous, n
// elements.
extern "C" int fused_dropout(const void* x, void* y, long long n, int dtype,
                             unsigned int seed, unsigned int threshold,
                             float scale, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, seed, threshold, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, n, seed, threshold, scale, s);
  if (dtype == 2) return launch<__half>(x, y, n, seed, threshold, scale, s);
  return (int)cudaErrorInvalidValue;
}
