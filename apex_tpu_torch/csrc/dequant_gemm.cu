// Weight-only dequant-GEMM for quantized GPT weights (kernel B15), CUDA
// C++ for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/dequant_gemm.py::_dequant_gemm_kernel (wrapper
// _pallas_dequant_gemm), the Pallas TPU kernel behind dequant_matmul.
//
// Computes out[m, n] = sum_k x[m, k] * (float(w_q[k, n]) * scale[n]) in
// fp32: x is (M, K) fp32, w_q is (K, N) int8 or float8_e4m3fn in the JAX
// (in, out) layout, scale is the (N,) fp32 per-output-channel scale, out
// is (M, N) fp32.
//
// What bounds it on the H100: on the serving path M is small (max_batch
// = 8 lanes at decode, a 128-row chunk at prefill) and (K, N) is (768,
// 768), (768, 3072) or (3072, 768). At M = 8 the kernel does 16 FLOPs per
// weight byte, under the ~20 at which the fp32 units (67 TFLOP/s over
// 3.35 TB/s) would become the limit: it is bound by the weight bytes. At
// M = 128 it does 256 FLOPs per weight byte and is bound by fp32
// operations.
//
// Design: one 256-thread block per (16-row M tile, 64-column N tile, K
// split). A loop over the block's K range in 32-deep slices stages the x
// slice (fp32) and the weight slice through shared memory, the weights
// read 8 bytes per thread and dequantized with their column's scale as
// they are staged, so the full-precision weights never exist in device
// memory; each thread keeps four fp32 outputs in registers and runs an
// fp32 FMA loop. At decode sizes the M x N tiles alone would leave most
// of the 132 SMs idle (12 blocks at N = 768), so the K axis is split
// across blocks until about two blocks per SM are in flight: each split
// writes its partial sums to a workspace and a second kernel adds the
// splits in a fixed order. Every output's sum therefore runs in one fixed
// order (deterministic), but not cuBLAS's: the plain chain (dequantize,
// then a cuBLAS fp32 matmul) agrees to a tolerance.

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int TM = 16;
constexpr int TN = 64;
constexpr int TK = 32;
constexpr int kThreads = 256;
constexpr int kRowStride = kThreads / TN;             // 4
constexpr int kRowsPerThread = TM / kRowStride;       // 4
constexpr int kTargetBlocks = 2 * 132;

__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) dequant_gemm_kernel(
    const float* __restrict__ x, const WT* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int M, int K,
    int N, int k_chunk) {
  __shared__ float x_s[TM][TK + 1];
  __shared__ float w_s[TK][TN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % TN;  // output column within the tile
  const int ty = tid / TN;  // first of this thread's output rows
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  // weight staging: thread -> (row wk, 8 columns from wc)
  const int wk = tid / (TN / 8);
  const int wc = (tid % (TN / 8)) * 8;
  const bool vec = (N % 8 == 0) && (n0 + wc + 8 <= N)
                   && (reinterpret_cast<uintptr_t>(w) % 8 == 0);
  float wscale[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wscale[j] = n0 + wc + j < N ? scale[n0 + wc + j] : 0.f;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    for (int e = tid; e < TM * TK; e += kThreads) {
      const int r = e / TK, k = e % TK;
      x_s[r][k] = (m0 + r < M && k0 + k < k_end)
                      ? x[(size_t)(m0 + r) * K + k0 + k] : 0.f;
    }
    const int kk = k0 + wk;
    if (kk < k_end && vec) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          w + (size_t)kk * N + n0 + wc);
      const WT* v = reinterpret_cast<const WT*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) w_s[wk][wc + j] = to_f32(v[j]) * wscale[j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wc + j;
        w_s[wk][wc + j] = (kk < k_end && n < N)
                              ? to_f32(w[(size_t)kk * N + n]) * wscale[j]
                              : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK; ++k) {
      const float wv = w_s[k][tx];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(x_s[ty + i * kRowStride][k], wv, acc[i]);
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = m0 + ty + i * kRowStride;
    if (m < M && n < N) dst[(size_t)m * N + n] = acc[i];
  }
}

// out[i] = sum over splits s (in order) of part[s, i]
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int splits,
                                  int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += part[(size_t)j * count + i];
  out[i] = s;
}

template <typename WT>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* workspace, int M, int K, int N, int splits, int k_chunk,
           cudaStream_t stream) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, splits);
  float* dst = splits > 1 ? static_cast<float*>(workspace)
                          : static_cast<float*>(out);
  dequant_gemm_kernel<WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const WT*>(w),
      static_cast<const float*>(scale), dst, M, K, N, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int count = M * N;
  sum_splits_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(workspace), static_cast<float*>(out), splits,
      count);
  return (int)cudaGetLastError();
}

}  // namespace

// How many K splits dequant_gemm uses for an (M, K, N) product, and the
// K range of each (a multiple of the 32-deep slice). The caller sizes the
// workspace from it: splits * M * N floats when splits > 1.
extern "C" int dequant_gemm_splits(int M, int K, int N, int* k_chunk) {
  const int tiles = ((N + TN - 1) / TN) * ((M + TM - 1) / TM);
  const int slices = (K + TK - 1) / TK;
  int splits = (kTargetBlocks + tiles - 1) / tiles;
  if (splits > slices) splits = slices;
  if (splits < 1) splits = 1;
  const int per = (slices + splits - 1) / splits;
  *k_chunk = per * TK;
  return (slices + per - 1) / per;
}

// w_dtype codes: 2 int8, 3 float8_e4m3fn. All operands contiguous;
// workspace holds splits * M * N floats (may be null when splits == 1).
extern "C" int dequant_gemm(const void* x, const void* w_q, const void* scale,
                            void* out, void* workspace, int M, int K, int N,
                            int w_dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  int k_chunk = 0;
  const int splits = dequant_gemm_splits(M, K, N, &k_chunk);
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 2)
    return launch<int8_t>(x, w_q, scale, out, workspace, M, K, N, splits,
                          k_chunk, s);
  if (w_dtype == 3)
    return launch<__nv_fp8_e4m3>(x, w_q, scale, out, workspace, M, K, N,
                                 splits, k_chunk, s);
  return (int)cudaErrorInvalidValue;
}
