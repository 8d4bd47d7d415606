// LayerNorm / RMSNorm forward (kernel B2), CUDA C++ for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm.py::_fwd_kernel (via _fwd_kernel_b /
// _fwd_kernel_nb, wrapper _pallas_forward), the Pallas TPU forward that
// fused_layer_norm_affine and fused_rms_norm_affine run when differentiated
// under APEX_TPU_LN_FWD=pallas.
//
// Computes, for rows x (R, H) in fp32, bf16 or fp16, an fp32 weight w (H,)
// and an optional fp32 bias b (H,), all in fp32:
//   mean = sum(x) / H (0 for RMSNorm), c = x - mean,
//   var = sum(c * c) / H (two passes over the values, from the centered
//   ones), rstd = rsqrt(var + eps), y = c * rstd * w (+ b),
// and writes y in x's dtype. The TPU kernel's 128-lane padding, row
// padding and VMEM-sized row blocks have no counterpart: any H >= 1 and
// any row count are taken as they are.
//
// What bounds it on the H100: bytes. At BERT-large's shape (8192 rows x
// 1024, bf16) it reads 16 MB and writes 16 MB, ~10 us at 3.35 TB/s,
// against ~8 fp32 operations per element.
//
// Design: a row is held in registers, so x is read once and both moments
// come from registers. For H <= 1024 one warp owns a row (four rows a
// block); each lane holds eight adjacent columns per 256-column chunk (one
// 16-byte load for bf16 or fp16, two for fp32), and the sums are warp
// shuffles.
// For 1024 < H <= 8192 one 256-thread block owns a row, eight adjacent
// columns per thread per 2048-column chunk (as B1, csrc/layer_norm_bwd.cu),
// and the warps' partials are added in warp order. Wider rows loop over
// their columns from memory, three passes (sum, centered squares, output).
// Every sum is taken in a fixed order: the result is deterministic. The
// weight and bias are read through the read-only path (__ldg). A tail
// where H is not a multiple of eight, or an unaligned pointer, takes the
// scalar loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int VPT = 8;               // adjacent columns per thread and chunk
constexpr int kMaxChunks = 4;        // chunks held in registers
constexpr int kWarpRows = 4;         // rows per block, warp-per-row kernel
constexpr int kBlockThreads = 256;   // threads per row, block-per-row kernels
constexpr int kWarpMaxH = 32 * VPT * kMaxChunks;             // 1024
constexpr int kBlockMaxH = kBlockThreads * VPT * kMaxChunks;  // 8192

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  return to_f32(v);
}
template <typename T>
__device__ __forceinline__ void from_f(float v, T* p) {
  *p = from_f32<T>(v);
}

__device__ __forceinline__ void load8(const float* p, float v[VPT], bool vec,
                                      int valid) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) v[j] = j < valid ? p[j] : 0.f;
  }
}

template <typename H>  // a 16-bit type: eight columns in one 16-byte load
__device__ __forceinline__ void load8(const H* p, float v[VPT], bool vec,
                                      int valid) {
  if (vec) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const H* e = reinterpret_cast<const H*>(&raw);
#pragma unroll
    for (int j = 0; j < VPT; ++j) v[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) v[j] = j < valid ? to_f32(p[j]) : 0.f;
  }
}

// the weight or bias: read-only, shared by every row
__device__ __forceinline__ void ldg8(const float* p, float v[VPT], bool vec,
                                     int valid) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) v[j] = j < valid ? __ldg(p + j) : 0.f;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[VPT], bool vec,
                                       int valid) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int j = 0; j < valid; ++j) p[j] = v[j];
  }
}

template <typename H>
__device__ __forceinline__ void store8(H* p, const float v[VPT], bool vec,
                                       int valid) {
  if (vec) {
    uint4 raw;
    H* e = reinterpret_cast<H*>(&raw);
#pragma unroll
    for (int j = 0; j < VPT; ++j) e[j] = from_f32<H>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    for (int j = 0; j < valid; ++j) p[j] = from_f32<H>(v[j]);
  }
}

// Sum of v over the threads of a row, the same in every one of them:
// shuffles within the warp, then (block per row) the warps' partials
// added in warp order.
template <bool WARP>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (WARP) return v;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nwarps; ++i) s += red[i];
  __syncthreads();  // red is reused by the next call
  return s;
}

// A row in registers: CHUNKS chunks of eight columns per thread. WARP: a
// warp per row, kWarpRows rows a block; else a block per row.
template <typename T, int CHUNKS, bool WARP>
__global__ void __launch_bounds__(WARP ? 32 * kWarpRows : kBlockThreads)
    ln_fwd_reg_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      int rows, int H, float eps, int rms, bool vec) {
  __shared__ float red[kBlockThreads / 32];
  const int t = WARP ? (threadIdx.x & 31) : threadIdx.x;
  const int width = WARP ? 32 : blockDim.x;
  const int row = WARP ? blockIdx.x * kWarpRows + (threadIdx.x >> 5)
                       : blockIdx.x;
  // a warp leaves whole: the warp kernel has no block-wide barrier
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * H;
  T* yr = y + static_cast<size_t>(row) * H;
  const float hf = static_cast<float>(H);
  float v[CHUNKS][VPT];
  int valid[CHUNKS];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int c0 = (c * width + t) * VPT;
    valid[c] = c0 < H ? min(VPT, H - c0) : 0;
    if (valid[c]) {
      load8(xr + c0, v[c], vec, valid[c]);
    } else {
#pragma unroll
      for (int j = 0; j < VPT; ++j) v[c][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) s += v[c][j];
  }
  const float mean = rms ? 0.f : row_sum<WARP>(s, red) / hf;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float d = j < valid[c] ? v[c][j] - mean : 0.f;
      v[c][j] = d;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(row_sum<WARP>(sq, red) / hf + eps);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (!valid[c]) continue;
    const int c0 = (c * width + t) * VPT;
    float wv[VPT], out[VPT];
    ldg8(w + c0, wv, vec, valid[c]);
#pragma unroll
    for (int j = 0; j < VPT; ++j) out[j] = v[c][j] * rstd * wv[j];
    if (b != nullptr) {
      float bv[VPT];
      ldg8(b + c0, bv, vec, valid[c]);
#pragma unroll
      for (int j = 0; j < VPT; ++j) out[j] += bv[j];
    }
    store8(yr + c0, out, vec, valid[c]);
  }
}

// Rows wider than registers hold: a block per row, three strided passes
// over the row in memory.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    ln_fwd_loop_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, T* __restrict__ y,
                       int rows, int H, float eps, int rms) {
  __shared__ float red[kBlockThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * H;
  T* yr = y + static_cast<size_t>(blockIdx.x) * H;
  const float hf = static_cast<float>(H);
  float s = 0.f;
  if (!rms)
    for (int j = threadIdx.x; j < H; j += blockDim.x) s += to_f(xr[j]);
  const float mean = rms ? 0.f : row_sum<false>(s, red) / hf;
  float sq = 0.f;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const float d = to_f(xr[j]) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(row_sum<false>(sq, red) / hf + eps);
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float o = (to_f(xr[j]) - mean) * rstd * __ldg(w + j);
    if (b != nullptr) o += __ldg(b + j);
    from_f(o, yr + j);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool WARP>
cudaError_t launch_reg(int chunks, int blocks, int threads, cudaStream_t s,
                       const T* x, const float* w, const float* b, T* y,
                       int rows, int H, float eps, int rms, bool vec) {
  switch (chunks) {
    case 1:
      ln_fwd_reg_kernel<T, 1, WARP><<<blocks, threads, 0, s>>>(
          x, w, b, y, rows, H, eps, rms, vec);
      break;
    case 2:
      ln_fwd_reg_kernel<T, 2, WARP><<<blocks, threads, 0, s>>>(
          x, w, b, y, rows, H, eps, rms, vec);
      break;
    case 3:
      ln_fwd_reg_kernel<T, 3, WARP><<<blocks, threads, 0, s>>>(
          x, w, b, y, rows, H, eps, rms, vec);
      break;
    default:
      ln_fwd_reg_kernel<T, 4, WARP><<<blocks, threads, 0, s>>>(
          x, w, b, y, rows, H, eps, rms, vec);
      break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* x, const float* w, const float* b, T* y,
                   int rows, int H, float eps, int rms, cudaStream_t s) {
  const bool vec = H % VPT == 0 && aligned16(x) && aligned16(y) &&
                   aligned16(w) && aligned16(b);
  if (H <= kWarpMaxH) {
    const int chunks = (H + 32 * VPT - 1) / (32 * VPT);
    return launch_reg<T, true>(chunks, (rows + kWarpRows - 1) / kWarpRows,
                               32 * kWarpRows, s, x, w, b, y, rows, H, eps,
                               rms, vec);
  }
  if (H <= kBlockMaxH) {
    const int chunks = (H + kBlockThreads * VPT - 1) / (kBlockThreads * VPT);
    return launch_reg<T, false>(chunks, rows, kBlockThreads, s, x, w, b, y,
                                rows, H, eps, rms, vec);
  }
  ln_fwd_loop_kernel<T><<<rows, kBlockThreads, 0, s>>>(x, w, b, y, rows, H,
                                                       eps, rms);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (x and y). w fp32 (H,), b
// fp32 (H,) or null. Everything contiguous.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, int rows, int H, int dtype, float eps,
                              int rms, void* stream) {
  if (rows < 1 || H < 1 || w == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0)
    return (int)launch<float>(static_cast<const float*>(x), wf, bf,
                              static_cast<float*>(y), rows, H, eps, rms, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), wf, bf,
        static_cast<__nv_bfloat16*>(y), rows, H, eps, rms, s);
  if (dtype == 2)
    return (int)launch<__half>(static_cast<const __half*>(x), wf, bf,
                               static_cast<__half*>(y), rows, H, eps, rms, s);
  return (int)cudaErrorInvalidValue;
}
