// LayerNorm / RMSNorm backward (kernel B1), CUDA C++ for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm.py::_bwd_kernel (wrapper
// _pallas_backward), the Pallas TPU backward behind
// fused_layer_norm_affine and fused_rms_norm_affine.
//
// Computes, for rows x (R, H) and their output gradients g (R, H), both
// fp32, both bf16 or both fp16, and an fp32 weight w (H,):
//   mean = sum(x) / H (0 for RMSNorm), var = sum((x - mean)^2) / H,
//   rstd = rsqrt(var + eps), xhat = (x - mean) * rstd, wg = g * w,
//   dx = (wg - xhat * sum(wg * xhat) / H - sum(wg) / H) * rstd
//        (RMSNorm drops the last sum),
//   dgamma = sum over rows of g * xhat, dbeta = sum over rows of g,
// all in fp32; dx is written in x's dtype, dgamma and dbeta in fp32. Like
// the TPU kernel it recomputes mean and rstd from x instead of reading
// saved statistics.
//
// What bounds it on the H100: bytes. At the BERT-large shape (8192 rows x
// 1024, bf16) it reads g and x and writes dx, 50 MB, ~15 us at 3.35 TB/s,
// against ~10 fp32 operations per element.
//
// Design: the TPU kernel accumulates dgamma/dbeta across its sequential
// row-block grid in VMEM; Hopper's blocks run in parallel and in no order.
// Here each block owns a run of rows and each thread eight adjacent
// columns (one 16-byte load for bf16 or fp16): per row the block reduces
// the two moments and the two dx sums (warp shuffles, then the warps' partials
// added in a fixed order), writes dx, and adds g * xhat and g into
// per-thread fp32 column accumulators. At the end each block writes its
// column partials to a workspace, and a second kernel adds the blocks'
// partials column by column in block order. No atomics: the result is
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int VPT = 8;          // adjacent columns per thread
constexpr int kMaxThreads = 1024;

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

// Sum of (a, b) over the block, the same in every thread: shuffles within
// each warp, then the warps' partials added in warp order.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int i = 0; i < nwarps; ++i) {
    a += red[i].x;
    b += red[i].y;
  }
  __syncthreads();  // red is reused by the next call
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    ln_bwd_rows_kernel(const T* __restrict__ g, const T* __restrict__ x,
                       const float* __restrict__ w, T* __restrict__ dx,
                       float* __restrict__ dw_part,
                       float* __restrict__ db_part, int rows, int H,
                       int rows_per_block, float eps, int rms, bool vec) {
  __shared__ float2 red[kMaxThreads / 32];
  const int c0 = threadIdx.x * VPT;
  const int valid = c0 < H ? min(VPT, H - c0) : 0;
  const bool v8 = vec && valid == VPT;
  const float inv_h = 1.f / static_cast<float>(H);
  float wv[VPT], adw[VPT], adb[VPT];
  load8(w + (valid ? c0 : 0), wv, false, valid);
#pragma unroll
  for (int j = 0; j < VPT; ++j) adw[j] = adb[j] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const size_t off = static_cast<size_t>(r) * H + (valid ? c0 : 0);
    float xv[VPT], gv[VPT];
    load8(x + off, xv, v8, valid);
    load8(g + off, gv, v8, valid);
    float s = 0.f, unused = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) s += xv[j];
    float mean = 0.f;
    if (!rms) {
      block_sum2(s, unused, red);
      mean = s * inv_h;
    }
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float c = j < valid ? xv[j] - mean : 0.f;
      xv[j] = c;
      sq += c * c;
    }
    unused = 0.f;
    block_sum2(sq, unused, red);
    const float rstd = rsqrtf(sq * inv_h + eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      xv[j] *= rstd;                 // xhat
      const float wg = gv[j] * wv[j];
      a += wg * xv[j];
      b += wg;
    }
    block_sum2(a, b, red);
    const float c1 = a * inv_h;
    const float c2 = rms ? 0.f : b * inv_h;
    float out[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      out[j] = (gv[j] * wv[j] - xv[j] * c1 - c2) * rstd;
      adw[j] += gv[j] * xv[j];
      adb[j] += gv[j];
    }
    if (valid) store8(dx + off, out, v8, valid);
  }
  if (valid) {
    const size_t p = static_cast<size_t>(blockIdx.x) * H + c0;
    store8(dw_part + p, adw, false, valid);
    store8(db_part + p, adb, false, valid);
  }
}

// dgamma[c] (and dbeta[c]) = sum over blocks, in block order, of the
// partials of column c.
__global__ void ln_bwd_sum_kernel(const float* __restrict__ dw_part,
                                  const float* __restrict__ db_part,
                                  float* __restrict__ dw,
                                  float* __restrict__ db, int blocks, int H) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= H) return;
  float sw = 0.f, sb = 0.f;
  for (int i = 0; i < blocks; ++i) {
    sw += dw_part[static_cast<size_t>(i) * H + c];
    sb += db_part[static_cast<size_t>(i) * H + c];
  }
  dw[c] = sw;
  db[c] = sb;
}

int threads_for(int H) {
  const int t = ((H + VPT - 1) / VPT + 31) / 32 * 32;
  return t;
}

}  // namespace

// How many row blocks layer_norm_bwd uses for (rows, H): about four per SM,
// each owning a run of rows. The caller sizes the workspace from it:
// 2 * blocks * H floats.
extern "C" int layer_norm_bwd_blocks(int rows, int H) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int target = 4 * sms;
  const int per = (rows + target - 1) / target;
  return (rows + per - 1) / per;
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (g, x and dx). w, dw,
// db fp32.
// Everything contiguous; workspace holds 2 * blocks * H floats.
extern "C" int layer_norm_bwd(const void* g, const void* x, const void* w,
                              void* dx, void* dw, void* db, void* workspace,
                              int rows, int H, int dtype, float eps, int rms,
                              void* stream) {
  if (rows < 1 || H < 1 || threads_for(H) > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = layer_norm_bwd_blocks(rows, H);
  const int per = (rows + blocks - 1) / blocks;
  const int threads = threads_for(H);
  float* dw_part = static_cast<float*>(workspace);
  float* db_part = dw_part + static_cast<size_t>(blocks) * H;
  const bool vec = H % VPT == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (dtype == 0)
    ln_bwd_rows_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<const float*>(w), static_cast<float*>(dx), dw_part,
        db_part, rows, H, per, eps, rms, vec);
  else if (dtype == 1)
    ln_bwd_rows_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(dx), dw_part, db_part, rows, H, per, eps,
        rms, vec);
  else if (dtype == 2)
    ln_bwd_rows_kernel<__half><<<blocks, threads, 0, s>>>(
        static_cast<const __half*>(g), static_cast<const __half*>(x),
        static_cast<const float*>(w), static_cast<__half*>(dx), dw_part,
        db_part, rows, H, per, eps, rms, vec);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_sum_kernel<<<(H + 255) / 256, 256, 0, s>>>(
      dw_part, db_part, static_cast<float*>(dw), static_cast<float*>(db),
      blocks, H);
  return (int)cudaGetLastError();
}
