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
// Design: a row is held on chip, so x is read once and both moments come
// from the copy. For H <= 1024 one warp owns a row (four rows a block);
// each lane holds eight adjacent columns per 256-column chunk in
// registers (one 16-byte load for bf16 or fp16, two for fp32), and the
// sums are warp shuffles. For 1024 < H <= 8192 one 256-thread block owns a
// row, eight adjacent columns per thread per 2048-column chunk in
// registers (as B1, csrc/layer_norm_bwd.cu), and the warps' partials are
// added in warp order.
// Wider rows (ln_fwd_slice_kernel) are staged into shared memory in x's
// own dtype by 16-byte cp.async copies, all in flight at once, and both
// moments and the output are taken from that copy. A row of up to 48 KB
// (24,576 16-bit or 12,288 fp32 columns) is one block's; a wider row is
// cut into slices of at most 48 KB, one a block, over a thread-block
// cluster of up to 8 blocks (so that several blocks share an SM and one
// row's arithmetic overlaps another's loads). The blocks of a cluster
// exchange their partial sums through distributed shared memory and add
// them in rank order (measured on the H100: 32 KB slices, 128 or 512
// threads a block, and 2 or 4 rows a block sharing their weight loads were
// slower). Up to 1 MiB a row (262,144 fp32 or 524,288 16-bit columns:
// 128 KB a block at a cluster of 8) is staged. A wider row is streamed by
// the same kernel without the staging: each of the 8 blocks of its cluster
// owns one contiguous eighth of the row and reads it three times, once per
// pass of the formula (the sum, then the sum of squares about the mean,
// then y), the second and third reads from L2 where the rows in flight
// fit its 50 MB. Such rows come from a multi-dim normalized_shape
// flattened into one row, as (128, 4096) in fp32.
// Every sum is taken in a fixed order: the result is deterministic. The
// weight and bias are read through the read-only path (__ldg). A tail
// where H is not a multiple of eight, or an unaligned pointer, takes the
// scalar loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "dtypes.cuh"

namespace {

constexpr int VPT = 8;               // adjacent columns per thread and chunk
constexpr int kMaxChunks = 4;        // chunks held in registers
constexpr int kWarpRows = 4;         // rows per block, warp-per-row kernel
constexpr int kBlockThreads = 256;   // threads per row, block-per-row kernels
constexpr int kWarpMaxH = 32 * VPT * kMaxChunks;             // 1024
constexpr int kBlockMaxH = kBlockThreads * VPT * kMaxChunks;  // 8192
constexpr int kMaxCluster = 8;        // blocks a row past kBlockMaxH
constexpr int kSliceBytes = 48 * 1024;  // the widest slice a block stages
constexpr int kMaxStagedBytes = 1 << 20;  // kMaxCluster slices of 128 KB

namespace cg = cooperative_groups;

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

// The sum of the cluster's block partials v (each block's the same in
// all its threads), added in rank order through distributed shared
// memory; slot is this block's word for it. The caller's next cluster
// barrier keeps the slot alive until every block has read it.
__device__ __forceinline__ float cluster_sum(float v, float* slot, int cl) {
  if (cl == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  float s = 0.f;
  for (int r = 0; r < cl; ++r) s += *cluster.map_shared_rank(slot, r);
  return s;
}

// Rows wider than registers hold: block `rank` of a cluster of cl owns
// columns [rank * slice, (rank + 1) * slice) of a row, staged once into
// shared memory (STAGE) or read from device memory by each pass. vec:
// 16-byte loads, chunks of eight columns (H a multiple of eight, every
// pointer 16-byte aligned); else element by element.
template <typename T, bool STAGE>
__global__ void __launch_bounds__(kBlockThreads)
    ln_fwd_slice_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, T* __restrict__ y,
                        int H, int cl, int slice, float eps, int rms,
                        bool vec) {
  constexpr int kCopy = 16 / sizeof(T);  // columns a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ float red[kBlockThreads / 32];
  __shared__ float slots[2];  // this block's partial sum, then squares
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % cl;
  const size_t row = blockIdx.x / cl;
  const int c0 = rank * slice;
  const int n = max(0, min(H - c0, slice));
  const T* xr = x + row * H + c0;
  T* yr = y + row * H + c0;
  const float* wr = w + c0;
  const float* br = b == nullptr ? nullptr : b + c0;
  const float hf = static_cast<float>(H);

  if (STAGE) {
    if (vec) {
      for (int c = tid; c < n / kCopy; c += kBlockThreads)
        cp_async16(xs + c * kCopy, xr + c * kCopy);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      for (int j = tid; j < n; j += kBlockThreads) xs[j] = xr[j];
    }
    __syncthreads();
  } else {
    xs = const_cast<T*>(xr);  // the passes below read device memory
  }

  float mean = 0.f;
  if (!rms) {
    float s = 0.f;
    if (vec) {
#pragma unroll 4
      for (int c = tid; c < n / VPT; c += kBlockThreads) {
        float v[VPT];
        load8(xs + c * VPT, v, true, VPT);
#pragma unroll
        for (int j = 0; j < VPT; ++j) s += v[j];
      }
    } else {
      for (int j = tid; j < n; j += kBlockThreads) s += to_f(xs[j]);
    }
    mean = cluster_sum(row_sum<false>(s, red), &slots[0], cl) / hf;
  }
  float sq = 0.f;
  if (vec) {
#pragma unroll 4
    for (int c = tid; c < n / VPT; c += kBlockThreads) {
      float v[VPT];
      load8(xs + c * VPT, v, true, VPT);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const float d = v[j] - mean;
        sq += d * d;
      }
    }
  } else {
    for (int j = tid; j < n; j += kBlockThreads) {
      const float d = to_f(xs[j]) - mean;
      sq += d * d;
    }
  }
  const float rstd =
      rsqrtf(cluster_sum(row_sum<false>(sq, red), &slots[1], cl) / hf + eps);
  // done with the other blocks' slots: they may leave once this block's
  // arrival is seen, and it waits for theirs only before leaving itself
  if (cl > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  if (vec) {
    for (int c = tid; c < n / VPT; c += kBlockThreads) {
      // the weight and bias loads first, both in flight together
      float wv[VPT], bv[VPT], v[VPT], out[VPT];
      ldg8(wr + c * VPT, wv, true, VPT);
      if (br != nullptr) ldg8(br + c * VPT, bv, true, VPT);
      load8(xs + c * VPT, v, true, VPT);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        out[j] = (v[j] - mean) * rstd * wv[j];
        if (br != nullptr) out[j] += bv[j];
      }
      store8(yr + c * VPT, out, true, VPT);
    }
  } else {
    for (int j = tid; j < n; j += kBlockThreads) {
      float o = (to_f(xs[j]) - mean) * rstd * __ldg(wr + j);
      if (br != nullptr) o += __ldg(br + j);
      from_f(o, yr + j);
    }
  }
  if (cl > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
  // past kBlockMaxH: the fewest blocks a row whose slices stay within
  // kSliceBytes, each slice a whole number of 8-column chunks; past
  // kMaxStagedBytes a cluster of kMaxCluster streaming blocks
  const long long row_bytes = static_cast<long long>(H) * sizeof(T);
  const bool stage = row_bytes <= kMaxStagedBytes;
  long long blocks = (row_bytes + kSliceBytes - 1) / kSliceBytes;
  if (blocks > kMaxCluster) blocks = kMaxCluster;
  const int cl = static_cast<int>(blocks);
  const int slice = static_cast<int>(
      ((static_cast<long long>(H) + cl - 1) / cl + VPT - 1) / VPT * VPT);
  const int smem = stage ? slice * static_cast<int>(sizeof(T)) : 0;
  auto kernel = stage ? ln_fwd_slice_kernel<T, true>
                      : ln_fwd_slice_kernel<T, false>;
  static int configured = 0;  // the largest opt-in granted so far
  if (stage && smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * cl);
  cfg.blockDim = dim3(kBlockThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, x, w, b, y, H, cl, slice, eps, rms, vec);
  return cudaGetLastError();  // and clears it
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (x and y). w fp32 (H,), b
// fp32 (H,) or null. Everything contiguous; any H >= 1.
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
