// Fused scale + mask + softmax, forward (kernels B6 and B7) and backward
// (kernel B8), CUDA C++ for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/softmax.py::_fwd_kernel (B6, wrapper
// _pallas_softmax_fwd, rows (N, Sk)), ::_fwd4_kernel (B7, wrapper
// _pallas_softmax_fwd4, (B, H, Sq, Sk) with a broadcast mask) and
// ::_bwd_kernel (B8, wrapper _pallas_softmax_bwd), the Pallas TPU kernels
// behind scaled_softmax, scaled_masked_softmax,
// scaled_upper_triang_masked_softmax and FusedScaleMaskSoftmax: BERT's
// attention softmax below flash_min_seq.
//
// Forward, per row r of x viewed as (rows, Sk), all in fp32, in the JAX
// kernels' order:
//   v = x * scale; then v += mask (mode add) or v = FILL where mask > 0
//   (mode fill); then v = FILL where k > q (causal), q = r % Sq the row's
//   query index; y = exp(v - max v) / sum exp(v - max v), written in x's
//   type. FILL = -30000 is finite, so a fully masked row comes out
//   uniform over its Sk keys, never NaN.
// The mask is fp32 with a contiguous last dim, read at row offset
//   b * sb + h * sh + q * sq for r = (b * H + h) * Sq + q, where a stride
//   of 0 broadcasts that axis. B6's route passes a full-size mask (or
//   none) and B7's a (B|1, H|1, Sq|1, Sk) mask as it is: one kernel, two
//   stride patterns.
// Backward, per row: dx = (scale * y) * (g - sum(g * y)), fp32, reading g
//   and the saved y in their own types and writing dx in g's type.
//
// What bounds it on the H100: bytes. At BERT-large's S 128 microbatch
// (64 x 16 x 128 rows of 128 keys, bf16) the forward reads and writes
// 33.5 MB each (~20 us at 3.35 TB/s) and the backward moves 100.7 MB
// (~30 us), against ~10 fp32 operations per element.
//
// Design. The TPU kernels tile rows into VMEM blocks padded to 128 lanes;
// here a warp owns a row and no padding exists: lanes past Sk take no
// part. Up to Sk = 512 the row lives in registers (4 adjacent elements a
// lane per 128-element chunk, one 8- or 16-byte load each where the row is
// aligned), so x is read once and y written once, with warp-shuffle max
// and sum. A longer row loops over the row in the same kernel family: an
// online max and sum in one pass over x, then a second pass that writes
// y (the backward: the dot product, then dx). Multiplies and adds of the
// scale and mask are explicitly rounded (__fmul_rn, __fadd_rn) so that the
// compiler cannot contract them into an FMA the JAX kernel does not do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kWarps = 8;               // rows per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr float kFill = -30000.f;       // apex_tpu.ops.softmax._NEG
constexpr int kMaskNone = 0, kMaskAdd = 1, kMaskFill = 2;

// four adjacent elements as one load/store (16 bytes fp32, 8 bytes bf16
// or fp16)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
template <typename H>  // a 16-bit type
__device__ __forceinline__ void load4(const H* p, float v[4]) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const H* e = reinterpret_cast<const H*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = to_f32(e[t]);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename H>
__device__ __forceinline__ void store4(H* p, const float v[4]) {
  uint2 raw;
  H* e = reinterpret_cast<H*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) e[t] = from_f32<H>(v[t]);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct MaskView {
  const float* m;               // null: no mask tile
  long long sb, sh, sq;         // element strides over (B, H, Sq)
  int H, Sq;                    // the row decomposition r = (b H + h) Sq + q
};

// Element k of row r before the softmax: scale, then the mask, then causal.
__device__ __forceinline__ float score(float x, int k, int q,
                                       const float* mrow, int mode,
                                       int causal, float scale) {
  float v = __fmul_rn(x, scale);
  if (mode == kMaskAdd)
    v = __fadd_rn(v, mrow[k]);
  else if (mode == kMaskFill)
    v = mrow[k] > 0.f ? kFill : v;
  if (causal && k > q) v = kFill;
  return v;
}

__device__ __forceinline__ const float* mask_row(const MaskView& mv,
                                                 long long row, int mode) {
  if (mode == kMaskNone) return nullptr;
  const long long q = row % mv.Sq;
  const long long bh = row / mv.Sq;
  const long long h = bh % mv.H;
  const long long b = bh / mv.H;
  return mv.m + b * mv.sb + h * mv.sh + q * mv.sq;
}

// Rows of up to 128 * CHUNKS keys, held in registers: lane l owns keys
// 4 (32 j + l) .. 4 (32 j + l) + 3 of chunk j.
template <typename T, int CHUNKS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    softmax_fwd_regs(const T* __restrict__ x, T* __restrict__ y,
                     long long rows, int Sk, MaskView mv, float scale,
                     int mode, int causal) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * Sk;
  T* yr = y + row * Sk;
  const int q = static_cast<int>(row % mv.Sq);
  const float* mr = mask_row(mv, row, mode);
  float v[CHUNKS][4];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int k0 = (j * 32 + lane) * 4;
    float xv[4];
    if (VEC && k0 < Sk) {
      load4(xr + k0, xv);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        xv[t] = k0 + t < Sk ? to_f32(xr[k0 + t]) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = k0 + t;
      if (k < Sk) {
        v[j][t] = score(xv[t], k, q, mr, mode, causal, scale);
        mx = fmaxf(mx, v[j][t]);
      } else {
        v[j][t] = -INFINITY;
      }
    }
  }
  mx = warp_max(mx);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float e = (j * 32 + lane) * 4 + t < Sk ? expf(v[j][t] - mx) : 0.f;
      v[j][t] = e;
      s += e;
    }
  s = warp_sum(s);
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int k0 = (j * 32 + lane) * 4;
    float out[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) out[t] = v[j][t] / s;
    if (VEC && k0 < Sk) {
      store4(yr + k0, out);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (k0 + t < Sk) yr[k0 + t] = from_f32<T>(out[t]);
    }
  }
}

// Any Sk: an online max and sum over the row, then a second pass that
// writes y. Each lane walks keys lane, lane + 32, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
    softmax_fwd_loop(const T* __restrict__ x, T* __restrict__ y,
                     long long rows, int Sk, MaskView mv, float scale,
                     int mode, int causal) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * Sk;
  T* yr = y + row * Sk;
  const int q = static_cast<int>(row % mv.Sq);
  const float* mr = mask_row(mv, row, mode);
  float mx = -INFINITY, s = 0.f;
  for (int k = lane; k < Sk; k += 32) {
    const float v = score(to_f32(xr[k]), k, q, mr, mode, causal, scale);
    if (v > mx) {
      s = s * expf(mx - v) + 1.f;
      mx = v;
    } else {
      s += expf(v - mx);
    }
  }
  // combine the lanes' (max, sum) pairs
  const float row_max = warp_max(mx);
  s = mx == -INFINITY ? 0.f : s * expf(mx - row_max);
  s = warp_sum(s);
  for (int k = lane; k < Sk; k += 32) {
    const float v = score(to_f32(xr[k]), k, q, mr, mode, causal, scale);
    yr[k] = from_f32<T>(expf(v - row_max) / s);
  }
}

template <typename TG, typename TY, int CHUNKS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_regs(const TG* __restrict__ g, const TY* __restrict__ y,
                     TG* __restrict__ dx, long long rows, int Sk,
                     float scale) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const TG* gr = g + row * Sk;
  const TY* yrow = y + row * Sk;
  TG* dr = dx + row * Sk;
  float gv[CHUNKS][4], yv[CHUNKS][4];
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int k0 = (j * 32 + lane) * 4;
    if (VEC && k0 < Sk) {
      load4(gr + k0, gv[j]);
      load4(yrow + k0, yv[j]);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool in = k0 + t < Sk;
        gv[j][t] = in ? to_f32(gr[k0 + t]) : 0.f;
        yv[j][t] = in ? to_f32(yrow[k0 + t]) : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) dot += gv[j][t] * yv[j][t];
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int k0 = (j * 32 + lane) * 4;
    float out[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      out[t] = __fmul_rn(__fmul_rn(scale, yv[j][t]), gv[j][t] - dot);
    if (VEC && k0 < Sk) {
      store4(dr + k0, out);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (k0 + t < Sk) dr[k0 + t] = from_f32<TG>(out[t]);
    }
  }
}

template <typename TG, typename TY>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_loop(const TG* __restrict__ g, const TY* __restrict__ y,
                     TG* __restrict__ dx, long long rows, int Sk,
                     float scale) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const TG* gr = g + row * Sk;
  const TY* yrow = y + row * Sk;
  TG* dr = dx + row * Sk;
  float dot = 0.f;
  for (int k = lane; k < Sk; k += 32)
    dot += to_f32(gr[k]) * to_f32(yrow[k]);
  dot = warp_sum(dot);
  for (int k = lane; k < Sk; k += 32)
    dr[k] = from_f32<TG>(__fmul_rn(__fmul_rn(scale, to_f32(yrow[k])),
                                   to_f32(gr[k]) - dot));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int grid_for(long long rows) {
  return static_cast<int>((rows + kWarps - 1) / kWarps);
}

template <typename T, int CH>
void fwd_regs(bool vec, int grid, cudaStream_t stream, const T* x, T* y,
              long long rows, int Sk, const MaskView& mv, float scale,
              int mode, int causal) {
  if (vec)
    softmax_fwd_regs<T, CH, true><<<grid, kThreads, 0, stream>>>(
        x, y, rows, Sk, mv, scale, mode, causal);
  else
    softmax_fwd_regs<T, CH, false><<<grid, kThreads, 0, stream>>>(
        x, y, rows, Sk, mv, scale, mode, causal);
}

template <typename T>
int launch_fwd(const void* xp, const float* mask, void* yp, long long rows,
               int Sk, MaskView mv, float scale, int mode, int causal,
               cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  mv.m = mask;
  const bool vec = Sk % 4 == 0 && aligned16(x) && aligned16(y);
  const int grid = grid_for(rows);
  if (Sk <= 128)
    fwd_regs<T, 1>(vec, grid, stream, x, y, rows, Sk, mv, scale, mode,
                   causal);
  else if (Sk <= 256)
    fwd_regs<T, 2>(vec, grid, stream, x, y, rows, Sk, mv, scale, mode,
                   causal);
  else if (Sk <= 512)
    fwd_regs<T, 4>(vec, grid, stream, x, y, rows, Sk, mv, scale, mode,
                   causal);
  else
    softmax_fwd_loop<T><<<grid, kThreads, 0, stream>>>(x, y, rows, Sk, mv,
                                                       scale, mode, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG, typename TY, int CH>
void bwd_regs(bool vec, int grid, cudaStream_t stream, const TG* g,
              const TY* y, TG* dx, long long rows, int Sk, float scale) {
  if (vec)
    softmax_bwd_regs<TG, TY, CH, true><<<grid, kThreads, 0, stream>>>(
        g, y, dx, rows, Sk, scale);
  else
    softmax_bwd_regs<TG, TY, CH, false><<<grid, kThreads, 0, stream>>>(
        g, y, dx, rows, Sk, scale);
}

template <typename TG, typename TY>
int launch_bwd(const void* gp, const void* yp, void* dxp, long long rows,
               int Sk, float scale, cudaStream_t stream) {
  const TG* g = static_cast<const TG*>(gp);
  const TY* y = static_cast<const TY*>(yp);
  TG* dx = static_cast<TG*>(dxp);
  const bool vec = Sk % 4 == 0 && aligned16(g) && aligned16(y) &&
                   aligned16(dx);
  const int grid = grid_for(rows);
  if (Sk <= 128)
    bwd_regs<TG, TY, 1>(vec, grid, stream, g, y, dx, rows, Sk, scale);
  else if (Sk <= 256)
    bwd_regs<TG, TY, 2>(vec, grid, stream, g, y, dx, rows, Sk, scale);
  else if (Sk <= 512)
    bwd_regs<TG, TY, 4>(vec, grid, stream, g, y, dx, rows, Sk, scale);
  else
    softmax_bwd_loop<TG, TY><<<grid, kThreads, 0, stream>>>(g, y, dx, rows,
                                                            Sk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int bwd_for_y(const void* g, const void* y, void* dx, long long rows, int Sk,
              int y_dtype, float scale, cudaStream_t s) {
  switch (y_dtype) {
    case 0: return launch_bwd<TG, float>(g, y, dx, rows, Sk, scale, s);
    case 1:
      return launch_bwd<TG, __nv_bfloat16>(g, y, dx, rows, Sk, scale, s);
    case 2: return launch_bwd<TG, __half>(g, y, dx, rows, Sk, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16. x, y contiguous (rows,
// Sk). mask:
// fp32, null when mask_mode is 0 (none), else read at b * sb + h * sh +
// q * sq for row (b * H + h) * Sq + q (1 add, 2 fill), its last dim
// contiguous and 16-byte aligned rows where Sk % 4 == 0.
extern "C" int softmax_fwd(const void* x, const void* mask, void* y,
                           long long rows, int Sk, int H, int Sq,
                           long long sb, long long sh, long long sq,
                           int dtype, float scale, int mask_mode, int causal,
                           void* stream) {
  if (rows < 1 || Sk < 1 || H < 1 || Sq < 1 || mask_mode < 0 ||
      mask_mode > 2 || (mask_mode != 0 && mask == nullptr) ||
      (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MaskView mv{nullptr, sb, sh, sq, H, Sq};
  const float* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch_fwd<float>(x, m, y, rows, Sk, mv, scale, mask_mode,
                             causal, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, m, y, rows, Sk, mv, scale,
                                     mask_mode, causal, s);
  if (dtype == 2)
    return launch_fwd<__half>(x, m, y, rows, Sk, mv, scale, mask_mode,
                              causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g, y, dx contiguous (rows, Sk), each of the forward's dtype codes; dx in
// g's type.
extern "C" int softmax_bwd(const void* g, const void* y, void* dx,
                           long long rows, int Sk, int g_dtype, int y_dtype,
                           float scale, void* stream) {
  if (rows < 1 || Sk < 1 || (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case 0: return bwd_for_y<float>(g, y, dx, rows, Sk, y_dtype, scale, s);
    case 1:
      return bwd_for_y<__nv_bfloat16>(g, y, dx, rows, Sk, y_dtype, scale, s);
    case 2: return bwd_for_y<__half>(g, y, dx, rows, Sk, y_dtype, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
