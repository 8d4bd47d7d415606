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
//   v = x * scale; then v += mask (mode add, an fp32 mask) or v = fill
//   where the mask is set (mode fill, a 1-byte mask); then v = FILL where
//   k > q (causal), q the row's query index; y = exp(v - max v) /
//   sum exp(v - max v), written in x's type. FILL = -30000 is finite, so
//   a fully masked row comes out uniform over its Sk keys, never NaN.
//   The wrapper picks fill: FILL (the JAX fill route) or the product
//   (FILL / scale rounded to x's type) * scale, which is what the JAX
//   package's pre-fold of a boolean mask into x gives after the kernel's
//   multiply: the boolean mask is read here instead of being folded into
//   a copy of x first.
// The mask has a contiguous last dim and is read at row offset
//   b * sb + h * sh + q * sq for r = (b * H + h) * Sq + q, where a stride
//   of 0 broadcasts that axis: BERT's (B, 1, 1, Sk) boolean key mask is
//   Sk bytes a row, shared by the H * Sq rows of a sample (L1-resident).
//   The row is split into (b, h, q) by multiply-and-shift division (host
//   magic numbers, 32-bit) wherever rows < 2^31.
// Backward, per row: dx = (scale * y) * (g - sum(g * y)), fp32, reading g
//   and the saved y in their own types and writing dx in g's type; with a
//   1-byte mask, dx = 0 where it is set (the gradient the pre-fold's
//   where gives x at a masked key).
//
// What bounds it on the H100: bytes. At BERT-large's S 128 microbatch
// (64 x 16 x 128 rows of 128 keys, bf16) the forward reads and writes
// 33.5 MB each (~20 us at 3.35 TB/s) and the backward moves 100.7 MB
// (~30 us), against ~10 fp32 operations per element.
//
// Forward design (Sk <= 512). A row lives in the registers of a lane
// group: 16 lanes where one 16-byte load a lane covers it (16-bit Sk <=
// 128), else a warp, each lane one or more 16-byte chunks of adjacent
// keys. A lane group holds R rows at once (R chunks-worth of loads in
// flight a lane, 4 for one chunk a row), every load of the R rows issued
// before the first reduction, so a warp keeps 2 KB in flight and an SM
// tens of KB. A block of 8 warps owns 64 rows at 16-bit Sk <= 128 (2,048
// blocks at BERT's shape, not 16,384 of 8 rows). (Measured on the H100 by
// tools/softmax_variants.py: persistent blocks capped at one wave of
// resident blocks, 2 or 8 rows a lane group, evict-first loads or stores
// and L2 256-byte prefetch loads were no faster.) The exponential is
// ex2.approx of (v - max) * log2(e) and the normalisation one reciprocal
// a row times each element: an IEEE divide an element takes its slow path
// on the zeros of masked keys (0 / s; it made pre-folded rows 25% slower
// than unmasked ones on the H100). Past Sk 512 a warp loops over the row:
// an online max and sum in one pass over x, a second pass that writes y.
// Multiplies and adds of the scale and mask are explicitly rounded
// (__fmul_rn, __fadd_rn) so that the compiler cannot contract them into an
// FMA the JAX kernel does not do.
// Backward design: a warp a row, 4 adjacent elements a lane a 128-key
// chunk in registers up to Sk 512, a loop past it; the mask's bytes are
// read only where it is given.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kWarps = 8;               // warps per block
constexpr int kThreads = kWarps * 32;
constexpr float kFill = -30000.f;       // apex_tpu.ops.softmax._NEG
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaskNone = 0, kMaskAdd = 1, kMaskFill = 2;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (the round-up
// method: mul = ceil(2^(31 + ceil(log2 d)) / d)).
struct FastDiv {
  unsigned int d, mul, shift;
};

FastDiv make_fastdiv(unsigned int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned int l = 0;
    while ((1ull << l) < d) ++l;
    const unsigned long long p = 31ull + l;
    f.mul = static_cast<unsigned int>(((1ull << p) + d - 1) / d);
    f.shift = static_cast<unsigned int>(p - 32);
  }
  return f;
}

__device__ __forceinline__ unsigned int fdiv(unsigned int n,
                                             const FastDiv& f) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shift;
}

struct MaskView {
  const void* m;                // fp32 (add) or 1 byte (fill); null: none
  long long sb, sh, sq;         // element strides over (B, H, Sq)
  FastDiv div_sq, div_h;        // r = (b H + h) Sq + q
  int wide;                     // rows >= 2^31: 64-bit division
};

// (q, offset of the row's mask) of row r.
__device__ __forceinline__ void row_index(const MaskView& mv, long long r,
                                          int& q, long long& moff) {
  long long b, h, qq;
  if (!mv.wide) {
    const unsigned int ru = static_cast<unsigned int>(r);
    const unsigned int bh = fdiv(ru, mv.div_sq);
    const unsigned int bu = fdiv(bh, mv.div_h);
    qq = ru - bh * mv.div_sq.d;
    h = bh - bu * mv.div_h.d;
    b = bu;
  } else {
    qq = r % mv.div_sq.d;
    const long long bh = r / mv.div_sq.d;
    h = bh % mv.div_h.d;
    b = bh / mv.div_h.d;
  }
  q = static_cast<int>(qq);
  moff = b * mv.sb + h * mv.sh + qq * mv.sq;
}

// E adjacent elements as one 16-byte vector
template <typename T>
struct Vec {
  static constexpr int E = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float v[]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int t = 0; t < Vec<T>::E; ++t) v[t] = to_f32(e[t]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float v[]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int t = 0; t < Vec<T>::E; ++t) e[t] = from_f32<T>(v[t]);
  return raw;
}

// Forward over rows of up to G * C * E keys in registers: lane group
// (G lanes) g of a warp owns rows base + j * (32 / G) + g, j < R; lane l
// of the group holds keys (c G + l) E .. (c G + l) E + E - 1 of chunk c.
// vec: 16-byte loads and stores (Sk % E == 0, x and y aligned); mvec: the
// mask read E elements at once too.
template <typename T, int G, int C, int R, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    softmax_fwd_regs(const T* __restrict__ x, T* __restrict__ y,
                     long long rows, int Sk, MaskView mv, float scale,
                     float fill, int causal, int vec, int mvec) {
  constexpr int E = Vec<T>::E;
  constexpr int S = 32 / G;                 // rows a warp covers at once
  const int lane = threadIdx.x & 31;
  const int li = lane % G;
  const int grp = lane / G;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      S * R;
  if (base >= rows) return;  // a warp leaves whole: no block-wide barrier
  uint4 raw[R][C];
  // the add mask's values, or the fill mask's bytes four to a word
  float ma[R][C][MODE == kMaskAdd ? E : 1];
  uint32_t mw[R][C][MODE == kMaskFill ? E / 4 : 1];
  int q[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long row = base + j * S + grp;
    const bool live = row < rows;
    const T* xr = x + (live ? row : 0) * Sk;
    long long moff = 0;
    q[j] = 0;
    if (live && (MODE != kMaskNone || causal)) row_index(mv, row, q[j], moff);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k0 = (c * G + li) * E;
      const bool in = live && k0 < Sk;
      raw[j][c] = make_uint4(0u, 0u, 0u, 0u);
      if (in && vec) {
        raw[j][c] = *reinterpret_cast<const uint4*>(xr + k0);
      } else if (in) {
        T* e = reinterpret_cast<T*>(&raw[j][c]);
#pragma unroll
        for (int t = 0; t < E; ++t)
          if (k0 + t < Sk) e[t] = xr[k0 + t];
      }
      if constexpr (MODE == kMaskAdd) {
        const float* mr = static_cast<const float*>(mv.m) + moff + k0;
#pragma unroll
        for (int t = 0; t < E; ++t) ma[j][c][t] = 0.f;
        if (in && mvec) {
#pragma unroll
          for (int t = 0; t < E; t += 4) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(mr + t));
            ma[j][c][t] = a.x; ma[j][c][t + 1] = a.y;
            ma[j][c][t + 2] = a.z; ma[j][c][t + 3] = a.w;
          }
        } else if (in) {
#pragma unroll
          for (int t = 0; t < E; ++t)
            if (k0 + t < Sk) ma[j][c][t] = __ldg(mr + t);
        }
      } else if constexpr (MODE == kMaskFill) {
        const uint8_t* mr = static_cast<const uint8_t*>(mv.m) + moff + k0;
#pragma unroll
        for (int w = 0; w < E / 4; ++w) mw[j][c][w] = 0u;
        if (in && mvec) {
          if constexpr (E == 8) {
            const uint2 a = __ldg(reinterpret_cast<const uint2*>(mr));
            mw[j][c][0] = a.x;
            mw[j][c][1] = a.y;
          } else {
            mw[j][c][0] = __ldg(reinterpret_cast<const unsigned int*>(mr));
          }
        } else if (in) {
#pragma unroll
          for (int t = 0; t < E; ++t)
            if (k0 + t < Sk)
              mw[j][c][t / 4] |= static_cast<uint32_t>(__ldg(mr + t))
                                 << (8 * (t % 4));
        }
      }
    }
  }
  // scores and the row max
  float v[R][C][E], mx[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    mx[j] = -INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float xv[E];
      unpack<T>(raw[j][c], xv);
      const int k0 = (c * G + li) * E;
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const int k = k0 + t;
        float s = __fmul_rn(xv[t], scale);
        if constexpr (MODE == kMaskAdd) s = __fadd_rn(s, ma[j][c][t]);
        if constexpr (MODE == kMaskFill)
          if ((mw[j][c][t / 4] >> (8 * (t % 4))) & 0xffu) s = fill;
        if (causal && k > q[j]) s = kFill;
        v[j][c][t] = k < Sk ? s : -INFINITY;
        mx[j] = fmaxf(mx[j], v[j][c][t]);
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
  float sum[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    sum[j] = 0.f;
    // a row past the end has mx -inf: keep its arithmetic finite
    const float m = mx[j] == -INFINITY ? 0.f : mx[j];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const float e = ex2((v[j][c][t] - m) * kLog2e);
        v[j][c][t] = e;
        sum[j] += e;
      }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], off);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long row = base + j * S + grp;
    if (row >= rows) continue;
    const float inv = 1.f / sum[j];
    T* yr = y + row * Sk;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k0 = (c * G + li) * E;
      if (k0 >= Sk) continue;
      float out[E];
#pragma unroll
      for (int t = 0; t < E; ++t) out[t] = v[j][c][t] * inv;
      if (vec) {
        *reinterpret_cast<uint4*>(yr + k0) = pack<T>(out);
      } else {
#pragma unroll
        for (int t = 0; t < E; ++t)
          if (k0 + t < Sk) yr[k0 + t] = from_f32<T>(out[t]);
      }
    }
  }
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

// Element k of a row before the softmax: scale, then the mask, then causal.
__device__ __forceinline__ float score(float x, int k, int q,
                                       const void* mrow, int mode,
                                       int causal, float scale, float fill) {
  float v = __fmul_rn(x, scale);
  if (mode == kMaskAdd)
    v = __fadd_rn(v, __ldg(static_cast<const float*>(mrow) + k));
  else if (mode == kMaskFill && __ldg(static_cast<const uint8_t*>(mrow) + k))
    v = fill;
  if (causal && k > q) v = kFill;
  return v;
}

__device__ __forceinline__ const void* mask_row(const MaskView& mv,
                                                long long moff, int mode) {
  if (mode == kMaskAdd) return static_cast<const float*>(mv.m) + moff;
  if (mode == kMaskFill) return static_cast<const uint8_t*>(mv.m) + moff;
  return nullptr;
}

// Any Sk: a warp a row, an online max and sum over the row, then a second
// pass that writes y. Each lane walks keys lane, lane + 32, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
    softmax_fwd_loop(const T* __restrict__ x, T* __restrict__ y,
                     long long rows, int Sk, MaskView mv, float scale,
                     int mode, float fill, int causal) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * Sk;
  T* yr = y + row * Sk;
  int q = 0;
  long long moff = 0;
  if (mode != kMaskNone || causal) row_index(mv, row, q, moff);
  const void* mr = mask_row(mv, moff, mode);
  float mx = -INFINITY, s = 0.f;
  for (int k = lane; k < Sk; k += 32) {
    const float v = score(to_f32(xr[k]), k, q, mr, mode, causal, scale, fill);
    if (v > mx) {
      s = s * ex2((mx - v) * kLog2e) + 1.f;
      mx = v;
    } else {
      s += ex2((v - mx) * kLog2e);
    }
  }
  // combine the lanes' (max, sum) pairs
  const float row_max = warp_max(mx);
  s = mx == -INFINITY ? 0.f : s * ex2((mx - row_max) * kLog2e);
  const float inv = 1.f / warp_sum(s);
  for (int k = lane; k < Sk; k += 32) {
    const float v = score(to_f32(xr[k]), k, q, mr, mode, causal, scale, fill);
    yr[k] = from_f32<T>(ex2((v - row_max) * kLog2e) * inv);
  }
}

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

// Backward, a warp a row of up to 128 * CHUNKS keys in registers: lane l
// owns keys 4 (32 j + l) .. 4 (32 j + l) + 3 of chunk j. With a mask
// (mv.m, 1 byte), dx = 0 where it is set.
template <typename TG, typename TY, int CHUNKS, bool VEC>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_regs(const TG* __restrict__ g, const TY* __restrict__ y,
                     TG* __restrict__ dx, long long rows, int Sk,
                     MaskView mv, float scale) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const TG* gr = g + row * Sk;
  const TY* yrow = y + row * Sk;
  TG* dr = dx + row * Sk;
  const uint8_t* mr = nullptr;
  if (mv.m != nullptr) {
    int q;
    long long moff;
    row_index(mv, row, q, moff);
    mr = static_cast<const uint8_t*>(mv.m) + moff;
  }
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
    for (int t = 0; t < 4; ++t) {
      out[t] = __fmul_rn(__fmul_rn(scale, yv[j][t]), gv[j][t] - dot);
      if (mr != nullptr && k0 + t < Sk && __ldg(mr + k0 + t)) out[t] = 0.f;
    }
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
                     MaskView mv, float scale) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const TG* gr = g + row * Sk;
  const TY* yrow = y + row * Sk;
  TG* dr = dx + row * Sk;
  const uint8_t* mr = nullptr;
  if (mv.m != nullptr) {
    int q;
    long long moff;
    row_index(mv, row, q, moff);
    mr = static_cast<const uint8_t*>(mv.m) + moff;
  }
  float dot = 0.f;
  for (int k = lane; k < Sk; k += 32)
    dot += to_f32(gr[k]) * to_f32(yrow[k]);
  dot = warp_sum(dot);
  for (int k = lane; k < Sk; k += 32) {
    float d = __fmul_rn(__fmul_rn(scale, to_f32(yrow[k])),
                        to_f32(gr[k]) - dot);
    if (mr != nullptr && __ldg(mr + k)) d = 0.f;
    dr[k] = from_f32<TG>(d);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int grid_for(long long rows) {
  return static_cast<int>((rows + kWarps - 1) / kWarps);
}

template <typename T, int G, int C, int R, int MODE>
void fwd_regs(cudaStream_t stream, const T* x, T* y, long long rows, int Sk,
              const MaskView& mv, float scale, float fill, int causal,
              int vec, int mvec) {
  const long long per_block = static_cast<long long>(kWarps) * (32 / G) * R;
  const long long blocks = (rows + per_block - 1) / per_block;
  softmax_fwd_regs<T, G, C, R, MODE>
      <<<static_cast<int>(blocks), kThreads, 0, stream>>>(
          x, y, rows, Sk, mv, scale, fill, causal, vec, mvec);
}

template <typename T, int G, int C, int R>
void fwd_mode(int mode, cudaStream_t stream, const T* x, T* y,
              long long rows, int Sk, const MaskView& mv, float scale,
              float fill, int causal, int vec, int mvec) {
  if (mode == kMaskAdd)
    fwd_regs<T, G, C, R, kMaskAdd>(stream, x, y, rows, Sk, mv, scale, fill,
                                   causal, vec, mvec);
  else if (mode == kMaskFill)
    fwd_regs<T, G, C, R, kMaskFill>(stream, x, y, rows, Sk, mv, scale, fill,
                                    causal, vec, mvec);
  else
    fwd_regs<T, G, C, R, kMaskNone>(stream, x, y, rows, Sk, mv, scale, fill,
                                    causal, vec, mvec);
}

template <typename T>
int launch_fwd(const void* xp, void* yp, long long rows, int Sk,
               const MaskView& mv, float scale, int mode, float fill,
               int causal, cudaStream_t stream) {
  constexpr int E = Vec<T>::E;
  const T* x = static_cast<const T*>(xp);
  T* y = static_cast<T*>(yp);
  const int vec = Sk % E == 0 && aligned(x, 16) && aligned(y, 16);
  // the mask read E elements at once: whole vectors at every row start
  const int mvec = vec && mv.m != nullptr &&
                   aligned(mv.m, mode == kMaskAdd ? 16 : E) &&
                   mv.sb % E == 0 && mv.sh % E == 0 && mv.sq % E == 0;
  if (Sk <= 16 * E)
    fwd_mode<T, 16, 1, 4>(mode, stream, x, y, rows, Sk, mv, scale, fill,
                          causal, vec, mvec);
  else if (Sk <= 32 * E)
    fwd_mode<T, 32, 1, 4>(mode, stream, x, y, rows, Sk, mv, scale, fill,
                          causal, vec, mvec);
  else if (Sk <= 64 * E)
    fwd_mode<T, 32, 2, 2>(mode, stream, x, y, rows, Sk, mv, scale, fill,
                          causal, vec, mvec);
  else if (E == 4 && Sk <= 128 * E) {
    if constexpr (E == 4)  // fp32 to 512 keys: four chunks a lane
      fwd_mode<T, 32, 4, 1>(mode, stream, x, y, rows, Sk, mv, scale, fill,
                            causal, vec, mvec);
  } else
    softmax_fwd_loop<T><<<grid_for(rows), kThreads, 0, stream>>>(
        x, y, rows, Sk, mv, scale, mode, fill, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG, typename TY, int CH>
void bwd_regs(bool vec, int grid, cudaStream_t stream, const TG* g,
              const TY* y, TG* dx, long long rows, int Sk,
              const MaskView& mv, float scale) {
  if (vec)
    softmax_bwd_regs<TG, TY, CH, true><<<grid, kThreads, 0, stream>>>(
        g, y, dx, rows, Sk, mv, scale);
  else
    softmax_bwd_regs<TG, TY, CH, false><<<grid, kThreads, 0, stream>>>(
        g, y, dx, rows, Sk, mv, scale);
}

template <typename TG, typename TY>
int launch_bwd(const void* gp, const void* yp, void* dxp, long long rows,
               int Sk, const MaskView& mv, float scale,
               cudaStream_t stream) {
  const TG* g = static_cast<const TG*>(gp);
  const TY* y = static_cast<const TY*>(yp);
  TG* dx = static_cast<TG*>(dxp);
  const bool vec = Sk % 4 == 0 && aligned(g, 16) && aligned(y, 16) &&
                   aligned(dx, 16);
  const int grid = grid_for(rows);
  if (Sk <= 128)
    bwd_regs<TG, TY, 1>(vec, grid, stream, g, y, dx, rows, Sk, mv, scale);
  else if (Sk <= 256)
    bwd_regs<TG, TY, 2>(vec, grid, stream, g, y, dx, rows, Sk, mv, scale);
  else if (Sk <= 512)
    bwd_regs<TG, TY, 4>(vec, grid, stream, g, y, dx, rows, Sk, mv, scale);
  else
    softmax_bwd_loop<TG, TY><<<grid, kThreads, 0, stream>>>(
        g, y, dx, rows, Sk, mv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TG>
int bwd_for_y(const void* g, const void* y, void* dx, long long rows, int Sk,
              int y_dtype, const MaskView& mv, float scale, cudaStream_t s) {
  switch (y_dtype) {
    case 0: return launch_bwd<TG, float>(g, y, dx, rows, Sk, mv, scale, s);
    case 1:
      return launch_bwd<TG, __nv_bfloat16>(g, y, dx, rows, Sk, mv, scale, s);
    case 2: return launch_bwd<TG, __half>(g, y, dx, rows, Sk, mv, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_view(long long rows, int Sk, int H, int Sq) {
  return rows < 1 || Sk < 1 || H < 1 || Sq < 1 ||
         (rows + kWarps - 1) / kWarps > 0x7fffffffLL;
}

MaskView make_view(const void* mask, long long rows, int H, int Sq,
                   long long sb, long long sh, long long sq) {
  return MaskView{mask, sb, sh, sq, make_fastdiv(Sq), make_fastdiv(H),
                  rows > 0x7fffffffLL ? 1 : 0};
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16. x, y contiguous (rows,
// Sk). mask: null when mask_mode is 0 (none); else fp32 (1, add) or 1 byte
// (2, fill: v = fill where nonzero), read at b * sb + h * sh + q * sq for
// row (b * H + h) * Sq + q, its last dim contiguous.
extern "C" int softmax_fwd(const void* x, const void* mask, void* y,
                           long long rows, int Sk, int H, int Sq,
                           long long sb, long long sh, long long sq,
                           int dtype, float scale, int mask_mode, float fill,
                           int causal, void* stream) {
  if (bad_view(rows, Sk, H, Sq) || mask_mode < 0 || mask_mode > 2 ||
      (mask_mode != 0 && mask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskView mv =
      make_view(mask_mode ? mask : nullptr, rows, H, Sq, sb, sh, sq);
  if (dtype == 0)
    return launch_fwd<float>(x, y, rows, Sk, mv, scale, mask_mode, fill,
                             causal, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, y, rows, Sk, mv, scale, mask_mode,
                                     fill, causal, s);
  if (dtype == 2)
    return launch_fwd<__half>(x, y, rows, Sk, mv, scale, mask_mode, fill,
                              causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g, y, dx contiguous (rows, Sk), each of the forward's dtype codes; dx in
// g's type. mask: null, or 1 byte read as the forward's (dx = 0 where
// nonzero).
extern "C" int softmax_bwd(const void* g, const void* y, const void* mask,
                           void* dx, long long rows, int Sk, int H, int Sq,
                           long long sb, long long sh, long long sq,
                           int g_dtype, int y_dtype, float scale,
                           void* stream) {
  if (bad_view(rows, Sk, H, Sq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskView mv = make_view(mask, rows, H, Sq, sb, sh, sq);
  switch (g_dtype) {
    case 0:
      return bwd_for_y<float>(g, y, dx, rows, Sk, y_dtype, mv, scale, s);
    case 1:
      return bwd_for_y<__nv_bfloat16>(g, y, dx, rows, Sk, y_dtype, mv,
                                      scale, s);
    case 2:
      return bwd_for_y<__half>(g, y, dx, rows, Sk, y_dtype, mv, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
