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
// against ~14 fp32 operations per element.
//
// Design: the TPU kernel accumulates dgamma/dbeta across its sequential
// row-block grid in VMEM; Hopper's blocks run in parallel and in no order.
// Rows up to H 1024 (every main path: BERT, GPT-2, OpenFold, the norm
// microbench) are held in registers by a group of lanes of one warp, so no
// row needs a block-wide barrier: 32 lanes a row with one to four chunks
// of eight adjacent columns a lane (one 16-byte load for bf16 or fp16) from
// H 129 up, 16 lanes a row (two rows a warp side by side) to H 128 and 8
// lanes (four rows) to H 64. The statistics and the two dx sums are
// shuffles within the group. A group takes four chunks of x and g a lane
// at a time (one row at H 1024, four at H 128), and for 16-bit rows the
// next four are already on their way into shared memory by cp.async while
// it reduces these, so that loads and arithmetic overlap. Its fp32 column
// accumulators of g * xhat and g live in shared memory, a slice per group
// laid out so that a lane's 16-byte accesses are free of bank conflicts:
// in registers they would take 64 a thread at H 1024 and leave an SM one
// block of 8 warps. The grid is as many 256-thread blocks as the SMs hold
// at once (two: 16 warps); each group walks rows grid-stride. At the end
// a block adds its groups' sums in group order (one barrier a block, not a
// row) and writes one partial a column; a second kernel adds the blocks'
// partials column by column, each block of it 32 columns whose 32 warps
// each add a run of blocks in order, then the warps' sums in warp order.
// Rows from H 1025 to 8192, off the main paths, take two passes: a warp a
// row reduces the statistics and the two dx sums from memory (x read three
// times, through the caches), then blocks that own a column slice and a
// run of rows write dx and accumulate the column partials in registers,
// which the same second kernel adds. No atomics: every sum is taken in a
// fixed order, so the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "dtypes.cuh"

namespace {

constexpr int VPT = 8;           // adjacent columns per lane and chunk
constexpr int kThreads = 256;    // rows and element kernels
constexpr int kWarps = kThreads / 32;
constexpr int kRegMaxH = 32 * VPT * 4;  // 1024: rows held in registers
constexpr int kMaxH = 8192;
constexpr int kSumWarps = 32;    // column-sum kernel: warps a block
// rows kernel blocks an SM (at most 128 registers a thread): 16 warps,
// each with four chunks of x and g in flight
constexpr int kRowsBlocksPerSM = 2;

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

// the weight: read-only, shared by every row
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
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (j < valid) p[j] = v[j];
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
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (j < valid) p[j] = from_f32<H>(v[j]);
  }
}

// Rows a lane group holds at a time: four chunks' worth of x and g.
template <int CHUNKS>
__host__ __device__ constexpr int rows_in_flight() {
  return 4 / CHUNKS;
}

// The rows kernel's shared memory: each group's two column sums (16 KB a
// chunk a block), and for 16-bit rows the next turn's x and g, staged by
// cp.async while the current turn is reduced (32 KB a block).
template <typename T, int CHUNKS>
__host__ __device__ constexpr int rows_smem() {
  return 16384 * CHUNKS + (sizeof(T) == 2 ? 2 * 4 * kThreads * 16 : 0);
}

// Rows in registers: a group of LPR lanes a row (32 / LPR groups a warp),
// CHUNKS chunks of eight columns a lane, rows_in_flight rows a group at a
// time. Each group's fp32 column accumulators (dgamma's, then dbeta's)
// live in its own slice of shared memory, float4 (c, h, l) holding
// columns (c LPR + l) 8 + 4 h .. + 3, so that a lane's accesses are free
// of bank conflicts and the registers hold only the rows in flight. With
// 16-bit rows whose chunks are whole 16-byte loads, each lane stages its
// next turn's chunks in shared memory by cp.async (a slot per lane: it
// reads only what it copied, so no barrier) while it reduces the current
// one, so loads and arithmetic overlap.
// part: (2, gridDim.x, H), the block's dgamma then dbeta partials.
template <typename T, int LPR, int CHUNKS>
__global__ void __launch_bounds__(kThreads, kRowsBlocksPerSM)
    ln_bwd_rows_kernel(const T* __restrict__ g, const T* __restrict__ x,
                       const float* __restrict__ w, T* __restrict__ dx,
                       float* __restrict__ part, int rows, int H, float eps,
                       int rms, bool vec, bool wvec) {
  extern __shared__ float4 acc[];
  constexpr int RPI = rows_in_flight<CHUNKS>();
  constexpr bool kStaged = sizeof(T) == 2;
  constexpr int G = 32 / LPR;
  constexpr int kSlots = kWarps * G;     // lane groups a block
  constexpr int kSum = 2 * CHUNKS * LPR;  // float4 a group and sum
  const int lane = threadIdx.x & 31;
  const int l = lane % LPR;
  const int slot = (threadIdx.x >> 5) * G + lane / LPR;
  const int groups = gridDim.x * kSlots;
  const int gid = blockIdx.x * kSlots + slot;
  const float inv_h = 1.f / static_cast<float>(H);
  float4* adw = acc + 2 * slot * kSum;   // this group's dgamma sums
  float4* adb = adw + kSum;              // and dbeta's
#pragma unroll
  for (int i = 0; i < 2 * CHUNKS; ++i)
    adw[i * LPR + l] = adb[i * LPR + l] = make_float4(0.f, 0.f, 0.f, 0.f);
  int c0[CHUNKS], valid[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    c0[c] = (c * LPR + l) * VPT;
    valid[c] = c0[c] < H ? min(VPT, H - c0[c]) : 0;
  }
  const int step = groups * RPI;
  // staged: this lane's x and g chunks of a turn, 16 bytes each
  uint4* stage = reinterpret_cast<uint4*>(acc + kSlots * 2 * kSum);
  const bool staged = kStaged && vec;
  auto prefetch = [&](int b0) {  // the turn at b0 into the stage
#pragma unroll
    for (int k = 0; k < RPI; ++k) {
      const int row = b0 + k * groups + gid;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
        if (row < rows && valid[c]) {
          const size_t at = static_cast<size_t>(row) * H + c0[c];
          uint4* d = stage + 2 * (k * CHUNKS + c) * kThreads + threadIdx.x;
          cp_async16(d, x + at);
          cp_async16(d + kThreads, g + at);
        }
    }
    cp_async_commit();
  };
  if (staged) prefetch(0);
  // the loop bound is uniform across the warp: every lane takes every
  // shuffle, and a group past the last row computes on zeros it never
  // stores
  for (int base = 0; base < rows; base += step) {
    float xv[RPI][CHUNKS][VPT], gv[RPI][CHUNKS][VPT];
    size_t off[RPI];
    bool in[RPI];
    if (staged) cp_async_wait<0>();  // this lane's copies of the turn
#pragma unroll
    for (int k = 0; k < RPI; ++k) {
      const int row = base + k * groups + gid;
      in[k] = row < rows;
      off[k] = static_cast<size_t>(in[k] ? row : 0) * H;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        if (in[k] && valid[c]) {
          if (staged) {
            const uint4* d =
                stage + 2 * (k * CHUNKS + c) * kThreads + threadIdx.x;
            load8(reinterpret_cast<const T*>(d), xv[k][c], true, VPT);
            load8(reinterpret_cast<const T*>(d + kThreads), gv[k][c], true,
                  VPT);
          } else {
            const bool v8 = vec && valid[c] == VPT;
            load8(x + off[k] + c0[c], xv[k][c], v8, valid[c]);
            load8(g + off[k] + c0[c], gv[k][c], v8, valid[c]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VPT; ++j) xv[k][c][j] = gv[k][c][j] = 0.f;
        }
      }
    }
    // the turn is in registers (its values used above): stage the next
    if (staged && base + step < rows) prefetch(base + step);
    float rstd[RPI], s1[RPI], s2[RPI];
#pragma unroll
    for (int k = 0; k < RPI; ++k) {
      s1[k] = 0.f;
      if (!rms)
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
          for (int j = 0; j < VPT; ++j) s1[k] += xv[k][c][j];
    }
    if (!rms)
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < RPI; ++k)
          s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
#pragma unroll
    for (int k = 0; k < RPI; ++k) {
      const float mean = rms ? 0.f : s1[k] * inv_h;
      s2[k] = 0.f;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const float d = j < valid[c] ? xv[k][c][j] - mean : 0.f;
          xv[k][c][j] = d;
          s2[k] += d * d;
        }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < RPI; ++k)
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], o);
#pragma unroll
    for (int k = 0; k < RPI; ++k) {
      rstd[k] = rsqrtf(s2[k] * inv_h + eps);
      s1[k] = s2[k] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      float wv[VPT];
      ldg8(w + (valid[c] ? c0[c] : 0), wv, wvec && valid[c] == VPT,
           valid[c]);
#pragma unroll
      for (int k = 0; k < RPI; ++k)
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          xv[k][c][j] *= rstd[k];  // xhat
          const float wg = gv[k][c][j] * wv[j];
          s1[k] += wg * xv[k][c][j];
          s2[k] += wg;
        }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < RPI; ++k) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], o);
      }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      float wv[VPT];
      ldg8(w + (valid[c] ? c0[c] : 0), wv, wvec && valid[c] == VPT,
           valid[c]);
      float4 tw[2], tb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tw[h] = adw[(2 * c + h) * LPR + l];
        tb[h] = adb[(2 * c + h) * LPR + l];
      }
      float* fw = reinterpret_cast<float*>(tw);
      float* fb = reinterpret_cast<float*>(tb);
#pragma unroll
      for (int k = 0; k < RPI; ++k) {
        const float c1 = s1[k] * inv_h;
        const float c2 = rms ? 0.f : s2[k] * inv_h;
        float out[VPT];
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          out[j] = (gv[k][c][j] * wv[j] - xv[k][c][j] * c1 - c2) * rstd[k];
          fw[j] += gv[k][c][j] * xv[k][c][j];
          fb[j] += gv[k][c][j];
        }
        if (in[k] && valid[c])
          store8(dx + off[k] + c0[c], out, vec && valid[c] == VPT, valid[c]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        adw[(2 * c + h) * LPR + l] = tw[h];
        adb[(2 * c + h) * LPR + l] = tb[h];
      }
    }
  }
  // the block's partials: its groups' sums added in group order
  __syncthreads();
  const float* f = reinterpret_cast<const float*>(acc);
  for (int which = 0; which < 2; ++which) {
    float* dst =
        part + (static_cast<size_t>(which) * gridDim.x + blockIdx.x) * H;
    for (int col = threadIdx.x; col < H; col += kThreads) {
      // column col sits in float4 (c, h, l), component col % 4
      const int c = col / (VPT * LPR), cl = (col / VPT) % LPR;
      const int at = ((2 * c + (col % VPT) / 4) * LPR + cl) * 4 + col % 4;
      float t = 0.f;
      for (int s = 0; s < kSlots; ++s)
        t += f[(2 * s + which) * kSum * 4 + at];
      dst[col] = t;
    }
  }
}

// Rows past kRegMaxH, pass 1: a warp a row; stats[row] = (mean, rstd,
// sum(wg * xhat) / H, sum(wg) / H (0 for RMSNorm)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_stats_kernel(const T* __restrict__ g, const T* __restrict__ x,
                        const float* __restrict__ w,
                        float4* __restrict__ stats, int rows, int H,
                        float eps, int rms, bool vec) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a warp leaves whole
  const int lane = threadIdx.x & 31;
  const T* xr = x + static_cast<size_t>(row) * H;
  const T* gr = g + static_cast<size_t>(row) * H;
  const float inv_h = 1.f / static_cast<float>(H);
  float s = 0.f;
  if (!rms)
    for (int c0 = lane * VPT; c0 < H; c0 += 32 * VPT) {
      const int valid = min(VPT, H - c0);
      float v[VPT];
      load8(xr + c0, v, vec && valid == VPT, valid);
#pragma unroll
      for (int j = 0; j < VPT; ++j) s += v[j];
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = rms ? 0.f : s * inv_h;
  float sq = 0.f;
  for (int c0 = lane * VPT; c0 < H; c0 += 32 * VPT) {
    const int valid = min(VPT, H - c0);
    float v[VPT];
    load8(xr + c0, v, vec && valid == VPT, valid);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float d = j < valid ? v[j] - mean : 0.f;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq * inv_h + eps);
  float a = 0.f, b = 0.f;
  for (int c0 = lane * VPT; c0 < H; c0 += 32 * VPT) {
    const int valid = min(VPT, H - c0);
    const bool v8 = vec && valid == VPT;
    float xv[VPT], gv[VPT], wv[VPT];
    load8(xr + c0, xv, v8, valid);
    load8(gr + c0, gv, v8, valid);
    ldg8(w + c0, wv, false, valid);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float xh = j < valid ? (xv[j] - mean) * rstd : 0.f;
      const float wg = gv[j] * wv[j];
      a += wg * xh;
      b += wg;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0)
    stats[row] = make_float4(mean, rstd, a * inv_h, rms ? 0.f : b * inv_h);
}

// Rows past kRegMaxH, pass 2: block (i, y) owns columns [2048 y, 2048 (y +
// 1)), eight adjacent a thread, and rows [i per, (i + 1) per); dx from the
// row's statistics, and the block's dgamma and dbeta partials of its
// columns into part (2, gridDim.x, H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_elems_kernel(const T* __restrict__ g, const T* __restrict__ x,
                        const float* __restrict__ w,
                        const float4* __restrict__ stats, T* __restrict__ dx,
                        float* __restrict__ part, int rows, int H, int per,
                        bool vec) {
  const int c0 = (blockIdx.y * kThreads + threadIdx.x) * VPT;
  if (c0 >= H) return;  // no barrier below
  const int valid = min(VPT, H - c0);
  const bool v8 = vec && valid == VPT;
  float wv[VPT], adw[VPT], adb[VPT];
  ldg8(w + c0, wv, false, valid);
#pragma unroll
  for (int j = 0; j < VPT; ++j) adw[j] = adb[j] = 0.f;
  const int r0 = blockIdx.x * per, r1 = min(rows, r0 + per);
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    const float4 st = __ldg(stats + r);
    const size_t off = static_cast<size_t>(r) * H + c0;
    float xv[VPT], gv[VPT], out[VPT];
    load8(x + off, xv, v8, valid);
    load8(g + off, gv, v8, valid);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float xh = (xv[j] - st.x) * st.y;
      out[j] = (gv[j] * wv[j] - xh * st.z - st.w) * st.y;
      adw[j] += gv[j] * xh;
      adb[j] += gv[j];
    }
    store8(dx + off, out, v8, valid);
  }
  const size_t p = static_cast<size_t>(blockIdx.x) * H + c0;
  store8(part + p, adw, false, valid);
  store8(part + static_cast<size_t>(gridDim.x) * H + p, adb, false, valid);
}

// dgamma (blockIdx.y 0) or dbeta (1) of columns [32 blockIdx.x, + 32): warp
// w adds the partials of its run of blocks in block order, then warp 0
// adds the warps' sums in warp order.
__global__ void __launch_bounds__(32 * kSumWarps)
    ln_bwd_cols_kernel(const float* __restrict__ part, float* __restrict__ dw,
                       float* __restrict__ db, int blocks, int H) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int per = (blocks + kSumWarps - 1) / kSumWarps;
  const int b0 = min(blocks, warp * per), b1 = min(blocks, b0 + per);
  float t = 0.f;
  if (c < H) {
    const float* src =
        part + static_cast<size_t>(blockIdx.y) * blocks * H + c;
#pragma unroll 8
    for (int i = b0; i < b1; ++i) t += src[static_cast<size_t>(i) * H];
  }
  red[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && c < H) {
    float s = 0.f;
    for (int i = 0; i < kSumWarps; ++i) s += red[i][lane];
    (blockIdx.y ? db : dw)[c] = s;
  }
}

int sm_count() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// A launch plan: the rows kernel's instantiation and grid (blocks), or,
// for rows past kRegMaxH, the two-pass kernels' row blocks.
struct Plan {
  int lpr, chunks;  // lpr == 0: two passes
  int blocks;       // partials a column
  int per;          // two passes: rows a block
  int slices;       // two passes: column slices
};

// The plan for (rows, H): the rows kernel's lanes a row and chunks, and
// its grid (kRowsBlocksPerSM blocks an SM at most), or the two passes'
// row blocks and column slices.
Plan plan(int rows, int H) {
  const int sms = sm_count();
  Plan p = {0, 0, 0, 0, 0};
  if (H <= kRegMaxH) {
    p.lpr = H <= 64 ? 8 : H <= 128 ? 16 : 32;
    p.chunks = (H + 32 * VPT - 1) / (32 * VPT);
    // rows a block takes in one turn of its groups
    const int turn = kWarps * (32 / p.lpr) * (4 / p.chunks);
    p.blocks = std::min(kRowsBlocksPerSM * sms, (rows + turn - 1) / turn);
    return p;
  }
  p.slices = (H + kThreads * VPT - 1) / (kThreads * VPT);
  const int want = std::max(1, 4 * sms / p.slices);  // ~4 blocks an SM
  p.per = (rows + want - 1) / want;
  p.blocks = (rows + p.per - 1) / p.per;
  return p;
}

template <typename T>
cudaError_t launch(const T* g, const T* x, const float* w, T* dx, float* dw,
                   float* db, float* work, int rows, int H, float eps,
                   int rms, const Plan& p, cudaStream_t s) {
  const bool vec = H % VPT == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const bool wvec = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(p.blocks);
  // (over 48 KB of shared memory needs the raised limit)
#define B1_ROWS(LPR, CHUNKS)                                                 \
  do {                                                                       \
    auto kernel = ln_bwd_rows_kernel<T, LPR, CHUNKS>;                        \
    constexpr int smem = rows_smem<T, CHUNKS>();                             \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);          \
    if (e != cudaSuccess) return e;                                          \
    kernel<<<grid, kThreads, smem, s>>>(g, x, w, dx, work, rows, H, eps,     \
                                        rms, vec, wvec);                     \
  } while (0)
  if (p.lpr == 8) {
    B1_ROWS(8, 1);
  } else if (p.lpr == 16) {
    B1_ROWS(16, 1);
  } else if (p.lpr == 32) {
    switch (p.chunks) {
      case 1: B1_ROWS(32, 1); break;
      case 2: B1_ROWS(32, 2); break;
      case 3: B1_ROWS(32, 3); break;
      default: B1_ROWS(32, 4); break;
    }
  } else {
    // the statistics start on a 16-byte boundary after the partials
    float4* stats = reinterpret_cast<float4*>(
        work + (2 * static_cast<size_t>(p.blocks) * H + 3) / 4 * 4);
    ln_bwd_stats_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        g, x, w, stats, rows, H, eps, rms, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ln_bwd_elems_kernel<T><<<dim3(p.blocks, p.slices), kThreads, 0, s>>>(
        g, x, w, stats, dx, work, rows, H, p.per, vec);
  }
#undef B1_ROWS
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_cols_kernel<<<dim3((H + 31) / 32, 2), 32 * kSumWarps, 0, s>>>(
      work, dw, db, p.blocks, H);
  return cudaGetLastError();
}

}  // namespace

// The fp32 workspace layer_norm_bwd needs for (rows, H), in floats: two
// partials a column for each block of the plan, and, for rows past H
// 1024, four statistics a row (16-byte aligned after the partials).
extern "C" int layer_norm_bwd_workspace(int rows, int H) {
  if (rows < 1 || H < 1 || H > kMaxH) return 0;
  const Plan p = plan(rows, H);
  int n = 2 * p.blocks * H;
  if (!p.lpr) n = (n + 3) / 4 * 4 + 4 * rows;
  return n;
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (g, x and dx). w, dw,
// db fp32. Everything contiguous; workspace holds
// layer_norm_bwd_workspace(rows, H) floats from a 16-byte boundary.
extern "C" int layer_norm_bwd(const void* g, const void* x, const void* w,
                              void* dx, void* dw, void* db, void* workspace,
                              int rows, int H, int dtype, float eps, int rms,
                              void* stream) {
  if (rows < 1 || H < 1 || H > kMaxH || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(rows, H);
  float* work = static_cast<float*>(workspace);
  float* fdw = static_cast<float*>(dw);
  float* fdb = static_cast<float*>(db);
  const float* fw = static_cast<const float*>(w);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(static_cast<const float*>(g),
                        static_cast<const float*>(x), fw,
                        static_cast<float*>(dx), fdw, fdb, work, rows, H, eps,
                        rms, p, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g),
                                static_cast<const __nv_bfloat16*>(x), fw,
                                static_cast<__nv_bfloat16*>(dx), fdw, fdb,
                                work, rows, H, eps, rms, p, s);
  else
    err = launch<__half>(static_cast<const __half*>(g),
                         static_cast<const __half*>(x), fw,
                         static_cast<__half*>(dx), fdw, fdb, work, rows, H,
                         eps, rms, p, s);
  return (int)err;
}
