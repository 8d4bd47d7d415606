// Weight-only dequant-GEMM for quantized GPT weights (kernel B15), CUDA
// C++ for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/dequant_gemm.py::_dequant_gemm_kernel (wrapper
// _pallas_dequant_gemm), the Pallas TPU kernel behind dequant_matmul.
//
// Computes out[m, n] = sum_k x[m, k] * (float(w_q[k, n]) * scale[n]) in
// fp32: x is (M, K) fp32, w_q is (K, N) int8 or float8_e4m3fn in the JAX
// (in, out) layout, scale is the (N,) fp32 per-output-channel scale, out
// is (M, N) fp32. Each weight is dequantized as the plain chain forms it
// (float(w_q) * scale, rounded once) before its fp32 product, so every
// product term is the plain version's bit for bit and only the order of
// the fp32 sums differs.
//
// What bounds it on the H100: on the serving path M is small (max_batch
// = 8 lanes at decode, 1 to 128 rows of a prefill chunk) and (K, N) is
// (768, 768), (768, 2304), (768, 3072) or (3072, 768). Up to M ~ 16 the
// kernel does under 32 FLOPs per weight byte and is bound by the weight
// bytes (0.59 to 2.36 MB a call) and, at these sizes, by the latency of
// reading them; at M = 128 it does 256 FLOPs per weight byte and is bound
// by the fp32 units (67 TFLOP/s).
//
// Design: one launch per call, in one of two kernels that the host picks
// by M (M <= m0 streams, larger M tiles; m0 from card times,
// apex_tpu_torch/ops/dequant_gemm.py). A block of 256 threads owns an
// output tile of 64 columns and a range of K; the K ranges of one tile are
// the blocks of a thread-block cluster (up to 8), and the cluster adds
// their partial tiles through distributed shared memory in rank order, so
// no workspace, second pass or atomic exists and reruns are
// bit-identical. The host splits K only as far as the tiles leave SMs
// idle.
// - Streaming (dequant_gemv_kernel; decode): an MR-row tile (MR = 1 ... 16,
//   the power of two that covers M). Every thread issues all of its weight
//   loads at once (4 columns of a row, 4 bytes, for rows kl, kl + 16, ...
//   of the block's range: up to 32 rows in flight a thread) while the
//   block's x rows land in shared memory by 16-byte cp.async copies; then
//   it dequantizes each 4-byte word in registers (int8 by byte-extracting
//   int-to-float conversions, e4m3 by the paired fp8-to-half conversion,
//   times the columns' scales) and runs MR x 4 FMAs on it, x read from
//   shared memory. The 16 row lanes of a column are added by one shuffle
//   and then warp by warp in shared memory, in a fixed order. Enough K
//   splits keep two blocks on every SM reading.
// - Tiled (dequant_gemm_kernel; prefill): a (BM = 16 TM) x 64 tile, TM 4 or
//   8. K is walked in 32-row stages: 16-byte cp.async copies of the raw
//   weight rows and of the x rows land in a ring of 3-4 stages; each stage
//   is dequantized once into an fp32 weight tile in shared memory (8 bytes
//   a thread) and x is transposed beside it; then every thread runs a TM x
//   4 register micro-tile of fp32 FMAs, reading x and the weights as
//   vectors (at TM = 8: 3 shared loads for 32 FMAs). The host picks BM and
//   the K splits that put the fewest FMAs on the busiest SM.
// Inputs that are not whole 16-byte (tiled) or 4-byte (streamed) rows from
// an aligned base are loaded element by element.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 64;        // output columns a block
constexpr int KS = 32;        // rows of K a stage (and the unit of a split)
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;

// -- shared pieces ------------------------------------------------------------

struct Args {
  const float* x;
  const uint8_t* w;
  const float* scale;
  float* out;
  int M, K, N;
  int per;     // stages of K a split
  int x_vec;   // x rows are whole 16-byte chunks from a 16-byte base
  int w_vec;   // likewise the weight rows
  int w_vec4;  // the weight rows are whole 4-byte words from a 4-byte base
};

// The 4 weights in the bytes of w as fp32, each times its column's scale.
__device__ __forceinline__ float4 dequant4(uint32_t w, const float* sc,
                                           int8_t) {
  return make_float4(__int2float_rn(static_cast<int8_t>(w)) * sc[0],
                     __int2float_rn(static_cast<int8_t>(w >> 8)) * sc[1],
                     __int2float_rn(static_cast<int8_t>(w >> 16)) * sc[2],
                     __int2float_rn(static_cast<int8_t>(w >> 24)) * sc[3]);
}
__device__ __forceinline__ float4 dequant4(uint32_t w, const float* sc,
                                           __nv_fp8_e4m3) {
  const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w), __NV_E4M3)));
  const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3)));
  return make_float4(lo.x * sc[0], lo.y * sc[1], hi.x * sc[2],
                     hi.y * sc[3]);
}

// Write 4 outputs of row m from column n (guarded at M and N).
__device__ __forceinline__ void store4(const Args& a, int m, int n,
                                       float4 v) {
  if (m >= a.M || n >= a.N) return;
  float* row = a.out + static_cast<size_t>(m) * a.N;
  if (n + 4 <= a.N && a.N % 4 == 0) {
    *reinterpret_cast<float4*>(row + n) = v;
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (int j = 0; j < 4 && n + j < a.N; ++j) row[n + j] = e[j];
  }
}

// The K splits of a (rows x 64) output tile: each block of the cluster
// holds its partial tile in `part` (its own shared memory); block r adds
// its share of the 4-column units of every partial in rank order and
// writes them. A thread issues all of a unit's remote loads before it
// adds (one round trip to the other SMs, not one a split).
__device__ __forceinline__ void cluster_store(const Args& a, float* part,
                                              int rows, int m0, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, splits = gridDim.x;
  const int live = min(rows, a.M - m0) * (BN / 4);  // units of rows < M
  const int begin = split * live / splits;
  const int end = (split + 1) * live / splits;
  cluster.sync();
  for (int u = begin + threadIdx.x; u < end; u += kThreads) {
    const int r = u / (BN / 4), c = 4 * (u % (BN / 4));
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < splits)
        v[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + r * BN + c);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < splits) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    }
    store4(a, m0 + r, n0 + c, s);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// -- streaming: dequant_gemv_kernel -------------------------------------------

constexpr int KC = 512;  // K rows a streaming pass holds in flight

template <int MR>
struct Gemv {
  static constexpr int LDX = KC + 4;        // x row in shared memory
  static constexpr int kRed = 8 * MR * BN;  // the 8 warps' sums
  static constexpr size_t kSmem = 4 * (MR * LDX + kRed + MR * BN);
};

template <typename WT, int MR>
__global__ void __launch_bounds__(kThreads) dequant_gemv_kernel(Args a) {
  using C = Gemv<MR>;
  constexpr int LDX = C::LDX, RPT = KC / 16;  // rows a thread a pass
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [MR][LDX]
  float* red = xs + MR * LDX;                  // [8 warps][MR][BN]
  float* part = red + C::kRed;                 // [MR][BN]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c4 = tid % 16, kl = tid / 16;  // columns 4 c4 .., rows kl + 16 i
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * MR;
  const int n = n0 + 4 * c4;
  const int kb = min(a.K, blockIdx.x * a.per * KS);
  const int ke = min(a.K, kb + a.per * KS);
  const bool wvec = a.w_vec4 && n + 4 <= a.N;
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = n + j < a.N ? a.scale[n + j] : 0.f;
  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += KC) {
    const int kn = min(KC, ke - k0);
    uint32_t wr[RPT];  // every weight load of the pass, in flight at once
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      // a branch the block takes as one (not 32 predicated row bodies)
      if (16 * i >= kn) break;
      const int k = kl + 16 * i;
      const uint8_t* src = a.w + static_cast<size_t>(k0 + k) * a.N + n;
      wr[i] = 0u;
      if (k < kn) {
        if (wvec) {
          wr[i] = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
          for (int j = 0; j < 4 && n + j < a.N; ++j)
            wr[i] |= static_cast<uint32_t>(src[j]) << (8 * j);
        }
      }
    }
    const int kn4 = (kn + 3) / 4;  // 16-byte chunks of an x row
    for (int e = tid; e < MR * kn4; e += kThreads) {
      const int m = e / kn4, c = 4 * (e % kn4);
      const int mm = m0 + m, kk = k0 + c;
      float* dst = xs + m * LDX + c;
      if (mm < a.M && a.x_vec && kk + 4 <= ke) {
        cp_async16(dst, a.x + static_cast<size_t>(mm) * a.K + kk);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = mm < a.M && kk + j < ke
                       ? a.x[static_cast<size_t>(mm) * a.K + kk + j]
                       : 0.f;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (16 * i >= kn) break;
      const int k = kl + 16 * i;
      if (k < kn) {
        const float4 w = dequant4(wr[i], sc, WT());
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float xv = xs[m * LDX + k];
          acc[m][0] = fmaf(xv, w.x, acc[m][0]);
          acc[m][1] = fmaf(xv, w.y, acc[m][1]);
          acc[m][2] = fmaf(xv, w.z, acc[m][2]);
          acc[m][3] = fmaf(xv, w.w, acc[m][3]);
        }
      }
    }
    __syncthreads();  // xs is read before the next pass restages it
  }
  // the row lanes of a column: kl and kl + 1 by a shuffle, then warp by warp
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
      *reinterpret_cast<float4*>(red + (warp * MR + m) * BN + 4 * c4) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  const bool clustered = gridDim.x > 1;
  for (int u = tid; u < MR * (BN / 4); u += kThreads) {
    const int m = u / (BN / 4), c = 4 * (u % (BN / 4));
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const float4 v =
          *reinterpret_cast<const float4*>(red + (w * MR + m) * BN + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (clustered)
      *reinterpret_cast<float4*>(part + m * BN + c) = s;
    else
      store4(a, m0 + m, n0 + c, s);
  }
  if (clustered) cluster_store(a, part, MR, m0, n0);
}

// -- tiled: dequant_gemm_kernel -----------------------------------------------

constexpr int LDW = BN + 4;  // dequantized weight row (floats)

template <int TM>
struct Cfg {
  static constexpr int BM = 16 * TM;
  static constexpr int kStages = TM == 4 ? 4 : 3;
  static constexpr int LDX = BM + 4;           // transposed x row (floats)
  static constexpr int kWChunks = KS * BN / 16;  // 16-byte chunks a stage
  static constexpr int kXChunks = BM * KS / 4;
  static constexpr int kStageBytes = 16 * (kWChunks + kXChunks);
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kPart = BM * BN * 4;    // a block's partial tile
  static constexpr int kTiles = kRing > kPart ? kRing : kPart;
  // the raw ring (or the partial tile); two dequantized weight tiles and
  // two transposed x tiles
  static constexpr size_t kSmem = kTiles + 4 * 2 * KS * (LDW + LDX);
};

// Copy this thread's 16-byte chunks of stage k0 .. k0 + 31 (cut at kend) into
// a slot of the ring: weight chunk tid (row tid / 4, columns 16 (tid % 4)
// from n0), x chunks e = tid + 256 i (row e % BM from m0, columns 4 (e /
// BM)). cp.async where whole and aligned, element loads (zeros past the
// ends) otherwise. The thread converts the same chunks, so it waits for its
// own copies only.
template <int TM>
__device__ __forceinline__ void load_stage(unsigned char* slot, const Args& a,
                                           int k0, int kend, int m0, int n0) {
  using C = Cfg<TM>;
  const int tid = threadIdx.x;
  if (tid < C::kWChunks) {
    const int kk = k0 + tid / 4, n = n0 + 16 * (tid % 4);
    unsigned char* dst = slot + 16 * tid;
    if (kk < kend && a.w_vec && n + 16 <= a.N) {
      cp_async16(dst, a.w + static_cast<size_t>(kk) * a.N + n);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dst[i] = kk < kend && n + i < a.N
                     ? a.w[static_cast<size_t>(kk) * a.N + n + i]
                     : 0;
    }
  }
  float* xr = reinterpret_cast<float*>(slot + 16 * C::kWChunks);
#pragma unroll
  for (int e = tid; e < C::kXChunks; e += kThreads) {
    const int mm = m0 + e % C::BM, kk = k0 + 4 * (e / C::BM);
    float* dst = xr + 4 * e;
    if (mm < a.M && a.x_vec && kk + 4 <= kend) {
      cp_async16(dst, a.x + static_cast<size_t>(mm) * a.K + kk);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = mm < a.M && kk + i < kend
                     ? a.x[static_cast<size_t>(mm) * a.K + kk + i]
                     : 0.f;
    }
  }
}

// Step k's register fragments: x rows TM mg .. (transposed tile), weight
// columns 4 ng ...
template <int TM>
__device__ __forceinline__ void load_frag(const float* xsb, const float* wsb,
                                          int k, int mg, int ng,
                                          float4 (&xf)[TM / 4], float4& wf) {
#pragma unroll
  for (int i = 0; i < TM / 4; ++i)
    xf[i] = *reinterpret_cast<const float4*>(xsb + k * Cfg<TM>::LDX +
                                             TM * mg + 4 * i);
  wf = *reinterpret_cast<const float4*>(wsb + k * LDW + 4 * ng);
}

template <typename WT, int TM>
__global__ void __launch_bounds__(kThreads) dequant_gemm_kernel(Args a) {
  using C = Cfg<TM>;
  constexpr int BM = C::BM, ST = C::kStages, LDX = C::LDX;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem + C::kTiles);  // [2][KS][LDW]
  float* xs = ws + 2 * KS * LDW;                           // [2][KS][LDX]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int nb = (a.K + KS - 1) / KS;
  const int b0 = blockIdx.x * a.per;
  const int nbat = max(0, min(nb, b0 + a.per) - b0);
  const int kend = min(a.K, (b0 + nbat) * KS);
  // the scales of this thread's weight chunk's 16 columns
  float sc[16];
  const int wc = 16 * (tid % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    sc[j] = n0 + wc + j < a.N ? a.scale[n0 + wc + j] : 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nbat)
      load_stage<TM>(smem + s * C::kStageBytes, a, (b0 + s) * KS, kend, m0,
                     n0);
    cp_async_commit();
  }
  const int mg = tid / 16, ng = tid % 16;  // rows TM mg .., columns 4 ng ..
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int b = 0; b < nbat; ++b) {
    cp_async_wait<ST - 2>();  // this thread's chunks of stage b landed
    const unsigned char* slot = smem + (b % ST) * C::kStageBytes;
    float* wsb = ws + (b % 2) * KS * LDW;
    float* xsb = xs + (b % 2) * KS * LDX;
    if (tid < C::kWChunks) {  // dequantize the weight chunk: 16 columns
      const uint4 raw = *reinterpret_cast<const uint4*>(slot + 16 * tid);
      float* row = wsb + (tid / 4) * LDW + wc;
      *reinterpret_cast<float4*>(row) = dequant4(raw.x, sc, WT());
      *reinterpret_cast<float4*>(row + 4) = dequant4(raw.y, sc + 4, WT());
      *reinterpret_cast<float4*>(row + 8) = dequant4(raw.z, sc + 8, WT());
      *reinterpret_cast<float4*>(row + 12) = dequant4(raw.w, sc + 12, WT());
    }
    const float* xr =
        reinterpret_cast<const float*>(slot + 16 * C::kWChunks);
#pragma unroll
    for (int e = tid; e < C::kXChunks; e += kThreads) {  // transpose x
      const int m = e % BM, c = 4 * (e / BM);
      const float4 v = *reinterpret_cast<const float4*>(xr + 4 * e);
      xsb[c * LDX + m] = v.x;
      xsb[(c + 1) * LDX + m] = v.y;
      xsb[(c + 2) * LDX + m] = v.z;
      xsb[(c + 3) * LDX + m] = v.w;
    }
    if (b + ST - 1 < nbat)  // into the slot of stage b - 1, converted above
      load_stage<TM>(smem + ((b + ST - 1) % ST) * C::kStageBytes, a,
                     (b0 + b + ST - 1) * KS, kend, m0, n0);
    cp_async_commit();
    // the tiles of stage b are whole; every thread is past stage b - 1's
    // products, so the next stage may overwrite their buffers
    __syncthreads();
    // the products, the shared loads of step k + 2 issued before the FMAs
    // of step k (a ring of three register fragments)
    float4 xf[3][TM / 4], wf[3];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      load_frag<TM>(xsb, wsb, k, mg, ng, xf[k], wf[k]);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k + 2 < KS)
        load_frag<TM>(xsb, wsb, k + 2, mg, ng, xf[(k + 2) % 3],
                      wf[(k + 2) % 3]);
      const float4 wv = wf[k % 3];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 xq = xf[k % 3][i / 4];
        const float xv = i % 4 == 0 ? xq.x : i % 4 == 1 ? xq.y
                         : i % 4 == 2 ? xq.z : xq.w;
        acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
      }
    }
  }
  cp_async_wait<0>();
  if (gridDim.x == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      store4(a, m0 + TM * mg + i, n0 + 4 * ng,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    return;
  }
  __syncthreads();  // the ring's last reads are done: it holds the partial
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < TM; ++i)
    *reinterpret_cast<float4*>(part + (TM * mg + i) * BN + 4 * ng) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster_store(a, part, BM, m0, n0);
}

// -- host ---------------------------------------------------------------------

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// A launch: the tile rows (streaming: mr = MR, tm = 0; tiled: tm, 16 tm
// rows), the K splits (the cluster size) and the 32-row stages of each.
struct Plan {
  int tm, mr, splits, per;
};

Plan plan(int M, int K, int N, int m0) {
  const int sms = sm_count();
  const int nb = (K + KS - 1) / KS;
  const int n_tiles = (N + BN - 1) / BN;
  auto fit = [&](int tm, int mr, int splits) {
    if (splits > nb) splits = nb;
    if (splits > kMaxCluster) splits = kMaxCluster;
    if (splits < 1) splits = 1;
    const int per = (nb + splits - 1) / splits;
    return Plan{tm, mr, (nb + per - 1) / per, per};
  };
  if (M <= m0) {
    // streaming: enough K splits to keep a block on every SM reading
    int mr = 1;
    while (mr < M && mr < 16) mr *= 2;
    const int tiles = n_tiles * ((M + mr - 1) / mr);
    return fit(0, mr, sms / tiles);
  }
  // tiled: the tile height and K splits that put the fewest FMAs (plus two
  // stages of fill and drain a block) on the busiest SM, where a block
  // alone on its SM counts double (one block's 8 warps cannot hide the
  // latency of its shared loads)
  Plan best = fit(8, 128, 1);
  long long best_cost = -1;
  for (int tm = 4; tm <= 8; tm += 4) {
    const int tiles = n_tiles * ((M + 16 * tm - 1) / (16 * tm));
    for (int s = 1; s <= kMaxCluster; ++s) {
      const Plan pl = fit(tm, 16 * tm, s);
      const long long blocks = static_cast<long long>(tiles) * pl.splits;
      const long long per_sm = (blocks + sms - 1) / sms;
      const long long cost =
          (per_sm == 1 ? 2 : per_sm) * (16LL * tm) * (pl.per + 2);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = pl;
      }
    }
  }
  return best;
}

template <typename K>
int launch(K kernel, size_t smem, int rows, const Args& a, const Plan& pl,
           cudaStream_t stream, bool& ready) {
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.splits, (a.N + BN - 1) / BN, (a.M + rows - 1) / rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.splits > 1 ? 1 : 0;
  Args args = a;
  args.per = pl.per;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, int MR>
int launch_gemv(const Args& a, const Plan& pl, cudaStream_t s) {
  static bool ready = false;
  return launch(dequant_gemv_kernel<WT, MR>, Gemv<MR>::kSmem, MR, a, pl, s,
                ready);
}

template <typename WT, int TM>
int launch_gemm(const Args& a, const Plan& pl, cudaStream_t s) {
  static bool ready = false;
  return launch(dequant_gemm_kernel<WT, TM>, Cfg<TM>::kSmem, 16 * TM, a, pl,
                s, ready);
}

template <typename WT>
int dispatch(const Args& a, const Plan& pl, cudaStream_t s) {
  if (pl.tm == 4) return launch_gemm<WT, 4>(a, pl, s);
  if (pl.tm == 8) return launch_gemm<WT, 8>(a, pl, s);
  switch (pl.mr) {
    case 1: return launch_gemv<WT, 1>(a, pl, s);
    case 2: return launch_gemv<WT, 2>(a, pl, s);
    case 4: return launch_gemv<WT, 4>(a, pl, s);
    case 8: return launch_gemv<WT, 8>(a, pl, s);
  }
  return launch_gemv<WT, 16>(a, pl, s);
}

}  // namespace

// The launch the kernel takes for an (M, K, N) product with streaming up
// to M = m0: the tile's rows, its K splits (returned: the cluster size) and
// the 32-row stages of each split. For the timing tools.
extern "C" int dequant_gemm_plan(int M, int K, int N, int m0, int* rows,
                                 int* per) {
  if (M < 1 || K < 1 || N < 1) return 0;
  const Plan pl = plan(M, K, N, m0);
  *rows = pl.mr;
  *per = pl.per;
  return pl.splits;
}

// w_dtype codes: 2 int8, 3 float8_e4m3fn. x (M, K) fp32, w_q (K, N), scale
// (N,) fp32 and out (M, N) fp32, all contiguous; M <= m0 takes the
// streaming kernel, larger M the tiled one. One kernel launch.
extern "C" int dequant_gemm(const void* x, const void* w_q, const void* scale,
                            void* out, int M, int K, int N, int w_dtype,
                            int m0, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const uint8_t*>(w_q);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  a.x_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w_q) % 16 == 0;
  a.w_vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(w_q) % 4 == 0;
  const Plan pl = plan(M, K, N, m0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 2) return dispatch<int8_t>(a, pl, s);
  if (w_dtype == 3) return dispatch<__nv_fp8_e4m3>(a, pl, s);
  return (int)cudaErrorInvalidValue;
}
