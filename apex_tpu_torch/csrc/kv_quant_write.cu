// The quantized KV write, CUDA C++ for Hopper (sm_90a): one launch a layer
// quantizes a chunk's valid K and V rows and writes payload and per-row
// scales into the int8 or fp8 pools.
//
// Not a TPU kernel: apex_tpu/serving/kv_cache.py::write_kv (:1403, with
// quantize_kv_rows at :1356) leaves this to XLA's fusion. In PyTorch the
// same chain is ~150 launches a (layer, K/V) for the noise alone, so the
// port writes it by hand (apex_tpu_torch/ops/kv_quant.py; plain version
// kv_quant_write_plain beside it).
//
// Per (token, head) row of D elements, with v the row in fp32:
//   scale = max|v| / qmax (qmax 127 for int8, 448 for fp8 e4m3),
//   x = v / (scale > 0 ? scale : 1),
//   int8: floor(x + u) clamped to [-127, 127] (0 where x is not finite),
//   fp8: x rounded to nearest even (saturating: |x| never exceeds 448 by
//   more than a rounding of the division).
// u is element e = h * D + d's noise: word e % 4 of Philox4x32-10 at
// counter (e / 4, position, 0, 0) under key (0x51CA17, stream), shifted
// right by 8 and scaled by 2^-24, so u is in [0, 1) on a 2^-24 grid; the
// stream is 2 * layer for K and 2 * layer + 1 for V. h is the head's index
// in the whole token row: a model shard's pool holds heads h0 .. h0 + H - 1
// (head_offset h0), so its bytes are the unsharded pool's head slice. The
// noise is a pure function of (stream, absolute position, element): a token
// rounds the same way in any lane, block, chunk, decode step or shard.
// Every operation is one IEEE fp32 operation rounded to nearest (__fdiv_rn,
// __fadd_rn, no contraction), as the plain version's torch ops are, so the
// two write the same bytes.
//
// Design: a warp per (token, head, K-or-V) row, four rows a block; a lane
// holds D / 32 elements (at most 8, D up to 256), the row's max is a warp
// shuffle reduction, and each element draws its own Philox word. What
// bounds it: the bytes (one read of each value, one write of each payload
// byte and scale); GPT-2 small's decode write (8 tokens x 12 heads x 64)
// is ~30 KB, far under a microsecond at 3.35 TB/s, so a launch costs its
// fixed overhead. A call with no valid row still launches one block that
// writes nothing, so every forward launches it once a layer.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "philox.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxPer = 8;  // elements a lane: D <= 256
constexpr unsigned int kSeed = 0x51CA17u;

template <typename T, bool FP8>
__global__ void __launch_bounds__(kWarps * 32) kv_quant_write_kernel(
    const T* __restrict__ k_vals, const T* __restrict__ v_vals,
    int8_t* __restrict__ k_pool, int8_t* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const long long* __restrict__ page, const long long* __restrict__ off,
    const long long* __restrict__ bi, const long long* __restrict__ si,
    const long long* __restrict__ pos, long long n, int S, int H, int D,
    int layer, int N, int bs, int h0) {
  const int lane = threadIdx.x & 31;
  const long long task =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (task >= n * H * 2) return;
  const int kv = static_cast<int>(task & 1);
  const int h = static_cast<int>((task >> 1) % H);
  const long long i = (task >> 1) / H;
  const T* vals = kv ? v_vals : k_vals;
  const long long src =
      ((bi[i] * S + si[i]) * H + h) * static_cast<long long>(D);
  float v[kMaxPer];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int d = lane + 32 * j;
    v[j] = d < D ? to_f32(vals[src + d]) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int m = 16; m; m >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  const float qmax = FP8 ? 448.f : 127.f;
  const float scale = __fdiv_rn(amax, qmax);
  const float safe = scale > 0.f ? scale : 1.f;
  const long long row = (static_cast<long long>(layer) * N + page[i]) * bs +
                        off[i];
  int8_t* dst = (kv ? v_pool : k_pool) + (row * H + h) * D;
  const unsigned int stream = 2u * static_cast<unsigned int>(layer) + kv;
  const unsigned int p = static_cast<unsigned int>(pos[i]);
#pragma unroll
  for (int j = 0; j < kMaxPer; ++j) {
    const int d = lane + 32 * j;
    if (d >= D) break;
    const float x = __fdiv_rn(v[j], safe);
    if (FP8) {
      dst[d] = static_cast<int8_t>(
          __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
    } else {
      const unsigned int e = static_cast<unsigned int>((h0 + h) * D + d);
      const uint4 r = philox4x32_10_words(e >> 2, p, kSeed, stream);
      const float u =
          __fmul_rn(static_cast<float>(philox_word(r, e & 3) >> 8),
                    5.9604644775390625e-08f);  // 2^-24
      float q = floorf(__fadd_rn(x, u));
      q = fminf(fmaxf(q, -127.f), 127.f);
      dst[d] = static_cast<int8_t>(isfinite(x) ? q : 0.f);
    }
  }
  if (lane == 0) (kv ? v_scale : k_scale)[row * H + h] = scale;
}

template <typename T, bool FP8>
int launch(const void* k_vals, const void* v_vals, void* k_pool,
           void* v_pool, float* k_scale, float* v_scale,
           const long long* page, const long long* off, const long long* b,
           const long long* s, const long long* pos, long long n, int S,
           int H, int D, int layer, int N, int bs, int h0,
           cudaStream_t stream) {
  long long blocks = (n * H * 2 + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  kv_quant_write_kernel<T, FP8><<<(unsigned int)blocks, kWarps * 32, 0,
                                  stream>>>(
      static_cast<const T*>(k_vals), static_cast<const T*>(v_vals),
      static_cast<int8_t*>(k_pool), static_cast<int8_t*>(v_pool), k_scale,
      v_scale, page, off, b, s, pos, n, S, H, D, layer, N, bs, h0);
  return (int)cudaGetLastError();
}

template <typename T>
int by_pool(int pool_mode, const void* k_vals, const void* v_vals,
            void* k_pool, void* v_pool, float* k_scale, float* v_scale,
            const long long* page, const long long* off, const long long* b,
            const long long* s, const long long* pos, long long n, int S,
            int H, int D, int layer, int N, int bs, int h0,
            cudaStream_t stream) {
  if (pool_mode == 0)
    return launch<T, false>(k_vals, v_vals, k_pool, v_pool, k_scale, v_scale,
                            page, off, b, s, pos, n, S, H, D, layer, N, bs,
                            h0, stream);
  if (pool_mode == 1)
    return launch<T, true>(k_vals, v_vals, k_pool, v_pool, k_scale, v_scale,
                           page, off, b, s, pos, n, S, H, D, layer, N, bs,
                           h0, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k_vals, v_vals: contiguous [B, S, H, D] of in_dtype (0 float32, 1
// bfloat16, 2 float16); k_pool, v_pool: contiguous [L, N, bs, H, D] int8
// (pool_mode 0) or fp8 e4m3 (pool_mode 1) bytes; k_scale, v_scale:
// contiguous fp32 [L, N, bs, H]; page, off, b, s, pos: n int64
// coordinates (write_coords), every page < N. n may be 0. head_offset: the
// global index of the pool's first head (0 unsharded).
extern "C" int kv_quant_write(const void* k_vals, const void* v_vals,
                              void* k_pool, void* v_pool, void* k_scale,
                              void* v_scale, const void* page,
                              const void* off, const void* b, const void* s,
                              const void* pos, long long n, int S, int H,
                              int D, int layer, int N, int bs,
                              int head_offset, int in_dtype, int pool_mode,
                              void* stream) {
  if (n < 0 || D < 1 || D > 32 * kMaxPer || H < 1 || head_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ks = static_cast<float*>(k_scale);
  float* vs = static_cast<float*>(v_scale);
  const long long* pg = static_cast<const long long*>(page);
  const long long* of = static_cast<const long long*>(off);
  const long long* bb = static_cast<const long long*>(b);
  const long long* ss = static_cast<const long long*>(s);
  const long long* ps = static_cast<const long long*>(pos);
  if (in_dtype == 0)
    return by_pool<float>(pool_mode, k_vals, v_vals, k_pool, v_pool, ks, vs,
                          pg, of, bb, ss, ps, n, S, H, D, layer, N, bs,
                          head_offset, st);
  if (in_dtype == 1)
    return by_pool<__nv_bfloat16>(pool_mode, k_vals, v_vals, k_pool, v_pool,
                                  ks, vs, pg, of, bb, ss, ps, n, S, H, D,
                                  layer, N, bs, head_offset, st);
  if (in_dtype == 2)
    return by_pool<__half>(pool_mode, k_vals, v_vals, k_pool, v_pool, ks, vs,
                           pg, of, bb, ss, ps, n, S, H, D, layer, N, bs,
                           head_offset, st);
  return (int)cudaErrorInvalidValue;
}
