// Paged attention read for the serving path (kernel B14), CUDA C++ for
// Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/paged_attention_pallas.py::_read_kernel (wrapper
// paged_read_attention), the Pallas TPU kernel behind
// apex_tpu/ops/flash_attention.py::paged_prefill_attention and
// paged_decode_attention.
//
// Computes, for every lane b, head h and query row c of a chunk:
//   out[b, c, h] = softmax_k(scale * q[b, c, h] . K[k, h], masked) @ V[:, h]
// where key k walks lane b's block table (pool block tbl[b, k / bs], row
// k % bs), the mask is decode `kpos < ctx` or prefill/verify
// `kpos <= qpos && kpos < ctx`, and a masked score is FILL (-30000), not
// -inf. Pools are fp32, bf16, or int8 / fp8 e4m3 with one fp32 scale per
// (block, row, head), dequantized as the rows are staged. Math is fp32;
// the output takes q's dtype.
//
// What bounds it on the H100 (H = 12, D = 64, bs = 16): a decode step
// (C = 1) reads each visible K/V element once for 4 fp32 FLOPs, about
// 0.5 FLOP per byte against the ~20 FLOP per byte at which the fp32 units
// (67 TFLOP/s over 3.35 TB/s) would become the limit: it is bound by
// bytes. A 128-row prefill chunk does 128 times the arithmetic on the
// same bytes, ~64 FLOP per byte, and is bound by fp32 operations. So the
// design reads each pool row from device memory once per query tile
// (later tiles of a chunk mostly hit L2), keeps the scores, the softmax
// state and the accumulator on chip, and puts enough blocks in flight to
// cover the card's 132 SMs.
//
// Design. The TPU kernel parks a whole context row's scores in VMEM,
// (H, C, M * bs) fp32, and normalizes once; at C = 64 and ctx 1024 that
// alone exceeds a block's 227 KB of shared memory. Here:
//   - one thread block per (query tile of <= 16 rows, key split, head,
//     lane); the block loads its own table indices (the TPU's scalar
//     prefetch);
//   - a split walks its share of the table in key tiles of 64 rows (4
//     pool blocks at bs = 16). K and V rows are staged through shared
//     memory with 16-byte loads, several in flight per thread, K with a
//     padded stride so the score loop is free of bank conflicts;
//   - online softmax (running max, sum and accumulator, fp32) over the
//     tiles, with the plain chain's mask algebra and FILL;
//   - a decode step has only B * H (lane, head) pairs, 96 at 8 lanes, so
//     the table is split across blocks until about four blocks per SM are
//     in flight (flash-decoding). Each split writes its running max, sum
//     and unnormalized accumulator to a workspace and a second kernel
//     merges the splits in a fixed order; one split writes the output
//     directly;
//   - table ids are clamped into [0, N - 1]: the unallocated id N is
//     never dereferenced (the plain chain clips the same way);
//   - a live lane walks ceil(ctx / bs) entries only: keys past ctx take
//     FILL in the plain chain, and exp(FILL - max) is 0 in fp32 whenever
//     one key is visible. An idle lane (ctx = 0) walks all M entries, so
//     its rows are the plain chain's uniform average over every row.
// Online softmax sums in another order than the plain chain's full
// softmax, so agreement is to a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQTile = 16;
constexpr int kMaxD = 128;
constexpr int kMaxAcc = kMaxQTile * kMaxD / kThreads;
constexpr int kKeyTile = 64;
constexpr int kStageUnroll = 4;   // 16-byte loads in flight per thread, K and V each
constexpr int kTargetBlocks = 4 * 132;
constexpr float kFill = -30000.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ws_m / ws_l: [B, C, H, S]; ws_acc: [B, C, H, S, D] (S = gridDim.y, used
// when S > 1; one split writes `out` directly).
template <typename QT, typename KVT, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_read_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ kp,
    const KVT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tbl,
    const int* __restrict__ qpos, const int* __restrict__ ctx_lens,
    QT* __restrict__ out, float* __restrict__ ws_m,
    float* __restrict__ ws_l, float* __restrict__ ws_acc, int C, int H,
    int D, int N, int bs, int M, int qtile, int nb, int split_entries,
    float scale) {
  constexpr int kVec = 16 / sizeof(KVT);   // elements per 16-byte load
  extern __shared__ float smem[];
  const int KT = nb * bs;
  float* q_s = smem;                      // [qtile][D]
  float* k_s = q_s + qtile * D;           // [KT][D + 1]
  float* v_s = k_s + KT * (D + 1);        // [KT][D]
  float* s_s = v_s + KT * D;              // [qtile][KT]
  float* m_s = s_s + qtile * KT;          // [qtile] running max
  float* l_s = m_s + qtile;               // [qtile] running sum
  float* a_s = l_s + qtile;               // [qtile] rescale factor
  int* qp_s = reinterpret_cast<int*>(a_s + qtile);  // [qtile]
  int* pg_s = qp_s + qtile;                          // [nb]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * qtile;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int h = blockIdx.z % H;
  const int b = blockIdx.z / H;
  const int rows = min(qtile, C - q0);
  const int ctx = ctx_lens[b];
  const bool decode = (qpos == nullptr);
  const int n_entries = ctx > 0 ? min(M, (ctx + bs - 1) / bs) : M;
  const int e_begin = split * split_entries;
  const int e_end = min(n_entries, e_begin + split_entries);

  for (int e = tid; e < qtile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float v = 0.f;
    if (r < rows) v = to_f32(q[(((size_t)b * C + q0 + r) * H + h) * D + d]);
    q_s[e] = v;
  }
  for (int r = tid; r < qtile; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
    qp_s[r] = (decode || r >= rows) ? 0 : qpos[(size_t)b * C + q0 + r];
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  const int row_vecs = D / kVec;
  const int tile_vecs = KT * row_vecs;
  for (int e0 = e_begin; e0 < e_end; e0 += nb) {
    const int t0 = e0 * bs;               // key position of the tile's row 0
    const int tile_keys = min(nb, e_end - e0) * bs;
    __syncthreads();  // the previous tile is consumed; init is visible
    for (int j = tid; j < nb; j += kThreads) {
      const int e = e0 + j;
      const int id = e < e_end ? tbl[(size_t)b * M + e] : 0;
      pg_s[j] = min(max(id, 0), N - 1);
    }
    __syncthreads();
    for (int base = 0; base < tile_vecs; base += kThreads * kStageUnroll) {
      uint4 kr[kStageUnroll], vr[kStageUnroll];
      float ksc[kStageUnroll], vsc[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int idx = base + u * kThreads + tid;
        const int k = idx / row_vecs;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        ksc[u] = vsc[u] = 1.f;
        if (idx < tile_vecs && k < tile_keys) {
          const size_t row = ((size_t)pg_s[k / bs] * bs + k % bs) * H + h;
          const size_t off = row * D + (idx % row_vecs) * kVec;
          kr[u] = *reinterpret_cast<const uint4*>(kp + off);
          vr[u] = *reinterpret_cast<const uint4*>(vp + off);
          if (QUANT) {
            ksc[u] = ks[row];
            vsc[u] = vs[row];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int idx = base + u * kThreads + tid;
        if (idx < tile_vecs) {
          const int k = idx / row_vecs, d0 = (idx % row_vecs) * kVec;
          const KVT* kv = reinterpret_cast<const KVT*>(&kr[u]);
          const KVT* vv = reinterpret_cast<const KVT*>(&vr[u]);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            k_s[k * (D + 1) + d0 + j] = to_f32(kv[j]) * ksc[u];
            v_s[k * D + d0 + j] = to_f32(vv[j]) * vsc[u];
          }
        }
      }
    }
    __syncthreads();
    for (int p = tid; p < qtile * KT; p += kThreads) {
      const int r = p / KT, k = p % KT;
      const int kpos = t0 + k;
      float s;
      if (k >= tile_keys) {
        s = -INFINITY;  // past this split's share: not a key of this block
      } else {
        const float* qr = q_s + r * D;
        const float* kr = k_s + k * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
        const bool visible =
            decode ? (kpos < ctx) : (kpos <= qp_s[r] && kpos < ctx);
        if (!visible) s = kFill;
      }
      s_s[p] = s;
    }
    __syncthreads();
    for (int r = warp; r < qtile; r += kThreads / 32) {
      float* sr = s_s + r * KT;
      float mx = -INFINITY;
      for (int k = lane; k < KT; k += 32) mx = fmaxf(mx, sr[k]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int k = lane; k < KT; k += 32) {
        const float pk = sr[k] == -INFINITY ? 0.f : expf(sr[k] - m_new);
        sr[k] = pk;
        sum += pk;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int p = tid + i * kThreads;
      if (p < qtile * D) {
        const int r = p / D, d = p % D;
        const float* pr = s_s + r * KT;
        float a = acc[i] * a_s[r];
        for (int k = 0; k < tile_keys; ++k)
          a = fmaf(pr[k], v_s[k * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int p = tid + i * kThreads;
    if (p < qtile * D) {
      const int r = p / D, d = p % D;
      if (r < rows) {
        const size_t row = ((size_t)b * C + q0 + r) * H + h;
        if (splits == 1) {
          store(&out[row * D + d], acc[i] / l_s[r]);
        } else {
          // a split past the lane's table walks nothing: max -inf, sum 0
          const size_t part = row * splits + split;
          ws_acc[part * D + d] = acc[i];
          if (d == 0) {
            ws_m[part] = m_s[r];
            ws_l[part] = l_s[r];
          }
        }
      }
    }
  }
}

// out[row, d] = sum_s acc[row, s, d] * w_s / sum_s l[row, s] * w_s with
// w_s = exp(m[row, s] - max_s m[row, s]), splits taken in order.
template <typename QT>
__global__ void merge_splits_kernel(const float* __restrict__ ws_m,
                                    const float* __restrict__ ws_l,
                                    const float* __restrict__ ws_acc,
                                    QT* __restrict__ out, int rows, int D,
                                    int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * D) return;
  const int row = i / D, d = i % D;
  const float* m = ws_m + (size_t)row * splits;
  const float* l = ws_l + (size_t)row * splits;
  const float* a = ws_acc + (size_t)row * splits * D + d;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = m[s] == -INFINITY ? 0.f : expf(m[s] - mx);
    num = fmaf(a[(size_t)s * D], w, num);
    den = fmaf(l[s], w, den);
  }
  store(&out[i], num / den);
}

struct Plan {
  int qtile, nb, splits, split_entries;
};

Plan plan(int B, int C, int H, int M, int bs) {
  Plan p;
  p.qtile = C < kMaxQTile ? C : kMaxQTile;
  p.nb = bs >= kKeyTile ? 1 : kKeyTile / bs;
  const int tiles = (M + p.nb - 1) / p.nb;
  const int blocks = B * H * ((C + p.qtile - 1) / p.qtile);
  int splits = (kTargetBlocks + blocks - 1) / blocks;
  if (splits > tiles) splits = tiles;
  if (splits < 1) splits = 1;
  const int per = (tiles + splits - 1) / splits;   // tiles per split
  p.split_entries = per * p.nb;
  p.splits = (tiles + per - 1) / per;
  return p;
}

template <typename QT, typename KVT, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tbl, const void* qpos,
           const void* ctx, void* out, void* workspace, int B, int C, int H,
           int D, int N, int bs, int M, float scale, cudaStream_t stream) {
  const Plan p = plan(B, C, H, M, bs);
  const int KT = p.nb * bs;
  const size_t smem =
      sizeof(float) * ((size_t)p.qtile * D + (size_t)KT * (D + 1) +
                       (size_t)KT * D + (size_t)p.qtile * KT +
                       3 * (size_t)p.qtile) +
      sizeof(int) * ((size_t)p.qtile + p.nb);
  auto kernel = paged_read_kernel<QT, KVT, QUANT>;
  static size_t configured = 0;  // largest opt-in granted so far
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  const size_t rows = (size_t)B * C * H;
  float* ws_m = static_cast<float*>(workspace);
  float* ws_l = ws_m + rows * p.splits;
  float* ws_acc = ws_l + rows * p.splits;
  dim3 grid((C + p.qtile - 1) / p.qtile, p.splits, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp),
      static_cast<const KVT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tbl),
      static_cast<const int*>(qpos), static_cast<const int*>(ctx),
      static_cast<QT*>(out), ws_m, ws_l, ws_acc, C, H, D, N, bs, M, p.qtile,
      p.nb, p.split_entries, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const int count = (int)(rows * D);
  merge_splits_kernel<QT><<<(count + 255) / 256, 256, 0, stream>>>(
      ws_m, ws_l, ws_acc, static_cast<QT*>(out), (int)rows, D, p.splits);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
                const void* ks, const void* vs, const void* tbl,
                const void* qpos, const void* ctx, void* out, void* ws,
                int B, int C, int H, int D, int N, int bs, int M, float scale,
                cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float, false>(q, kp, vp, ks, vs, tbl, qpos, ctx, out,
                                      ws, B, C, H, D, N, bs, M, scale, s);
    case 1:
      return launch<QT, __nv_bfloat16, false>(q, kp, vp, ks, vs, tbl, qpos,
                                              ctx, out, ws, B, C, H, D, N, bs,
                                              M, scale, s);
    case 2:
      return launch<QT, int8_t, true>(q, kp, vp, ks, vs, tbl, qpos, ctx, out,
                                      ws, B, C, H, D, N, bs, M, scale, s);
    case 3:
      return launch<QT, __nv_fp8_e4m3, true>(q, kp, vp, ks, vs, tbl, qpos,
                                             ctx, out, ws, B, C, H, D, N, bs,
                                             M, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The number of key splits paged_read uses for these shapes. The caller
// sizes the workspace from it: B * C * H * splits * (D + 2) floats when
// splits > 1.
extern "C" int paged_read_splits(int B, int C, int H, int M, int bs) {
  if (B < 1 || C < 1 || H < 1 || M < 1 || bs < 1) return 1;
  return plan(B, C, H, M, bs).splits;
}

// dtype codes: 0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn.
// Layouts: q / out [B, C, H, D]; pools [N, bs, H, D], 16-byte aligned,
// D a multiple of one 16-byte load; scales [N, bs, H] (int8 / fp8 pools
// only); block_tables [B, M] int32; q_positions [B, C] int32 or null
// (decode); context_lens [B] int32. All contiguous.
extern "C" int paged_read(const void* q, const void* k_pages,
                          const void* v_pages, const void* k_scales,
                          const void* v_scales, const void* block_tables,
                          const void* q_positions, const void* context_lens,
                          void* out, void* workspace, int B, int C, int H,
                          int D, int N, int bs, int M, int q_dtype,
                          int kv_dtype, float scale, void* stream) {
  static const int kv_bytes[4] = {4, 2, 1, 1};
  if (kv_dtype < 0 || kv_dtype > 3) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > kMaxD || (D * kv_bytes[kv_dtype]) % 16 != 0 || B < 1 ||
      C < 1 || H < 1 || N < 1 || bs < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (kv_dtype >= 2 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (paged_read_splits(B, C, H, M, bs) > 1 && workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scales,
                              v_scales, block_tables, q_positions,
                              context_lens, out, workspace, B, C, H, D, N, bs,
                              M, scale, s);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages,
                                      k_scales, v_scales, block_tables,
                                      q_positions, context_lens, out,
                                      workspace, B, C, H, D, N, bs, M, scale,
                                      s);
  return (int)cudaErrorInvalidValue;
}
