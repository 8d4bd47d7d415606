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
// k % bs, the id clamped into [0, N - 1]: the unallocated id N is never
// dereferenced, as the plain chain clips it), the mask is decode
// `kpos < ctx` or prefill/verify `kpos <= qpos && kpos < ctx`, and a
// masked score is FILL (-30000), not -inf. Pools are fp32, bf16, or int8 /
// fp8 e4m3 with one fp32 scale per (block, row, head). Math is fp32; the
// output takes q's dtype.
//
// What bounds it on the H100 (H = 12, D = 64, bs = 16): a decode step
// (C = 1) reads each visible K/V element once for 4 FLOPs: bytes. A
// 128-row prefill chunk does 128 times the arithmetic on the same bytes;
// with fp32 products on the tensor cores in 3xTF32 (495/3 TFLOP/s) it is
// still bound by operations, but a chunk of one lane has only 12 heads x
// 2 query tiles of work for 132 SMs: it is latency-bound unless the keys
// are split too.
//
// Design: one kernel a call, in one of two regimes chosen by C before the
// launch.
//   - Prefill / verify (C > 1, paged_prefill_kernel): 8 warps own a tile
//     of 64 query rows (kept as fp32 in shared memory), a warp 16 rows and
//     one 32-key half of each key tile of 64, walked in a double-buffered
//     cp.async ring; the two halves' partials are combined in that order
//     at the end (one warp a scheduler left the tile's latency bare, and
//     the second half doubles the warps without more shared memory). K and
//     V rows are gathered through the lane's block table in the pool's own
//     dtype (16-byte copies, rows padded by 16 bytes so that every
//     fragment load is free of bank conflicts). The products run on
//     mma.sync with fp32 accumulators, by the operands' dtypes:
//       * bf16 queries over bf16, int8 or e4m3 pools (all exact in bf16):
//         S = Q K^T on bf16 m16n8k16, one product (bf16 x bf16 is exact in
//         fp32); O += P V with P split into a bf16 hi and lo (P to about
//         2^-17 of itself) against V exact in bf16: two products;
//       * otherwise m16n8k8 TF32 (csrc/tf32x3.cuh): an fp32 operand is
//         split into a TF32 hi and lo and a product is summed from three
//         TF32 products (3xTF32, within about 2^-20 of |a| |b|); a side
//         exact in TF32 (bf16 queries; bf16, int8 and e4m3 pool values)
//         needs no lo, and its products take two.
//     int8 / e4m3 rows enter raw: K's row scale multiplies the score and
//     V's row scale multiplies p. The online
//     softmax runs in registers (the fp32 flash forward's, csrc/
//     flash_fwd_f32.cu). A key tile wholly past the tile's last query
//     position is not walked: under the mask it would add exp(FILL - m) =
//     0 to every row (each row sees key 0).
//   - Decode (C = 1, paged_decode_kernel): K/V rows stay in the pool's
//     dtype in shared memory (16-byte cp.async copies, double-buffered key
//     tiles of 32); each warp owns 8 keys a tile, scores them with its
//     lanes across D and a transposing shuffle reduce (9 shuffles for 8
//     keys), keeps its own online softmax, and adds p V with its lanes
//     across D. The 4 warps' partials are combined in warp order at the
//     end.
//   - Splits: the keys of a (lane, head, query tile) are split over the S
//     blocks of a thread-block cluster (S <= 8, from the shapes: enough
//     blocks for the card). The split follows the lane's own context, read
//     on the device (no host sync): a live lane walks keys [0, ctx) (in
//     prefill [0, min(ctx, last query position + 1))), cut into tiles and
//     shared evenly by rank; a block whose share is empty skips the walk
//     and only helps merge. Each block leaves its running max, sum and
//     unnormalized accumulator in its shared memory; after a cluster
//     barrier each block combines its share of the output elements from
//     every split through distributed shared memory, in rank order. So a
//     call is one kernel, with no workspace, and reruns are bit-identical
//     (every sum in a fixed order).
//   - An idle lane (ctx = 0) walks all M table entries: every score is
//     FILL and its rows are the plain chain's uniform average over every
//     row. Keys past the walk take -inf and zero rows.
// Online softmax sums in another order than the plain chain's full
// softmax, so agreement is to a tolerance, not bitwise.
//
// Where the time goes (H100, clock64 stamps a block, PERF.md section 6): a
// prefill block spends about a quarter of its time until its first tile
// lands (every block stages at once: an L2 burst), half in the walk and a
// fifth in the merge; a decode block's critical path is its rank's chain
// of tiles, and the ranks of a cluster wait at the merge barrier for the
// slowest.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "tf32x3.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kDecThreads = 128;   // 4 warps, 8 keys a tile each
constexpr int kPreThreads = 256;   // 8 warps: 4 row slabs x 2 key halves
constexpr int kMaxD = 128;
constexpr int kMaxCluster = 8;
constexpr int kPreKeys = 64;       // keys a prefill tile
constexpr int kPreRows = 64;       // query rows a prefill tile
constexpr int kDecKeys = 32;       // keys a decode tile (8 a warp)
constexpr int kDecodeBlocks = 1024;  // blocks a decode launch aims at
constexpr int kPrefillBlocks = 264;  // two blocks an SM
constexpr float kFill = -30000.0f;

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* tbl;
  const int* qpos;   // [B, C] or null (the decode mask)
  const int* ctx;
  void* out;
  int C, H, D, N, bs, M, splits, q_bf16;
  float scale;
};

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

__device__ __forceinline__ float load_q(const Args& a, size_t i) {
  return a.q_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i])
             : static_cast<const float*>(a.q)[i];
}

__device__ __forceinline__ void store_out(const Args& a, size_t i, float v) {
  if (a.q_bf16)
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(a.out)[i] = v;
}

// The keys a (lane, query tile) walks: [0, kend). A live lane stops at
// its context (and, in prefill, past the tile's last query position); an
// idle lane walks every table entry.
__device__ __forceinline__ int walk_end(const Args& a, int ctx, int qmax) {
  const int all = a.M * a.bs;
  if (ctx <= 0) return all;
  int kend = min(ctx, all);
  if (a.qpos != nullptr && qmax >= 0) kend = min(kend, qmax + 1);
  return kend;
}

// A 16-byte cp.async, zeros when !in, without the memory clobber of
// cp_async.cuh's copies, so that the compiler may hoist a thread's table
// loads for its later copies above its earlier ones. Safe: a staged tile
// is read only after cp_async_wait and a barrier, which clobber memory.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

// Stage keys [k0, k0 + R) of lane b, head h: K and V rows in the pool's
// dtype into rows of LD elements (columns < D), their scales (int8 / fp8)
// into ksd / vsd; keys at or past kend become zeros.
template <typename KVT, int R, int LD, int NT>
__device__ __forceinline__ void stage_kv(const Args& a, KVT* kd, KVT* vd,
                                         float* ksd, float* vsd, int b,
                                         int h, int k0, int kend) {
  constexpr int kPer = 16 / sizeof(KVT);  // elements a copy
  const KVT* kp = static_cast<const KVT*>(a.kp);
  const KVT* vp = static_cast<const KVT*>(a.vp);
  const int cpr = a.D / kPer;             // copies a row
  const int* tbl = a.tbl + static_cast<size_t>(b) * a.M;
#pragma unroll 4
  for (int e = threadIdx.x; e < R * cpr; e += NT) {
    const int r = e / cpr, c = e - r * cpr;
    const int k = k0 + r;
    const bool in = k < kend;
    size_t off = 0;
    if (in) {
      const int id = min(max(tbl[k / a.bs], 0), a.N - 1);
      off = ((static_cast<size_t>(id) * a.bs + k % a.bs) * a.H + h) * a.D +
            c * kPer;
    }
    copy16(kd + r * LD + c * kPer, kp + off, in);
    copy16(vd + r * LD + c * kPer, vp + off, in);
  }
  if (sizeof(KVT) == 1) {
    for (int r = threadIdx.x; r < R; r += NT) {
      const int k = k0 + r;
      const bool in = k < kend;
      size_t row = 0;
      if (in) {
        const int id = min(max(tbl[k / a.bs], 0), a.N - 1);
        row = (static_cast<size_t>(id) * a.bs + k % a.bs) * a.H + h;
      }
      cp_async4(ksd + r, a.ks + row, in);
      cp_async4(vsd + r, a.vs + row, in);
    }
  }
}

// Columns [D, DP) of every row of n tiles of R rows: zeros (the copies
// never write them; the products read them).
template <typename KVT, int R, int LD, int DP, int NT>
__device__ __forceinline__ void zero_tail(KVT* t, int n, int tile_elems,
                                         int D) {
  const int w = DP - D;
  if (w <= 0) return;
  for (int e = threadIdx.x; e < n * R * w; e += NT) {
    const int i = e / (R * w), rem = e - i * R * w;
    const int r = rem / w, c = D + rem % w;
    t[i * tile_elems + r * LD + c] = KVT();
  }
}

// Each block of the cluster holds, for R rows, m[R], l[R] and acc[R][LDA]
// in `part` (its own shared memory; ranks >= live walked nothing and hold
// none). Block `rank` writes its share of the rows' output elements: the
// splits' accumulators weighted by exp(m_s - max m) over their weighted
// sums, splits taken in rank order. A thread issues every split's loads
// of an element before it adds: one round trip to the other SMs an
// element, and few registers, so the walk keeps its occupancy. (Measured
// on the H100: four elements' loads at once, and pushing the partials
// into the writers' shared memory with one barrier, were both slower.)
template <int NT>
__device__ __forceinline__ void merge_store(const Args& a, float* part,
                                            int R, int LDA, int rows,
                                            int live, int rank, int b,
                                            int c0, int h) {
  const int S = a.splits, D = a.D;
  if (S == 1)  // every partial is written
    __syncthreads();
  else
    cg::this_cluster().sync();
  const int total = rows * D;
  const int begin = rank * total / S, end = (rank + 1) * total / S;
  for (int e = begin + threadIdx.x; e < end; e += NT) {
    const int r = e / D, d = e - r * D;
    float mv[kMaxCluster], lv[kMaxCluster], av[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < live) {
        const float* p =
            S == 1 ? part : cg::this_cluster().map_shared_rank(part, s);
        mv[s] = p[r];
        lv[s] = p[R + r];
        av[s] = p[2 * R + r * LDA + d];
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (s < live) mx = fmaxf(mx, mv[s]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < live) {
        const float w = mv[s] == -INFINITY ? 0.f : expf(mv[s] - mx);
        num = fmaf(av[s], w, num);
        den = fmaf(lv[s], w, den);
      }
    }
    store_out(a, ((static_cast<size_t>(b) * a.C + c0 + r) * a.H + h) * D + d,
              num / den);
  }
  if (S > 1) cg::this_cluster().sync();  // no block leaves while read
}

// -- prefill / verify: mma.sync TF32 --------------------------------------

// B fragment (8 of the reduction x 8 columns), reduction along D: row n0 +
// g of a tile, columns c0 + q, c0 + q + 4 (lane = 4 g + q). EXACT: the
// values are exact in TF32 and need no lo.
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_b_d(const T* t, int ld, int n0, int c0,
                                         int lane, uint32_t (&hi)[2],
                                         uint32_t (&lo)[2]) {
  const T* p = t + (n0 + lane / 4) * ld + c0 + lane % 4;
  const float x = to_f32(p[0]), y = to_f32(p[4]);
  if (EXACT) {
    hi[0] = __float_as_uint(x);
    hi[1] = __float_as_uint(y);
  } else {
    flash::split(x, hi[0], lo[0]);
    flash::split(y, hi[1], lo[1]);
  }
}

// B fragment, reduction along the tile's rows: rows r0 + 2 q and r0 + 2 q
// + 1, column c0 + g (flash::frag_a_regs's order).
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_b_rows(const T* t, int ld, int r0,
                                            int c0, int lane,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const T* p = t + (r0 + 2 * (lane % 4)) * ld + c0 + lane / 4;
  const float x = to_f32(p[0]), y = to_f32(p[ld]);
  if (EXACT) {
    hi[0] = __float_as_uint(x);
    hi[1] = __float_as_uint(y);
  } else {
    flash::split(x, hi[0], lo[0]);
    flash::split(y, hi[1], lo[1]);
  }
}

// d += a b from split a and (split or exact) b: the small terms first
template <bool EXACT>
__device__ __forceinline__ void mma_ab(float* d, const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4],
                                       const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  if (EXACT) {
    flash::mma_tf32(d, al, bh);
    flash::mma_tf32(d, ah, bh);
  } else {
    flash::mma3(d, ah, al, bh, bl);
  }
}

// Two bf16 in one register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x and y as bf16 pairs hi and lo, x ~ hi + lo to about 2^-17 of x
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// Elements p[0] and p[1] of a row as a bf16 pair (exact for the pools'
// dtypes other than fp32)
template <typename T>
__device__ __forceinline__ uint32_t pair_bf16(const T* p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return *reinterpret_cast<const uint32_t*>(p);
  else
    return pack_bf16(to_f32(p[0]), to_f32(p[1]));
}

// d += a b on bf16 m16n8k16, fp32 accumulators: a (16 x 16) a0 (g, 2q..),
// a1 (g + 8, 2q..), a2 (g, 2q + 8..), a3 (g + 8, 2q + 8..); b (16 x 8)
// b0 (2q.., g), b1 (2q + 8.., g); d as m16n8k8's (lane = 4 g + q)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int DP, typename KVT>
struct Pre {
  static constexpr bool kExact = !std::is_same<KVT, float>::value;
  static constexpr int LDQ = DP + 4;                 // fp32 Q rows
  static constexpr int LD = DP + 16 / sizeof(KVT);   // K/V rows, elements
  static constexpr int kTile = kPreKeys * LD;        // elements
  static constexpr int kQBytes = kPreRows * LDQ * 4;
  static constexpr int kStageBytes =
      2 * kTile * static_cast<int>(sizeof(KVT)) + 2 * kPreKeys * 4;
  static constexpr int LDA = DP + 8;                 // partial accumulators
  static constexpr int kSmem = kQBytes + 2 * kStageBytes;
  static_assert(kSmem >= 4 * kPreRows * (2 + LDA), "partial area");
};

// QB: the queries are bf16 (exact in bf16 and TF32); over a pool of another
// dtype than fp32 the products then run on bf16 m16n8k16
template <int DP, typename KVT, bool QB>
__global__ void __launch_bounds__(kPreThreads)
    paged_prefill_kernel(const Args a) {
  using P = Pre<DP, KVT>;
  constexpr bool kBf16 = QB && P::kExact;
  constexpr int N = kPreKeys, LD = P::LD, NT = kPreThreads;
  constexpr int NH = N / 2;  // keys a warp a tile: its half
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* stages = smem + P::kQBytes;
  const int S = a.splits;
  const int rank = blockIdx.x % S, q0 = (blockIdx.x / S) * kPreRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kPreRows, a.C - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int slab = warp % 4, half = warp / 4;  // 16 rows, 32 keys a tile
  const int qa = 16 * slab + lane / 4, qb = qa + 8;  // tile rows
  const int ctx = a.ctx[b];
  const int* qp = a.qpos == nullptr
                      ? nullptr
                      : a.qpos + static_cast<size_t>(b) * a.C + q0;
  const int pa = (qp != nullptr && qa < rows) ? qp[qa] : INT_MIN;
  const int pb = (qp != nullptr && qb < rows) ? qp[qb] : INT_MIN;
  __shared__ int qmax_s[NT / 32];
  const int wmax = __reduce_max_sync(0xffffffffu, max(pa, pb));
  if (lane == 0) qmax_s[warp] = wmax;
  __syncthreads();
  int qmax = INT_MIN;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) qmax = max(qmax, qmax_s[w]);
  const int kend = walk_end(a, ctx, qmax);
  const int T = (kend + N - 1) / N;            // key tiles
  const int per = (T + S - 1) / S;             // a rank's tiles
  const int live = (T + per - 1) / per;        // ranks with tiles
  const int t0 = rank * per, t1 = min(T, t0 + per);

  auto k_tile = [&](int st) {
    return reinterpret_cast<KVT*>(stages + st * P::kStageBytes);
  };
  auto scales = [&](int st) {
    return reinterpret_cast<float*>(stages + st * P::kStageBytes +
                                    2 * P::kTile * sizeof(KVT));
  };
  auto stage = [&](int t) {  // key tile t into stage (t - t0) % 2
    const int st = (t - t0) % 2;
    KVT* kd = k_tile(st);
    stage_kv<KVT, N, LD, NT>(a, kd, kd + P::kTile, scales(st),
                             scales(st) + N, b, h, t * N, kend);
  };
  if (t0 < t1) {
    zero_tail<KVT, N, LD, DP, NT>(k_tile(0), 2, P::kTile, a.D);
    zero_tail<KVT, N, LD, DP, NT>(k_tile(1), 2, P::kTile, a.D);
    stage(t0);
  }
  cp_async_commit();
  if (t0 < t1) {  // Q as fp32, zeros past the chunk and past D
    constexpr int kPer = kPreRows * DP / NT;   // values a thread
    constexpr int kBatch = kPer < 16 ? kPer : 16;
    const size_t q_row = static_cast<size_t>(a.H) * a.D;
    const size_t q_base =
        (static_cast<size_t>(b) * a.C + q0) * q_row + h * a.D;
#pragma unroll
    for (int i0 = 0; i0 < kPer; i0 += kBatch) {
      float v[kBatch];  // every load of a batch before its stores
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = (i0 + u) * NT + threadIdx.x;
        const int r = e / DP, d = e % DP;
        v[u] = (r < rows && d < a.D) ? load_q(a, q_base + r * q_row + d)
                                     : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = (i0 + u) * NT + threadIdx.x;
        Qs[(e / DP) * P::LDQ + e % DP] = v[u];
      }
    }
  }

  const float* Qw = Qs + 16 * slab * P::LDQ;
  const bool live_lane = ctx > 0;
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) stage(t + 1);  // its stage was consumed at t - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t (and Q) landed for every thread
    const int st = (t - t0) % 2;
    const KVT* Kt = k_tile(st) + NH * half * LD;  // this warp's keys
    const KVT* Vt = Kt + P::kTile;
    const float* kss = scales(st) + NH * half;
    const float* vss = kss + N;
    const int k0 = t * N + NH * half;
    float s[NH / 2];
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) s[i] = 0.f;
    if constexpr (kBf16) {  // S = Q K^T, bf16: one product
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const float* qr = Qw + (lane / 4) * P::LDQ + 16 * kk + 2 * quad;
        const float2 x0 = *reinterpret_cast<const float2*>(qr);
        const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * P::LDQ);
        const float2 x2 = *reinterpret_cast<const float2*>(qr + 8);
        const float2 x3 =
            *reinterpret_cast<const float2*>(qr + 8 * P::LDQ + 8);
        const uint32_t qa[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                                pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
        for (int j = 0; j < NH / 8; ++j) {
          const KVT* kr = Kt + (8 * j + lane / 4) * LD + 16 * kk + 2 * quad;
          const uint32_t kb[2] = {pair_bf16(kr), pair_bf16(kr + 8)};
          mma_bf16(s + 4 * j, qa, kb);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {  // S = Q K^T, TF32
        uint32_t qh[4], ql[4];
        flash::frag_a(Qw, P::LDQ, 8 * kk, lane, qh, ql);
#pragma unroll
        for (int j = 0; j < NH / 8; ++j) {
          uint32_t bh[2], bl[2];
          frag_b_d<P::kExact>(Kt, LD, 8 * j, 8 * kk, lane, bh, bl);
          if constexpr (QB) {  // Q exact in TF32: no ql
            flash::mma_tf32(s + 4 * j, qh, bl);
            flash::mma_tf32(s + 4 * j, qh, bh);
          } else {
            mma_ab<P::kExact>(s + 4 * j, qh, ql, bh, bl);
          }
        }
      }
    }
    // scale (and K's row scale), the mask, -inf past the walk
#pragma unroll
    for (int j = 0; j < NH / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * quad + (e & 1);
        const int key = k0 + col;
        const int pos = (e & 2) ? pb : pa;
        float v = s[4 * j + e] * a.scale;
        if (sizeof(KVT) == 1) v *= kss[col];
        const bool vis =
            live_lane & (key < ctx) & (qp == nullptr || key <= pos);
        v = vis ? v : kFill;
        s[4 * j + e] = key < kend ? v : -INFINITY;
      }
    }
    // the online softmax (the second half's keys may all lie past the
    // walk: a running max of -inf then stays put)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) {
      if (i & 2)
        mx_b = fmaxf(mx_b, s[i]);
      else
        mx_a = fmaxf(mx_a, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = expf(m_a - mu_a), alpha_b = expf(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) {
      const float e = expf(s[i] - ((i & 2) ? mu_b : mu_a));
      if (i & 2)
        sum_b += e;
      else
        sum_a += e;
      // V's row scale rides on p
      s[i] = sizeof(KVT) == 1 ? e * vss[8 * (i / 4) + 2 * quad + (i & 1)]
                              : e;
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? alpha_b : alpha_a;
    if constexpr (kBf16) {  // O += P V, P split into bf16 hi and lo
#pragma unroll
      for (int kk = 0; kk < NH / 16; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[r], pl[r]);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const KVT* vr = Vt + (16 * kk + 2 * quad) * LD + 8 * j + lane / 4;
          const uint32_t vb[2] = {
              pack_bf16(to_f32(vr[0]), to_f32(vr[LD])),
              pack_bf16(to_f32(vr[8 * LD]), to_f32(vr[9 * LD]))};
          mma_bf16(o + 4 * j, pl, vb);
          mma_bf16(o + 4 * j, ph, vb);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NH / 8; ++kk) {  // O += P V, TF32
        uint32_t ph[4], pl[4];
        flash::frag_a_regs(s, kk, ph, pl);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          uint32_t bh[2], bl[2];
          frag_b_rows<P::kExact>(Vt, LD, 8 * kk, 8 * j, lane, bh, bl);
          mma_ab<P::kExact>(o + 4 * j, ph, pl, bh, bl);
        }
      }
    }
    __syncthreads();  // stage st is consumed
  }
  cp_async_wait<0>();
  __syncthreads();  // Q and the stages are free: the partials' area

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  // the block's partial, m[64], l[64], acc[64][LDA]: the second key half
  // parks its rows, the first adds them to its own (in that order)
  float* part = reinterpret_cast<float*>(smem);
  float* acc = part + 2 * kPreRows;
  if (t0 < t1 && half == 1) {
    if (quad == 0) {
      part[qa] = m_a;
      part[qb] = m_b;
      part[kPreRows + qa] = l_a;
      part[kPreRows + qb] = l_b;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      *reinterpret_cast<float2*>(acc + qa * P::LDA + c) =
          make_float2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<float2*>(acc + qb * P::LDA + c) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
  }
  __syncthreads();
  if (t0 < t1 && half == 0) {
    // the first half's keys include the tile's first: m is finite
    const float m2a = part[qa], m2b = part[qb];
    const float ma = fmaxf(m_a, m2a), mb = fmaxf(m_b, m2b);
    const float w1a = expf(m_a - ma), w1b = expf(m_b - mb);
    const float w2a = m2a == -INFINITY ? 0.f : expf(m2a - ma);
    const float w2b = m2b == -INFINITY ? 0.f : expf(m2b - mb);
    const float la = l_a * w1a + part[kPreRows + qa] * w2a;
    const float lb = l_b * w1b + part[kPreRows + qb] * w2b;
    if (S == 1) {  // no split: the output, straight from registers
      const size_t out_row = static_cast<size_t>(a.H) * a.D;
      const size_t base =
          (static_cast<size_t>(b) * a.C + q0) * out_row + h * a.D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * quad;
        const float2 ra = *reinterpret_cast<const float2*>(
            acc + qa * P::LDA + c);
        const float2 rb = *reinterpret_cast<const float2*>(
            acc + qb * P::LDA + c);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (c + x >= a.D) continue;
          const float va = (o[4 * j + x] * w1a + (x ? ra.y : ra.x) * w2a) / la;
          const float vb =
              (o[4 * j + 2 + x] * w1b + (x ? rb.y : rb.x) * w2b) / lb;
          if (qa < rows) store_out(a, base + qa * out_row + c + x, va);
          if (qb < rows) store_out(a, base + qb * out_row + c + x, vb);
        }
      }
      return;
    }
    if (quad == 0) {
      part[qa] = ma;
      part[qb] = mb;
      part[kPreRows + qa] = la;
      part[kPreRows + qb] = lb;
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      float2* pa2 = reinterpret_cast<float2*>(acc + qa * P::LDA + c);
      float2* pb2 = reinterpret_cast<float2*>(acc + qb * P::LDA + c);
      const float2 ra = *pa2, rb = *pb2;
      *pa2 = make_float2(o[4 * j] * w1a + ra.x * w2a,
                         o[4 * j + 1] * w1a + ra.y * w2a);
      *pb2 = make_float2(o[4 * j + 2] * w1b + rb.x * w2b,
                         o[4 * j + 3] * w1b + rb.y * w2b);
    }
  }
  if (S == 1) return;
  merge_store<NT>(a, part, kPreRows, P::LDA, rows, live, rank, b, q0, h);
}

// -- decode: the CUDA cores, lanes across D -------------------------------

template <int DP, typename KVT>
struct Dec {
  static constexpr int E = DP / 32;  // columns a lane
  static constexpr int kTile = kDecKeys * DP;  // elements
  static constexpr int kStageBytes =
      2 * kTile * static_cast<int>(sizeof(KVT)) + 2 * kDecKeys * 4;
  static constexpr int LDA = DP + 8;
  // the warps' partials (m, l, acc[DP]) and the block's (m, l, acc[LDA])
  static constexpr int kMergeFloats = 4 * (2 + DP) + 2 + LDA;
  static constexpr int kSmem = 2 * kStageBytes;
  static_assert(kSmem >= 4 * kMergeFloats, "partial area");
};

template <int DP, typename KVT>
__global__ void __launch_bounds__(kDecThreads)
    paged_decode_kernel(const Args a) {
  using P = Dec<DP, KVT>;
  constexpr int E = P::E;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.splits;
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ctx = a.ctx[b];
  const int pos = a.qpos == nullptr ? INT_MAX : a.qpos[b];
  const int kend = walk_end(a, ctx, a.qpos == nullptr ? -1 : pos);
  const int T = (kend + kDecKeys - 1) / kDecKeys;
  const int per = (T + S - 1) / S;
  const int live = (T + per - 1) / per;
  const int t0 = rank * per, t1 = min(T, t0 + per);

  auto k_tile = [&](int st) {
    return reinterpret_cast<KVT*>(smem + st * P::kStageBytes);
  };
  auto scales = [&](int st) {
    return reinterpret_cast<float*>(smem + st * P::kStageBytes +
                                    2 * P::kTile * sizeof(KVT));
  };
  auto stage = [&](int t) {
    const int st = (t - t0) % 2;
    KVT* kd = k_tile(st);
    stage_kv<KVT, kDecKeys, DP, kDecThreads>(a, kd, kd + P::kTile,
                                             scales(st),
                                             scales(st) + kDecKeys, b, h,
                                             t * kDecKeys, kend);
  };
  if (t0 < t1) {
    zero_tail<KVT, kDecKeys, DP, DP, kDecThreads>(k_tile(0), 2, P::kTile,
                                                  a.D);
    zero_tail<KVT, kDecKeys, DP, DP, kDecThreads>(k_tile(1), 2, P::kTile,
                                                  a.D);
    stage(t0);
  }
  cp_async_commit();

  float qv[E];
  const size_t q_base = (static_cast<size_t>(b) * a.H + h) * a.D;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int d = lane * E + j;
    qv[j] = d < a.D ? load_q(a, q_base + d) : 0.f;
  }
  const bool live_lane = ctx > 0;
  // this lane's key of each tile after the reduce: 4 b4 + 2 b3 + b2
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  const int mine = 8 * warp + 4 * b4 + 2 * b3 + b2;
  float m = -INFINITY, l = 0.f, acc[E];
#pragma unroll
  for (int j = 0; j < E; ++j) acc[j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = (t - t0) % 2;
    const KVT* Kt = k_tile(st) + 8 * warp * DP + lane * E;
    const KVT* Vt = Kt + P::kTile;
    const float* kss = scales(st);
    float part[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j)
        dot = fmaf(qv[j], to_f32(Kt[i * DP + j]), dot);
      part[i] = dot;
    }
    // transposing reduce: lanes differing in bit 4 exchange half their
    // keys, then bits 3 and 2; bits 1 and 0 then hold the same key
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = b4 ? part[i] : part[i + 4];
      const float keep = b4 ? part[i + 4] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = b3 ? part[i] : part[i + 2];
      const float keep = b3 ? part[i + 2] : part[i];
      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
    }
    {
      const float send = b2 ? part[0] : part[1];
      const float keep = b2 ? part[1] : part[0];
      part[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
    float v = part[0] + __shfl_xor_sync(0xffffffffu, part[0], 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    const int key = t * kDecKeys + mine;
    v *= a.scale;
    if (sizeof(KVT) == 1) v *= kss[mine];
    const bool vis = live_lane & (key < ctx) & (key <= pos);
    v = vis ? v : kFill;
    v = key < kend ? v : -INFINITY;
    // the warp's online softmax over its 8 keys
    float mt = v;
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
    const float mn = fmaxf(m, mt);
    const float mu = mn == -INFINITY ? 0.f : mn;  // no key of the warp yet
    const float alpha = expf(m - mu);
    const float p = expf(v - mu);
    float ps = p + __shfl_xor_sync(0xffffffffu, p, 16);
    ps += __shfl_xor_sync(0xffffffffu, ps, 8);
    ps += __shfl_xor_sync(0xffffffffu, ps, 4);
    l = l * alpha + ps;
    m = mn;
    const float pv = sizeof(KVT) == 1 ? p * kss[kDecKeys + mine] : p;
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] *= alpha;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int src = 16 * ((i >> 2) & 1) + 8 * ((i >> 1) & 1) + 4 * (i & 1);
      const float pi = __shfl_sync(0xffffffffu, pv, src);
#pragma unroll
      for (int j = 0; j < E; ++j)
        acc[j] = fmaf(pi, to_f32(Vt[i * DP + j]), acc[j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the 4 warps' partials, then the block's, in warp order
  float* wpart = reinterpret_cast<float*>(smem);  // [4][2 + DP]
  float* part = wpart + 4 * (2 + DP);             // m, l, acc[LDA]
  if (t0 < t1) {
    float* mine_p = wpart + warp * (2 + DP);
    if (lane == 0) {
      mine_p[0] = m;
      mine_p[1] = l;
    }
#pragma unroll
    for (int j = 0; j < E; ++j) mine_p[2 + lane * E + j] = acc[j];
    __syncthreads();
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wpart[w * (2 + DP)]);
    float wt[4], lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = wpart[w * (2 + DP)];
      wt[w] = mw == -INFINITY ? 0.f : expf(mw - mx);
      lsum = fmaf(wpart[w * (2 + DP) + 1], wt[w], lsum);
    }
    for (int d = threadIdx.x; d < DP; d += kDecThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        s = fmaf(wpart[w * (2 + DP) + 2 + d], wt[w], s);
      part[2 + d] = s;
    }
    if (threadIdx.x == 0) {
      part[0] = mx;
      part[1] = lsum;
    }
  }
  merge_store<kDecThreads>(a, part, 1, P::LDA, 1, live, rank, b, 0, h);
}

// -- host --------------------------------------------------------------------

// A launch: the regime (C = 1: decode), the key splits (the cluster
// size) and, in prefill, the query tiles.
struct Plan {
  bool decode;
  int splits, qtiles;
};

Plan plan(int B, int C, int H, int M, int bs) {
  Plan p;
  p.decode = C == 1;
  const int keys_tile = p.decode ? kDecKeys : kPreKeys;
  const long long tiles = (static_cast<long long>(M) * bs + keys_tile - 1) /
                          keys_tile;
  p.qtiles = p.decode ? 1 : (C + kPreRows - 1) / kPreRows;
  const long long pairs = static_cast<long long>(B) * H * p.qtiles;
  const long long target = p.decode ? kDecodeBlocks : kPrefillBlocks;
  long long s = (target + pairs - 1) / pairs;
  if (s > kMaxCluster) s = kMaxCluster;
  if (s > tiles) s = tiles;
  p.splits = s < 1 ? 1 : static_cast<int>(s);
  return p;
}

template <typename K>
int launch_kernel(K kernel, int threads, int smem, dim3 grid, int splits,
                  const Args& a, cudaStream_t stream, int& configured) {
  if (smem > configured) {  // the opt-in, static shared memory besides
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(cudaGetLastError());  // and clears it
}

template <int DP, typename KVT, bool QB>
int launch_prefill(const Args& a, const Plan& p, int B, cudaStream_t s) {
  static int configured = 0;
  return launch_kernel(paged_prefill_kernel<DP, KVT, QB>, kPreThreads,
                       Pre<DP, KVT>::kSmem, dim3(p.splits * p.qtiles, a.H, B),
                       p.splits, a, s, configured);
}

template <int DP, typename KVT>
int launch(const Args& a, const Plan& p, int B, cudaStream_t s) {
  if (p.decode) {
    static int configured = 0;
    return launch_kernel(paged_decode_kernel<DP, KVT>, kDecThreads,
                         Dec<DP, KVT>::kSmem, dim3(p.splits, a.H, B),
                         p.splits, a, s, configured);
  }
  return a.q_bf16 ? launch_prefill<DP, KVT, true>(a, p, B, s)
                  : launch_prefill<DP, KVT, false>(a, p, B, s);
}

template <typename KVT>
int dispatch_d(const Args& a, const Plan& p, int B, cudaStream_t s) {
  if (a.D <= 32) return launch<32, KVT>(a, p, B, s);
  if (a.D <= 64) return launch<64, KVT>(a, p, B, s);
  return launch<128, KVT>(a, p, B, s);
}

}  // namespace

// dtype codes: q 0 float32, 1 bfloat16; pools 0 float32, 1 bfloat16, 2
// int8, 3 float8_e4m3fn.
// Layouts: q / out [B, C, H, D]; pools [N, bs, H, D], 16-byte aligned,
// D a multiple of one 16-byte load; scales [N, bs, H] (int8 / fp8 pools
// only); block_tables [B, M] int32; q_positions [B, C] int32 or null
// (decode); context_lens [B] int32. All contiguous.
extern "C" int paged_read(const void* q, const void* k_pages,
                          const void* v_pages, const void* k_scales,
                          const void* v_scales, const void* block_tables,
                          const void* q_positions, const void* context_lens,
                          void* out, int B, int C, int H, int D, int N,
                          int bs, int M, int q_dtype, int kv_dtype,
                          float scale, void* stream) {
  static const int kv_bytes[4] = {4, 2, 1, 1};
  if (kv_dtype < 0 || kv_dtype > 3 || q_dtype < 0 || q_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (D < 1 || D > kMaxD || (D * kv_bytes[kv_dtype]) % 16 != 0 || B < 1 ||
      C < 1 || H < 1 || N < 1 || bs < 1 || M < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (kv_dtype >= 2 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, C, H, M, bs);
  Args a;
  a.q = q;
  a.kp = k_pages;
  a.vp = v_pages;
  a.ks = static_cast<const float*>(k_scales);
  a.vs = static_cast<const float*>(v_scales);
  a.tbl = static_cast<const int*>(block_tables);
  a.qpos = static_cast<const int*>(q_positions);
  a.ctx = static_cast<const int*>(context_lens);
  a.out = out;
  a.C = C;
  a.H = H;
  a.D = D;
  a.N = N;
  a.bs = bs;
  a.M = M;
  a.splits = p.splits;
  a.q_bf16 = q_dtype == 1;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return dispatch_d<float>(a, p, B, s);
    case 1: return dispatch_d<__nv_bfloat16>(a, p, B, s);
    case 2: return dispatch_d<int8_t>(a, p, B, s);
    default: return dispatch_d<__nv_fp8_e4m3>(a, p, B, s);
  }
}

// The launch a call of these shapes makes: returns the key splits (the
// cluster size) and sets *decode (1: the decode regime) and *qtiles.
extern "C" int paged_read_plan(int B, int C, int H, int M, int bs,
                               int* decode, int* qtiles) {
  if (B < 1 || C < 1 || H < 1 || M < 1 || bs < 1) return 0;
  const Plan p = plan(B, C, H, M, bs);
  *decode = p.decode ? 1 : 0;
  *qtiles = p.qtiles;
  return p.splits;
}
