// The 16-bit flash attention forward for Hopper (sm_90a): bf16 and fp16
// q, k, v read by (batch, head, row) strides, the kernel behind the
// forward of apex_tpu/ops/flash_attention.py's _fwd_single_kernel_bsh
// (B4), _fwd_kernel (B9) and _fwd_single_kernel (B10) for 16-bit inputs.
// The fp32 forward, the backward and the entry point flash_attn_fwd are in
// csrc/flash_attn.cu, whose header states the semantics this kernel keeps:
// the FILL mask, keys past Sk excluded, a fully masked row averaged over
// its Sk keys, lse = m + log(l) before dropout, the Philox keep bits of
// element ((b * NH + h) * Sq + q) * Sk + k, and p rounded to the input
// type before its product with V.
//
// What bounds it on the H100: at D 64 the special-function unit and the
// issue rate, not the tensor cores. GPT-2 small's causal shape (B 8, S
// 1024, NH 12, D 64) needs 12.9 GFLOP of products on 50 MB of inputs and
// outputs: 13 us at 989 TFLOP/s, 15 us at 3.35 TB/s. But every score also
// takes one exp2 on the SFU (16 a cycle an SM: as long as the score's 256
// FLOPs of products at D 64) and a dozen other instructions, and, with
// dropout, a quarter of a Philox4x32-10 call (about forty more).
//
// Design:
// - One pass over the keys with an online softmax, as JAX's tiled kernel
//   (B9): per row a running max m and sum l in registers, the output
//   accumulator rescaled by exp(m_old - m_new) for each key tile, and p
//   rounded against the running max (B4/B10's single-tile TPU kernels
//   round against the final max: bf16 results differ by rounding).
// - Persistent blocks, one an SM: a block walks work items (128 query
//   rows of one head: two consumer warpgroups of 64 rows) while one
//   producer warpgroup loads the next item's Q and key tiles as the
//   consumers finish the last, so an item's start and end overlap its
//   neighbours'. Registers move from the producer to the consumers
//   (setmaxnreg). Items are taken longest first (the last query tiles
//   under a causal mask), block c taking items c, c + #blocks, ...
// - The producer's one thread keeps 128-key K and V tiles in flight by TMA
//   (cp.async.bulk.tensor, 4-D maps over (D, rows, heads, batch) built on
//   the host from the strides, 128-byte swizzle, 64-byte at D 32) into a
//   ring of three stages (two at D 128), with mbarriers for full and empty
//   stages; Q arrives the same way once an item, into a buffer the
//   consumers release after their last Q K^T. Inputs TMA cannot describe
//   (a base or a stride off 16 bytes) are loaded by the producer's 128
//   threads element by element into the same swizzled layout.
// - S = Q K^T is wgmma.m64n128k16 with Q and K from shared memory (both
//   K-major); O += P V is wgmma.m64n{D}k16 with P from registers: the fp32
//   accumulator of S, converted to the input type, is the A operand in
//   place, and V (MN-major) is read with the transpose flag.
// - The two consumer warpgroups take turns to issue their products (named
//   barriers): a turn issues S of tile i and P V of tile i - 1, so one
//   warpgroup's softmax runs while the other's products do. The two are
//   committed apart: the warpgroup waits for S alone, forms the max and
//   the exponentials while its own P V runs on, and rescales O and packs
//   P once that is done. No wgmma sits under a branch (ptxas serialises
//   those): the first turn and the last are peeled off the loop.
// - The softmax runs on the accumulator in registers: a row's 128 scores
//   sit in the four lanes of a quad (two shuffles for its max and none for
//   its sum until the end); exp2 with log2(e) folded into the scale; the
//   mask and the Sk bound are applied only in tiles where they bite (a key
//   mask with a masked key in the tile, the last key tile, the causal
//   diagonal). Its branches are taken once a tile and the per-score work
//   is straight-line selects: a branch a score had cost more than the
//   score's arithmetic (the softmax ran 2.6x longer).
// - Dropout in registers: a thread's two columns of a row share a Philox
//   group of four with the neighbouring lane, so each lane computes the
//   group of one of its two rows and passes half of it by __shfl_xor.
//   When Sk % 4 != 0 a group may straddle two rows and every element draws
//   its own bits.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled
                   // is looked up at run time, so nothing new links
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "dtypes.cuh"
#include "flash_common.cuh"
#include "philox.cuh"

namespace flash {
namespace {

constexpr int kBQ = 128;   // query rows a block: two warpgroups of 64
constexpr int kBK = 128;   // keys a tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geo {
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  static_assert(kBQ == kBK, "Q and K/V tiles share one shape");
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;  // a swizzled row
  static constexpr int kSlabCols = kRowBytes / 2;       // columns a slab
  static constexpr int kSlabs = D / kSlabCols;
  static constexpr int kSlabBytes = kBK * kRowBytes;
  static constexpr int kTileBytes = kSlabs * kSlabBytes;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 0x70u : 0x30u;
  static constexpr int kSteps = D / 16;             // k16 steps of Q K^T
  static constexpr int kStepsPerSlab = kSlabCols / 16;
  static constexpr int kStages = D == 128 ? 2 : 3;  // K/V tiles in the ring
  // 1 KB to align the base (the swizzle repeats every 1024 bytes), Q, the
  // K and V rings, the mbarriers
  static constexpr size_t kSmem =
      1024 + (1 + 2 * kStages) * kTileBytes + 128;
};

// -- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of the given parity to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void producer_sync() {  // the producer's 128
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// The consumers' turns to issue products: warpgroup w waits on barrier
// 2 + w and, once its products are issued, hands the turn to the other.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the last committed group: with S and P V committed apart, S
__device__ __forceinline__ void wgmma_wait_but_last() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// ... and keep an A operand's registers live (not reused) until here.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout (1: 128-byte,
// 2: 64-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (layout << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- wgmma --------------------------------------------------------------------

// d[64 x 128] = A[64 x 16] B[16 x 128] (+ d unless scale_d is 0); A and
// B K-major in shared memory (descriptors da, db)
#define WGMMA_SS_N128(TY, d, da, db, scale_d) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39," \
      " %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55," \
      " %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))

// d[64 x 32] += A[64 x 16] B[16 x 32]; A in registers (a[0..3], the
// accumulator layout), B MN-major in shared memory (descriptor db)
#define WGMMA_RS_N32(TY, d, a, db) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d[64 x 64] += A[64 x 16] B[16 x 64]; A in registers (a[0..3], the
// accumulator layout), B MN-major in shared memory (descriptor db)
#define WGMMA_RS_N64(TY, d, a, db) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d[64 x 128] += A[64 x 16] B[16 x 128]; A in registers (a[0..3], the
// accumulator layout), B MN-major in shared memory (descriptor db)
#define WGMMA_RS_N128(TY, d, a, db) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39," \
      " %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55," \
      " %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_qk(float (&d)[kBK / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    WGMMA_SS_N128("f16", d, da, db, scale_d);
  else
    WGMMA_SS_N128("bf16", d, da, db, scale_d);
}

template <typename T, int D>
__device__ __forceinline__ void mma_pv(float (&d)[D / 2], const uint32_t* a,
                                       uint64_t db) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  if constexpr (D == 32) {
    if constexpr (f16) WGMMA_RS_N32("f16", d, a, db);
    else WGMMA_RS_N32("bf16", d, a, db);
  } else if constexpr (D == 64) {
    if constexpr (f16) WGMMA_RS_N64("f16", d, a, db);
    else WGMMA_RS_N64("bf16", d, a, db);
  } else {
    if constexpr (f16) WGMMA_RS_N128("f16", d, a, db);
    else WGMMA_RS_N128("bf16", d, a, db);
  }
}

// two fp32 values rounded to T, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    memcpy(&r, &v, 4);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    memcpy(&r, &v, 4);
  }
  return r;
}

// Rows [r0, r0 + 128) of a head (zeros at rows >= n) written element by
// element into the swizzled tile layout TMA would give (a slab of
// kSlabCols columns after the other), by the producer's 128 threads.
template <typename T, int D>
__device__ __forceinline__ void load_tile_elems(unsigned char* tile,
                                                const T* src, long long rs,
                                                int r0, int n, int t) {
  using G = Geo<D>;
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
  for (int e = t; e < kBK * D; e += 128) {
    const int r = e / D, c = e % D;
    const uint16_t v = r0 + r < n ? s16[(r0 + r) * rs + c] : uint16_t(0);
    uint32_t off = (c / G::kSlabCols) * G::kSlabBytes + r * G::kRowBytes +
                   (c % G::kSlabCols) * 2;
    off ^= (off >> 3) & G::kSwizzle;
    *reinterpret_cast<uint16_t*>(tile + off) = v;
  }
}

// What a consumer thread knows of its rows: qa and qb = qa + 8, its two
// columns of each 8-key block (2 quad, 2 quad + 1; the wgmma accumulator
// layout), the key mask row, and the rows' Philox element offsets.
struct Rows {
  int qa, qb, quad, lane, warp_lo;
  const uint8_t* kmask;
  unsigned long long ia, ib;
};

// Each row's running max m and sum l (l is this thread's share of the
// row until the end).
struct Stats {
  float m_a, m_b, l_a, l_b;
};

// S = Q K^T of one tile (raw dot products), issued, not awaited.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t sQw,
                                         uint32_t sKs) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
    const uint32_t off = (kk / G::kStepsPerSlab) * G::kSlabBytes +
                         (kk % G::kStepsPerSlab) * 32;
    mma_qk<T>(s, make_desc(sQw + off, 16, 8 * G::kRowBytes, G::kLayout),
              make_desc(sKs + off, 16, 8 * G::kRowBytes, G::kLayout),
              kk > 0);
  }
}

// O += P V of one tile, issued, not awaited.
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBK / 4],
                                         uint32_t sVs) {
  using G = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    mma_pv<T, D>(o, &pa[4 * kk],
                 make_desc(sVs + kk * 16 * G::kRowBytes, G::kSlabBytes,
                           8 * G::kRowBytes, G::kLayout));
}

// From a tile's raw scores s (keys k0 ..): the mask where it can bite, the
// online max and sum, and p = exp(s - m) with dropout, in s. Touches
// neither O nor P, so it runs while the last tile's P V is in flight;
// returns the rows' rescale factors for rescale_pack.
template <typename T, int D>
__device__ __forceinline__ float2 softmax_tile(float (&s)[kBK / 2],
                                               Stats& st, const Rows& r,
                                               const Params& p, int k0) {
  const int Sk = p.Sk, quad = r.quad;
  const float scale = p.scale;
  // Every branch below is uniform across the warp and taken once a tile;
  // the per-score work is straight-line selects (a branch a score costs
  // more than the score's arithmetic).
  bool masked = k0 + kBK > Sk || (p.causal && k0 + kBK - 1 > r.warp_lo) ||
                !(scale > 0.f);
  // bit 2 j + c: the key mask of column 8 j + 2 quad + c of this tile
  uint32_t colmask = 0;
  if (r.kmask != nullptr) {
    // lane l reads keys k0 + 4 l .. + 3, a byte each
    uint32_t mword = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = k0 + 4 * r.lane + e;
      const uint32_t hit = c < Sk ? r.kmask[c] != 0 : 0u;
      mword |= hit << (8 * e);
    }
    if (__any_sync(0xffffffffu, mword != 0)) {
      masked = true;
      const int sh = 16 * (quad & 1);  // the quad's two bytes of a word
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint32_t mw =
            __shfl_sync(0xffffffffu, mword, 2 * j + quad / 2);
        colmask |= (((mw >> sh) & 1u) | (((mw >> (sh + 8)) & 1u) << 1))
                   << (2 * j);
      }
    }
  }
  // row maxes and sums over four partials each (shorter dependency
  // chains); partial c takes the 8-key blocks j = c mod 4
  float mx_a[4], mx_b[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) mx_a[c] = mx_b[c] = -INFINITY;
  if (masked) {
    const bool causal = p.causal;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * quad + (e & 1);
        const int row = (e & 2) ? r.qb : r.qa;
        const bool dead =
            ((colmask >> (2 * j + (e & 1))) & 1u) | (causal & (col > row));
        float v = dead ? FILL : s[4 * j + e] * scale;
        v = col < Sk ? v : -INFINITY;
        s[4 * j + e] = v;
        if (e & 2)
          mx_b[j % 4] = fmaxf(mx_b[j % 4], v);
        else
          mx_a[j % 4] = fmaxf(mx_a[j % 4], v);
      }
    }
  } else {
#pragma unroll
    for (int idx = 0; idx < kBK / 2; ++idx) {
      const int c = (idx / 4) % 4;
      if (idx & 2)
        mx_b[c] = fmaxf(mx_b[c], s[idx]);
      else
        mx_a[c] = fmaxf(mx_a[c], s[idx]);
    }
  }
  float mxa = fmaxf(fmaxf(mx_a[0], mx_a[1]), fmaxf(mx_a[2], mx_a[3]));
  float mxb = fmaxf(fmaxf(mx_b[0], mx_b[1]), fmaxf(mx_b[2], mx_b[3]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
  }
  if (!masked) {  // the max of the raw dots, scaled (scale > 0)
    mxa *= scale;
    mxb *= scale;
  }
  const float mn_a = fmaxf(st.m_a, mxa), mn_b = fmaxf(st.m_b, mxb);
  const float alpha_a = ex2((st.m_a - mn_a) * kLog2e);
  const float alpha_b = ex2((st.m_b - mn_b) * kLog2e);
  // rounded apart, so that a score equal to the max gives exactly 1
  const float ml_a = __fmul_rn(mn_a, kLog2e);
  const float ml_b = __fmul_rn(mn_b, kLog2e);
  float sm_a[4] = {0.f, 0.f, 0.f, 0.f}, sm_b[4] = {0.f, 0.f, 0.f, 0.f};
  if (masked) {
#pragma unroll
    for (int idx = 0; idx < kBK / 2; ++idx) {
      const float e =
          ex2(__fmul_rn(s[idx], kLog2e) - ((idx & 2) ? ml_b : ml_a));
      s[idx] = e;
      if (idx & 2)
        sm_b[(idx / 4) % 4] += e;
      else
        sm_a[(idx / 4) % 4] += e;
    }
  } else {
    const float sl2 = scale * kLog2e;
#pragma unroll
    for (int idx = 0; idx < kBK / 2; ++idx) {
      const float e = ex2(fmaf(s[idx], sl2, (idx & 2) ? -ml_b : -ml_a));
      s[idx] = e;
      if (idx & 2)
        sm_b[(idx / 4) % 4] += e;
      else
        sm_a[(idx / 4) % 4] += e;
    }
  }
  const float sum_a = (sm_a[0] + sm_a[1]) + (sm_a[2] + sm_a[3]);
  const float sum_b = (sm_b[0] + sm_b[1]) + (sm_b[2] + sm_b[3]);
  st.l_a = st.l_a * alpha_a + sum_a;
  st.l_b = st.l_b * alpha_b + sum_b;
  st.m_a = mn_a;
  st.m_b = mn_b;

  // dropout on p (l stays pre-dropout)
  if (p.dropout) {
    if (Sk % 4 == 0) {
      // the pair of lanes (2c, 2c + 1) of a quad covers one group of four
      // columns of rows qa and qb: the even lane draws qa's group, the odd
      // lane qb's, and each passes the other half
      const bool odd = r.lane & 1;
      const unsigned long long mine = odd ? r.ib : r.ia;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const uint4 w = philox4x32_10(
            (mine + k0 + 8 * j + 4 * (quad >> 1)) >> 2, p.seed);
        const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
        const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
        const uint32_t bits[4] = {odd ? got0 : w.x, odd ? got1 : w.y,
                                  odd ? w.z : got0, odd ? w.w : got1};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] =
              bits[e] < p.threshold ? s[4 * j + e] * p.inv_keep : 0.f;
      }
    } else {  // a group may straddle two rows: bits element by element
      PhiloxCursor ca(p.seed), cb(p.seed);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * quad + (e & 1);
          const uint32_t bits =
              (e & 2) ? cb.bits(r.ib + col) : ca.bits(r.ia + col);
          s[4 * j + e] = bits < p.threshold ? s[4 * j + e] * p.inv_keep : 0.f;
        }
      }
    }
  }

  return make_float2(alpha_a, alpha_b);
}

// Once the last P V is done: O rescaled by the rows' factors, and P (p of
// this tile, in s) in the input type in pa, the A operand of the next
// P V.
template <typename T, int D>
__device__ __forceinline__ void rescale_pack(const float (&s)[kBK / 2],
                                             float (&o)[D / 2],
                                             uint32_t (&pa)[kBK / 4],
                                             float2 alpha) {
#pragma unroll
  for (int idx = 0; idx < D / 2; ++idx)
    o[idx] *= (idx & 2) ? alpha.y : alpha.x;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    pa[4 * kk + 0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
    pa[4 * kk + 1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
    pa[4 * kk + 2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
    pa[4 * kk + 3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A work item: query rows [q0, q0 + kBQ) of head h of batch row b, and
// the key tiles they visit. Item w takes query tile nq - 1 - w / (NH B),
// so the longest causal rows go first.
struct Work {
  int q0, h, b, ntiles;
};

__device__ __forceinline__ Work work_item(int w, const Params& p) {
  const int nq = (p.Sq + kBQ - 1) / kBQ, heads = p.NH * p.B;
  Work k;
  k.q0 = (nq - 1 - w / heads) * kBQ;
  k.h = (w % heads) % p.NH;
  k.b = (w % heads) / p.NH;
  const int kend = p.skip ? min(p.Sk, k.q0 + kBQ) : p.Sk;
  k.ntiles = (kend + kBK - 1) / kBK;
  return k;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const Params p, int tma, int out_vec) {
  using G = Geo<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sQ = raw + pad;
  const uint32_t sK = sQ + G::kTileBytes;  // stage st at + st * kTileBytes
  const uint32_t sV = sK + G::kStages * G::kTileBytes;
  // mbarriers: Q full, Q consumed; K full and V full per stage; stage
  // consumed
  const uint32_t bar_q = sV + G::kStages * G::kTileBytes;
  const uint32_t bar_qe = bar_q + 8;
  const uint32_t bar_k = bar_qe + 8, bar_v = bar_k + 8 * G::kStages;
  const uint32_t bar_e = bar_v + 8 * G::kStages;
  // the block walks items blockIdx.x, + gridDim.x, ...; the ring's stage
  // and phase follow the block's running count of key tiles
  const int nwork = ((p.Sq + kBQ - 1) / kBQ) * p.NH * p.B;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, 4 * kConsumers);  // one arrival a consumer warp
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // -- producer: each item's Q, then its K and V tiles into the ring ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int t = threadIdx.x - 128 * kConsumers;
    if (tma && t != 0) return;  // one thread issues every copy
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
      const Work wk = work_item(w, p);
      mbar_wait(bar_qe, (n & 1) ^ 1);  // the last item's Q is consumed
      if (tma) {
        mbar_expect_tx(bar_q, G::kTileBytes);
        for (int sl = 0; sl < G::kSlabs; ++sl)
          tma_load(sQ + sl * G::kSlabBytes, &qmap, bar_q, sl * G::kSlabCols,
                   wk.q0, wk.h, wk.b);
      } else {
        load_tile_elems<T, D>(
            base, static_cast<const T*>(p.q) + wk.b * p.lq.b + wk.h * p.lq.h,
            p.lq.r, wk.q0, p.Sq, t);
        fence_proxy_async();
        producer_sync();
        if (t == 0) mbar_arrive(bar_q);
      }
      for (int i = 0; i < wk.ntiles; ++i, ++tile) {
        const int st = tile % G::kStages;
        const uint32_t fk = bar_k + 8 * st, fv = bar_v + 8 * st;
        mbar_wait(bar_e + 8 * st, ((tile / G::kStages) & 1) ^ 1);
        if (tma) {
          mbar_expect_tx(fk, G::kTileBytes);
          for (int sl = 0; sl < G::kSlabs; ++sl)
            tma_load(sK + st * G::kTileBytes + sl * G::kSlabBytes, &kmap, fk,
                     sl * G::kSlabCols, i * kBK, wk.h, wk.b);
          mbar_expect_tx(fv, G::kTileBytes);
          for (int sl = 0; sl < G::kSlabs; ++sl)
            tma_load(sV + st * G::kTileBytes + sl * G::kSlabBytes, &vmap, fv,
                     sl * G::kSlabCols, i * kBK, wk.h, wk.b);
        } else {
          load_tile_elems<T, D>(
              base + (1 + st) * G::kTileBytes,
              static_cast<const T*>(p.k) + wk.b * p.lk.b + wk.h * p.lk.h,
              p.lk.r, i * kBK, p.Sk, t);
          fence_proxy_async();
          producer_sync();
          if (t == 0) mbar_arrive(fk);
          load_tile_elems<T, D>(
              base + (1 + G::kStages + st) * G::kTileBytes,
              static_cast<const T*>(p.v) + wk.b * p.lv.b + wk.h * p.lv.h,
              p.lv.r, i * kBK, p.Sk, t);
          fence_proxy_async();
          producer_sync();
          if (t == 0) mbar_arrive(fv);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows of each item a warpgroup -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const uint32_t sQw = sQ + 64 * wg * G::kRowBytes;
    float o[D / 2];
    float s[kBK / 2];
    uint32_t pa[kBK / 4];  // P of the last tile, the A operand of P V
    // Turn i issues S = Q K^T of tile i and O += P V of tile i - 1 (no
    // product under a branch: ptxas serialises those), then forms P of
    // tile i while the other warpgroup issues its turn. Both warpgroups
    // take ntiles + 1 turns an item.
    if (wg == 1) turn_pass(1);  // warpgroup 0 issues first
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < nwork; w += gridDim.x, ++n) {
      const Work wk = work_item(w, p);
      const int q0 = wk.q0, h = wk.h, b = wk.b, ntiles = wk.ntiles;
      Rows r;
      r.quad = quad;
      r.lane = lane;
      r.warp_lo = q0 + 64 * wg + 16 * warp;
      r.qa = r.warp_lo + lane / 4;
      r.qb = r.qa + 8;
      r.kmask = p.key_mask ? p.key_mask + static_cast<long long>(b) * p.Sk
                           : nullptr;
      const unsigned long long head_rows =
          static_cast<unsigned long long>(b * p.NH + h) * p.Sq;
      r.ia = (head_rows + r.qa) * p.Sk;
      r.ib = (head_rows + r.qb) * p.Sk;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      Stats stt{-INFINITY, -INFINITY, 0.f, 0.f};
      mbar_wait(bar_q, n & 1);
      {
        const int st = tile % G::kStages;
        mbar_wait(bar_k + 8 * st, (tile / G::kStages) & 1);
        turn_wait(wg);
        wgmma_fence();
        issue_qk<T, D>(s, sQw, sK + st * G::kTileBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait_all();
        fence_regs(s);
        if (ntiles == 1) {  // Q is consumed
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_qe);
        }
        rescale_pack<T, D>(s, o, pa, softmax_tile<T, D>(s, stt, r, p, 0));
      }
      for (int i = 1; i < ntiles; ++i) {
        const int ti = tile + i;
        const int st = ti % G::kStages;
        const int sp = (ti - 1) % G::kStages;
        mbar_wait(bar_k + 8 * st, (ti / G::kStages) & 1);
        mbar_wait(bar_v + 8 * sp, ((ti - 1) / G::kStages) & 1);
        turn_wait(wg);
        fence_regs(o);
        wgmma_fence();
        issue_qk<T, D>(s, sQw, sK + st * G::kTileBytes);
        wgmma_commit();
        issue_pv<T, D>(o, pa, sV + sp * G::kTileBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait_but_last();  // S of tile i; P V of tile i - 1 runs on
        fence_regs(s);
        if (i == ntiles - 1) {  // Q is consumed
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_qe);
        }
        const float2 alpha = softmax_tile<T, D>(s, stt, r, p, i * kBK);
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * sp);  // tile i - 1 consumed
        rescale_pack<T, D>(s, o, pa, alpha);
      }
      {
        const int ti = tile + ntiles - 1;
        const int sp = ti % G::kStages;
        mbar_wait(bar_v + 8 * sp, (ti / G::kStages) & 1);
        turn_wait(wg);
        fence_regs(o);
        wgmma_fence();
        issue_pv<T, D>(o, pa, sV + sp * G::kTileBytes);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait_all();
        fence_regs(o);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_e + 8 * sp);  // the last tile too
      }
      tile += ntiles;

      // out = O / l in the input type, lse = m + log(l)
      float l_a = stt.l_a, l_b = stt.l_b;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const float safe_a = l_a > 0.f ? l_a : 1.f;
      const float safe_b = l_b > 0.f ? l_b : 1.f;
      T* ob = static_cast<T*>(p.out) + b * p.lo.b + h * p.lo.h;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int q = hb ? r.qb : r.qa;
        if (q < p.Sq) {
          const float inv = 1.f / (hb ? safe_b : safe_a);
          T* row = ob + q * p.lo.r + 2 * quad;
          if (out_vec) {
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              *reinterpret_cast<uint32_t*>(row + 8 * j) = pack2<T>(
                  o[4 * j + 2 * hb] * inv, o[4 * j + 2 * hb + 1] * inv);
          } else {
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
              row[8 * j] = from_f32<T>(o[4 * j + 2 * hb] * inv);
              row[8 * j + 1] = from_f32<T>(o[4 * j + 2 * hb + 1] * inv);
            }
          }
          if (quad == 0)
            p.lse_out[head_rows + q] =
                (hb ? stt.m_b : stt.m_a) + logf(hb ? safe_b : safe_a);
        }
      }
    }
    if (wg == 0) turn_wait(0);  // take warpgroup 1's last pass
  }
}

// -- host ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The TMA map of one (B, NH, rows, D) operand: four dimensions (D, rows,
// heads, batch) by its strides, boxes of one slab (64 columns, or 32 at
// D 32) by 128 rows, zeros past the end of a head. False where TMA cannot
// describe it.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, const Layout& L, int rows,
              int NH, int B, int dtype) {
  using G = Geo<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  // a dimension of extent 1 may carry any stride: give it one TMA takes
  const long long sr = rows > 1 ? L.r : D;
  const long long sh = NH > 1 ? L.h : sr * rows;
  const long long sb = B > 1 ? L.b : sh * NH;
  if (sr <= 0 || sh <= 0 || sb <= 0) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                        static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(NH),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sr * 2),
                           static_cast<cuuint64_t>(sh * 2),
                           static_cast<cuuint64_t>(sb * 2)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kSlabCols),
                       static_cast<cuuint32_t>(kBK), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map,
             dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch(const Params& p, bool vec, int dtype, cudaStream_t s) {
  using G = Geo<D>;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const bool tma = vec &&
                   make_map<D>(&maps[0], p.q, p.lq, p.Sq, p.NH, p.B, dtype) &&
                   make_map<D>(&maps[1], p.k, p.lk, p.Sk, p.NH, p.B, dtype) &&
                   make_map<D>(&maps[2], p.v, p.lv, p.Sk, p.NH, p.B, dtype);
  const bool out_vec = reinterpret_cast<uintptr_t>(p.out) % 4 == 0 &&
                       p.lo.b % 2 == 0 && p.lo.h % 2 == 0 && p.lo.r % 2 == 0;
  auto kernel = flash_fwd_sm90_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one block an SM, each walking its share of the items
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items =
      static_cast<long long>((p.Sq + kBQ - 1) / kBQ) * p.NH * p.B;
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, kThreads, G::kSmem, s>>>(maps[0], maps[1], maps[2], p,
                                          tma ? 1 : 0, out_vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_d(const Params& p, int D, bool vec, int dtype,
                 cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, vec, dtype, s);
    case 64: return launch<T, 64>(p, vec, dtype, s);
    case 128: return launch<T, 128>(p, vec, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

int fwd_sm90(const Params& p, int D, int dtype, bool vec, cudaStream_t s) {
  if (dtype == 1) return launch_for_d<__nv_bfloat16>(p, D, vec, dtype, s);
  if (dtype == 2) return launch_for_d<__half>(p, D, vec, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
