// What the Hopper (sm_90a) flash kernels share: csrc/flash_fwd_sm90.cu (the
// 16-bit forward) and csrc/flash_bwd_sm90.cu (the 16-bit backward). The PTX
// wrappers for mbarriers, TMA and wgmma; the wgmma instructions at the
// shapes the kernels use; the swizzled tile geometry (Geo); the element
// loads that stand in for TMA; and, on the host, the TMA maps of the
// (B, NH, rows, D) operands read by stride.
//
// Tiles: rows of D 16-bit values in slabs of 64 columns (32 at D 32), each
// slab a run of 128-byte (64-byte) rows swizzled as TMA writes them with
// CU_TENSOR_MAP_SWIZZLE_128B (64B); the slab of an R-row tile is R rows
// long, and a tile starts on a 1024-byte boundary (the swizzle's period).
// A wgmma reads such a tile K-major (the product's reduction runs along D:
// Q K^T, K Q^T, dO V^T, V dO^T) or MN-major with the transpose flag (the
// reduction runs along the rows: P V, P^T dO, dS^T Q, dS K).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled
                   // is looked up at run time, so nothing new links
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "dtypes.cuh"
#include "flash_common.cuh"

namespace flash {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

// The swizzled layout of a tile of R rows of D columns.
template <int D, int R>
struct Geo {
  static_assert(D == 32 || D == 64 || D == 128, "head dim");
  static_assert(R % 8 == 0, "whole swizzle periods");
  static constexpr int kRowBytes = D >= 64 ? 128 : 64;  // a swizzled row
  static constexpr int kSlabCols = kRowBytes / 2;       // columns a slab
  static constexpr int kSlabs = D / kSlabCols;
  static constexpr int kSlabBytes = R * kRowBytes;
  static constexpr int kTileBytes = kSlabs * kSlabBytes;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 0x70u : 0x30u;
  static constexpr int kSteps = D / 16;  // k16 steps of a K-major product
  static constexpr int kStepsPerSlab = kSlabCols / 16;
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

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// One warp's share of releasing a buffer: every lane is past its reads.
__device__ __forceinline__ void warp_arrive(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are pending (the oldest finish
// first).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// d[64 x N] = A[64 x 16] B[16 x N] (+ d unless scale_d is 0); A and B
// K-major in shared memory (descriptors da, db)
#define WGMMA_SS_N32(TY, d, da, db, scale_d) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "%16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define WGMMA_SS_N64(TY, d, da, db, scale_d) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))

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

// d[64 x N] += A[64 x 16] B[16 x N]; A in registers (a[0..3], the
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

// d[64 x N] (+)= A B^T, both from shared memory (one k16 step)
template <typename T, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  if constexpr (N == 32) {
    if constexpr (f16) WGMMA_SS_N32("f16", d, da, db, scale_d);
    else WGMMA_SS_N32("bf16", d, da, db, scale_d);
  } else if constexpr (N == 64) {
    if constexpr (f16) WGMMA_SS_N64("f16", d, da, db, scale_d);
    else WGMMA_SS_N64("bf16", d, da, db, scale_d);
  } else {
    static_assert(N == 128, "wgmma width");
    if constexpr (f16) WGMMA_SS_N128("f16", d, da, db, scale_d);
    else WGMMA_SS_N128("bf16", d, da, db, scale_d);
  }
}

// d[64 x N] += A B, A from registers (one k16 step)
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a,
                                       uint64_t db) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  if constexpr (N == 32) {
    if constexpr (f16) WGMMA_RS_N32("f16", d, a, db);
    else WGMMA_RS_N32("bf16", d, a, db);
  } else if constexpr (N == 64) {
    if constexpr (f16) WGMMA_RS_N64("f16", d, a, db);
    else WGMMA_RS_N64("bf16", d, a, db);
  } else {
    static_assert(N == 128, "wgmma width");
    if constexpr (f16) WGMMA_RS_N128("f16", d, a, db);
    else WGMMA_RS_N128("bf16", d, a, db);
  }
}

// d (64 x N) = A B^T over D: A the 64 rows at a of an RA-row tile, B the N
// rows at b of an RB-row tile, both K-major; issued, not awaited.
template <typename T, int D, int N, int RA, int RB>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a,
                                         uint32_t b) {
  using GA = Geo<D, RA>;
  using GB = Geo<D, RB>;
#pragma unroll
  for (int kk = 0; kk < GA::kSteps; ++kk) {
    const int sl = kk / GA::kStepsPerSlab;
    const uint32_t col = (kk % GA::kStepsPerSlab) * 32;
    mma_ss<T, N>(d,
                 make_desc(a + sl * GA::kSlabBytes + col, 16,
                           8 * GA::kRowBytes, GA::kLayout),
                 make_desc(b + sl * GB::kSlabBytes + col, 16,
                           8 * GB::kRowBytes, GB::kLayout),
                 kk > 0);
  }
}

// d (64 x D) += A B: A (64 x K) in registers (a[4 kk ..] the k16 step kk),
// B the first K rows of the R-row tile at b, MN-major; issued, not awaited.
template <typename T, int D, int K, int R>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[K / 4],
                                         uint32_t b) {
  using G = Geo<D, R>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_rs<T, D>(d, &a[4 * kk],
                 make_desc(b + kk * 16 * G::kRowBytes, G::kSlabBytes,
                           8 * G::kRowBytes, G::kLayout));
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

// An fp32 accumulator (64 x N, the wgmma layout) rounded to T as the A
// operand of a product that reduces over its N columns.
template <typename T, int N>
__device__ __forceinline__ void pack_a(const float (&s)[N / 2],
                                       uint32_t (&a)[N / 4]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) a[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
}

// Rows [r0, r0 + R) of a head (zeros at rows >= n) written element by
// element into the swizzled layout TMA would give (a slab of kSlabCols
// columns after the other), by the producer's 128 threads.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile_elems(unsigned char* tile,
                                                const T* src, long long rs,
                                                int r0, int n, int t) {
  using G = Geo<D, R>;
  const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
  for (int e = t; e < R * D; e += 128) {
    const int r = e / D, c = e % D;
    const uint16_t v = r0 + r < n ? s16[(r0 + r) * rs + c] : uint16_t(0);
    uint32_t off = (c / G::kSlabCols) * G::kSlabBytes + r * G::kRowBytes +
                   (c % G::kSlabCols) * 2;
    off ^= (off >> 3) & G::kSwizzle;
    *reinterpret_cast<uint16_t*>(tile + off) = v;
  }
}

// -- host ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
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
// D 32) by box_rows rows, zeros past the end of a head. False where TMA
// cannot describe it.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, const Layout& L, int rows,
              int NH, int B, int dtype, int box_rows) {
  using G = Geo<D, 8>;
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
                       static_cast<cuuint32_t>(box_rows), 1, 1};
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

// Stores of 4-byte column pairs need a 4-byte aligned base and even strides.
inline bool pairs_ok(const void* ptr, const Layout& L) {
  return reinterpret_cast<uintptr_t>(ptr) % 4 == 0 && L.b % 2 == 0 &&
         L.h % 2 == 0 && L.r % 2 == 0;
}

inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace
}  // namespace flash
