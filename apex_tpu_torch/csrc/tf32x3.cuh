// The 3xTF32 tensor-core pieces that the fp32 flash kernels share:
// csrc/flash_fwd_f32.cu (the forward) and csrc/flash_bwd_f32.cu (the
// backward's dK/dV and dQ kernels). A block is 4 warps owning 64 resident
// rows (16 a warp); the other side's rows stream through shared memory in
// tiles with rows padded to D + 4 floats, so that every fragment load
// below is free of bank conflicts.
//
// Products run on mma.sync.m16n8k8 with TF32 operands and fp32
// accumulators. Each fp32 operand a is split as it is loaded into a
// fragment into hi = a rounded to TF32 and lo = a - hi, and a product is
// lo hi + hi lo + hi hi, summed in that order into the fp32 accumulator:
// within about 2^-20 of |a| |b| per product (1xTF32 would be 2^-11).
// Score tiles live in the m16n8 accumulator layout of
// csrc/flash_bwd_rows.cuh.
#pragma once

#include <stdint.h>

#include "cp_async.cuh"

namespace flash {
namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // resident rows a block
constexpr int kThreadsF = 32 * kWarps;

// Rows [r0, r0 + R) of a head (row stride rs) into an (R x (D + 4)) tile,
// zeros at rows >= n.
template <int D, int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* head,
                                           long long rs, int r0, int n,
                                           bool vec) {
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < R * C4; e += kThreadsF) {
    const int r = e / C4, c = 4 * (e % C4);
    float* d = dst + r * (D + 4) + c;
    if (r0 + r < n) {
      const float* s = head + (r0 + r) * rs + c;
      if (vec) {
        cp_async16(d, s);
      } else {
        d[0] = s[0];
        d[1] = s[1];
        d[2] = s[2];
        d[3] = s[3];
      }
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// a = hi + lo: hi = a rounded to TF32 (ties away), lo = a - hi (exact in
// fp32), which the tensor core reads cut to TF32: it ignores an operand's
// low 13 bits (the products of lo and of lo masked agree bit for bit on the
// H100), so lo needs no mask. hi cut instead of rounded saves an
// instruction (~8% of the kernels' time) for 1.6x the error, too close to
// the 1e-4 checks at S 1000.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small terms, then the large one
__device__ __forceinline__ void mma3(float* d, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The A fragment (16 rows x 8 of the reduction) at column c0 of a tile
// with rows of ld floats: a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g +
// 8, q + 4) for lane = 4 g + q.
__device__ __forceinline__ void frag_a(const float* t, int ld, int c0,
                                       int lane, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = t + (lane / 4) * ld + c0 + lane % 4;
  split(p[0], hi[0], lo[0]);
  split(p[8 * ld], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * ld + 4], hi[3], lo[3]);
}

// The A fragment of columns 8 kk .. of a score tile in registers (element
// 4 j + e, csrc/flash_bwd_rows.cuh): reduction column q <- accumulator
// column 2 q, q + 4 <- 2 q + 1.
__device__ __forceinline__ void frag_a_regs(const float* s, int kk,
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split(s[4 * kk], hi[0], lo[0]);
  split(s[4 * kk + 2], hi[1], lo[1]);
  split(s[4 * kk + 1], hi[2], lo[2]);
  split(s[4 * kk + 3], hi[3], lo[3]);
}

// B fragment (8 of the reduction x 8 columns) of a product whose
// reduction runs along D: row n0 + g of a tile, columns c0 + q, c0 + q + 4.
__device__ __forceinline__ void frag_b_d(const float* t, int ld, int n0,
                                         int c0, int lane, uint32_t (&hi)[2],
                                         uint32_t (&lo)[2]) {
  const float* p = t + (n0 + lane / 4) * ld + c0 + lane % 4;
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// B fragment of a product whose reduction runs along the tile's rows, in
// frag_a_regs's order: rows r0 + 2 q and r0 + 2 q + 1, column c0 + g.
__device__ __forceinline__ void frag_b_rows(const float* t, int ld, int r0,
                                            int c0, int lane,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const float* p = t + (r0 + 2 * (lane % 4)) * ld + c0 + lane / 4;
  split(p[0], hi[0], lo[0]);
  split(p[ld], hi[1], lo[1]);
}

// An fp32 accumulator (16 x D: rows ra, ra + 8, columns 8 j + 2 q + {0, 1})
// into a head by its row stride, rows >= n skipped.
template <int D>
__device__ __forceinline__ void store_acc(float* head, long long rs,
                                          const float* o, int ra, int n,
                                          int quad) {
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    const int r = ra + 8 * hb;
    if (r >= n) continue;
    float* row = head + r * rs + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      row[8 * j] = o[4 * j + 2 * hb];
      row[8 * j + 1] = o[4 * j + 2 * hb + 1];
    }
  }
}

}  // namespace
}  // namespace flash
