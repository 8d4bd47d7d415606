// The cp.async copies (global to shared memory, asynchronous, sm_80+)
// that csrc/dequant_gemm.cu, csrc/flash_bwd_f32.cu, csrc/paged_read.cu and
// csrc/layer_norm_fwd.cu stage their tiles with.
#pragma once

#include <stdint.h>

namespace {

// 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// 4 bytes, or zeros when !in (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
