// Asynchronous global -> shared memory copies (cp.async), shared by the
// kernels that stage their operands through shared memory: B1/B2
// (bg_fused.cu), B3 (bg_fused_streamed.cu) and B5 (bg_blur.cu).
//
// A thread issues its copies, commits them as one group, and later waits
// until at most N of its groups are still in flight; a __syncthreads() after
// the wait makes every thread's copies visible to the block. A copy moves
// 16, 8 or 4 bytes, whatever the element type: a copy of fp32 frames moves
// 4, 2 or 1 pixels, one of bf16 frames 8, 4 or 2.
#pragma once

#include <cuda_runtime.h>

namespace bg {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// 8 bytes; both addresses 8-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace bg
