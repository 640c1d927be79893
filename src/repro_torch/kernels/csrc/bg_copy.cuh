// Asynchronous global -> shared memory copies (cp.async), shared by the
// kernels that stage their operands through shared memory: B1/B2
// (bg_fused.cu), B3 (bg_fused_streamed.cu), B4 (bg_create.cu) and B5
// (bg_blur.cu).
//
// A thread issues its copies, commits them as one group, and later waits
// until at most N of its groups are still in flight; a __syncthreads() after
// the wait makes every thread's copies visible to the block. A copy moves
// 16, 8 or 4 bytes, whatever the element type: a copy of fp32 frames moves
// 4, 2 or 1 pixels, one of bf16 frames 8, 4 or 2.
//
// Bulk copies (B4): one thread moves a whole 16-byte-aligned run of bytes
// with the copy engine (cp.async.bulk, Hopper's TMA), and the run's bytes
// complete a transaction count on an mbarrier in shared memory that the
// block waits on.
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

// an mbarrier at `bar` (8 bytes of shared memory) that one arrival completes
// a phase of; one thread initializes it, and a __syncthreads() after this
// makes it visible to the block and to the copy engine
__device__ __forceinline__ void mbar_init(void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the arrival of this phase, which also expects `bytes` more bytes of bulk
// copies before the phase completes
__device__ __forceinline__ void mbar_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `phase` of `bar` has completed
__device__ __forceinline__ void mbar_wait(void* bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, counted on `bar`; the fence orders the block's earlier reads of
// `dst` before the copy engine's writes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, void* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace bg
