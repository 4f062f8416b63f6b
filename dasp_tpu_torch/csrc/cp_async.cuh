// Asynchronous copies from device memory into shared memory (cp.async),
// shared by resident.cu (K6's phase A) and colsum_multi.cu (K5): both stage
// the next work item's idx tile, values and wins row while the block
// computes the current one.  A thread issues its copies, commits them as
// one group, and later waits until at most N of its groups are pending;
// a __syncthreads() then makes every thread's copies visible to the block.
// Source and destination must be aligned to the copy's size.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
// an L2 evict-first policy (data read once), for cp_async16_hint
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void cp_async16_hint(void* dst, const void* src,
                                                uint64_t policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s),
      "l"(src), "l"(policy));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
