// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared by
// nn_topk.cu and ball_query.cu. A copy lands in shared memory without passing
// through registers; the issuing thread waits for its own copies with
// wait_all(), and a barrier after that makes every thread's copies visible to
// the block.

#pragma once

#include <cuda_runtime.h>

namespace cp_async {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes; any 4-byte aligned addresses
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// 16 bytes; both addresses 16-byte aligned
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy this thread started has landed
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace cp_async
