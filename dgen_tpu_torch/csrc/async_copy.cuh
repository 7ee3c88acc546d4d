// cp.async copies from device memory to shared memory, shared by the
// stream kernel (bucket_sums_stream.cu), the one-hot dot kernel
// (bucket_sums_dot.cu) and the battery dispatch kernel
// (battery_dispatch.cu).
//
// A thread issues copies, commits them as a group and later waits until
// all but its newest N groups have landed; each thread waits for its own
// copies only, so a block that reads another thread's copies adds a
// barrier after the wait.

#pragma once

#include <cuda_runtime.h>

namespace async_copy {

// Copies BYTES (4, 8 or 16) from src to dst, both aligned to BYTES; the
// 16-byte form bypasses L1.
template <int BYTES>
__device__ __forceinline__ void copy(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace async_copy
