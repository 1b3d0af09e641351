// A TMA bulk copy (cp.async.bulk) of a span of device memory into shared
// memory, completed on an mbarrier: how K2 stages a tile's q rows and K5a
// a tile's own rows.  One thread issues the copy; after the block's
// __syncthreads (which makes the barrier's initialisation visible) every
// thread that reads the span waits for it.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Issued by one thread: copy `bytes` (a multiple of 16) from the 16-byte
// aligned `src` to the 16-byte aligned shared `dst`, completing on the
// mbarrier `bar` (phase 0).
__device__ __forceinline__ void bulk_copy_to_shared(void* dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the copy completing on `bar` has landed.
__device__ __forceinline__ void bulk_copy_wait(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
}
