// The shared-memory mbarrier operations of the pipelined kernels
// (conv_ws.cuh's TMA ring, the cp.async rings of conv_sync.cuh and
// dense_f64.cuh): init, arrive, a thread's arrival when its copies land,
// a warp's release of a ring stage, and the wait for a phase.
#pragma once

#include <stdint.h>

namespace xgpr {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b))
               : "memory");
}
// The cp.async copies this thread issued so far arrive on `full` when
// they land (no pending count added: the barrier counts one arrival per
// thread and fill).
__device__ __forceinline__ void arrive_on_copies(uint64_t* full) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(saddr(full))
               : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WS_WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WS_WAIT_%=;\n"
      "}\n" ::"r"(saddr(b)),
      "r"(parity)
      : "memory");
}
// Releases a ring stage: one arrival per warp, after its reads of the
// stage are complete.
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty);
}

}  // namespace xgpr
