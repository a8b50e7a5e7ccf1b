// Bulk copies of the Tensor Memory Accelerator (TMA) and the shared-memory
// barriers that count their bytes, for Hopper (sm_90a), in inline PTX:
// what the envelope probe's P1 (envelope.cu) streams with, and the proxy
// fence that P2's `wgmma` operands need (wgmma.cuh).
//
// One thread asks for a contiguous run of bytes (a multiple of 16, both
// addresses 16-byte aligned) to be copied between device memory and
// shared memory; the hardware moves it with no registers or instructions
// of the threads.  A load reports its bytes to an `mbarrier` in shared
// memory: the thread that issues it first tells the barrier how many bytes
// to expect (arrive.expect_tx), and the barrier's phase completes when
// they have landed.  Waiters poll the phase's parity.  A store is tracked
// by bulk groups instead: commit_group closes a group, and
// wait_group.read N returns once at most N groups still read shared
// memory (their source may then be overwritten).
//
// Shared memory written by the threads (the generic proxy) and read by a
// bulk store or by `wgmma` (the async proxy) needs fence_proxy_async()
// by each writing thread, then a barrier, before the read is issued.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One thread initialises; fence, then a CTA barrier, before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives once and expects `bytes` more of transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrives once, with no bytes to wait for.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// device memory -> shared memory, completion counted on `bar`.  A CTA
// launched without a cluster is a cluster of one, so its shared::cta
// addresses are its shared::cluster addresses.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared memory -> device memory, in the current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// At most N groups still read their shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// Every group complete, its writes done.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace tma
}  // namespace
