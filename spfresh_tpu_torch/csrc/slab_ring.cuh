// What the slab-major kernels share: the work-item size of the schedule
// (spf_rerank_schedule in rerank.cu) and the mbarrier / bulk-copy
// primitives of their shared-memory rings.  Included by rerank.cu and
// rerank_int8mxu.cu, each inside its own anonymous namespace.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

// Most (query, probe) pairs per work item of the schedule.
constexpr int kGroup = 16;
static_assert(kGroup >= 1 && kGroup < 32, "an item's pairs run in passes of 16, 8, 4, 2, 1");

// A block's dynamic shared memory on sm_90: the 227 KB opt-in less 1 KB for
// the kernels' static barriers and item metadata.
constexpr int kMaxSmem = 232448 - 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the phase of parity `parity` has completed.  A wait that
// outlasts ~10 s of SM clock (a copy that never lands) traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) into shared memory, counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
