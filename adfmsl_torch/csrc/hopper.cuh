// Hopper (sm_90a) building blocks the port's kernels share: mbarriers, bulk copies
// into shared memory, the shared-memory matrix descriptor of a wgmma B operand and
// the wgmma fences. Included by the kernel sources; ops/_build.py hashes it into every
// library's build key.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// Global -> shared bulk copy of `bytes` (a multiple of 16), completing on `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// B descriptor of an operand at shared address `addr` in the no-swizzle K-major
// core-matrix layout: 8 rows (n) x 16 bytes (k) a core matrix, LBO 128 B (the next
// core matrix along k), SBO `sbo` bytes (the next 8 n).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t sbo) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
           (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

}  // namespace
