// Hopper (sm_90a) building blocks the port's kernels share: mbarriers, bulk copies
// into shared memory, the shared-memory matrix descriptor of a wgmma B operand,
// ldmatrix, the register-A m64n64k16 bf16 wgmma and the wgmma fences, 16-byte shared
// loads and streaming global stores, and a named barrier over part of a CTA. Included
// by the kernel sources; ops/_build.py hashes it into every library's build key.
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

// Four 8 x 8 b16 matrices from shared memory; lane l gives the row address of
// matrix l / 8. With rows 0-15 at k 0 (lanes 0-15) and at k 8 (lanes 16-31) it
// returns a warp's m16n8k16 A fragment, the register-A form of wgmma.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// D (64 x 64, f32, registers) += A (64 x 16 bf16, registers: this warp's m16n8k16 A
// fragment) * B (16 x 64 bf16, shared memory, descriptor).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
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

// 16 bytes from shared memory at `addr`.
__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
    return v;
}

// 16 bytes to global memory with the streaming hint (.cs: evict first), so that
// an output written once does not push lines the kernel will read again out of L2.
__device__ __forceinline__ void st_global_cs16(void* p, uint4 v) {
    asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads, a multiple of 32.
__device__ __forceinline__ void bar_sync_count(int id, int count) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

}  // namespace
