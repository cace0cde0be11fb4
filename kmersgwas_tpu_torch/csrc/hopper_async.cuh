// Hopper's asynchronous building blocks shared by the port's tensor-core
// kernels (sm_90a): warpgroup product groups (`wgmma` fence, commit, wait),
// the no-swizzle K-major shared-memory descriptor, mbarriers and bulk
// copies from global to shared memory. Used by score_wgmma.cuh (K1-K5, K8)
// and kinship_gram.cu (K7).
#pragma once

#include <cstdint>

namespace kgt {

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers at this point of the instruction stream: the values are
// defined before, and read after, the (volatile) statements around it.
template <int K>
__device__ __forceinline__ void pin(uint32_t (&r)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int K>
__device__ __forceinline__ void pin(uint64_t (&r)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) asm volatile("" : "+l"(r[i])::"memory");
}

template <int K>
__device__ __forceinline__ void pin(float (&r)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// No-swizzle K-major descriptor of the core matrices (8 rows of N x 16
// bytes of K, 128 contiguous bytes each) at shared address `saddr`: LBO 128
// bytes (the next 16 bytes of K), SBO 1024 bytes (the next 8 rows of N).
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
    return (uint64_t)((saddr >> 4) & 0x3FFFu)
         | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32);
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

}  // namespace kgt
