// gen_planes: random packed bit-planes and their popcounts on Hopper
// (sm_90a).
//
// Replaces the on-device plane generator of the bench and of the at-scale
// stream: bench.py `_gen_kernel` / `gen` (:320-351) and
// tools/at_scale_stream.py `_gen_kernel` / `gen` (:64-87). Those draw the
// TPU's hardware random bits, which no other device reproduces; this kernel
// draws Philox4x32-10 (Random123's counter-based generator) instead, so a
// batch is a pure function of (seed, step, row, word) and a resumed stream
// regenerates it byte for byte.
//
// Function. Word j of row r of batch `step` is component j % 4 of
//   Philox4x32-10(counter = (r, j / 4, step_lo32, step_hi32),
//                 key     = (seed_lo32, seed_hi32)),
// for r < rows and j < w32 (w32 % 4 == 0), written as (rows, w32) int32
// rows: the layout the port's score kernels read (the TPU generator wrote
// transposed (w32, rows) planes only to skip a TPU relayout). pc[r] is the
// f32 count of set bits over all w32 words of row r, padding lanes
// included, as the TPU generator's fused popcount. Given a null pc the
// kernel writes the planes only, as the probes' generators without a fused
// popcount do (tools/prof_r3.py:71, prof_r4.py:40, prof_window.py:30,
// prof_window2.py:29).
//
// Design. One thread per (row, Philox block of 4 words); a row's blocks go
// to a group of G = min(32, next power of 2 >= w32 / 4) consecutive lanes
// (G = 8 at w32 = 32: a warp writes 4 whole 128-byte rows with 16-byte
// stores, coalesced). The group's popcounts meet by __shfl_xor_sync and
// lane 0 of the group writes pc[r]. Philox's high words come from __umulhi.
//
// What bounds it. The bytes written: 2^21 rows x 128 B of planes plus
// 2^21 x 4 B of popcounts, 277 MB per 2M-row batch, 0.083 ms at 3.35 TB/s.
// The 10 rounds are ~4 integer multiplies per 16 output bytes, far below
// the card's integer rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace kgt {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kGenThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
        const uint32_t lo0 = kPhiloxM0 * c.x;
        const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
        const uint32_t lo1 = kPhiloxM1 * c.z;
        c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
        k0 += kPhiloxW0;
        k1 += kPhiloxW1;
    }
    return c;
}

__global__ void __launch_bounds__(kGenThreads) gen_planes_kernel(
        uint4* __restrict__ planes, float* __restrict__ pc, long long rows,
        int nb, int group, uint32_t k0, uint32_t k1, uint32_t s0,
        uint32_t s1) {
    const long long t = (long long)blockIdx.x * kGenThreads + threadIdx.x;
    const long long r = t / group;
    const int g = (int)(t % group);
    int cnt = 0;
    if (r < rows) {
        for (int b = g; b < nb; b += group) {
            const uint4 v = philox4x32_10(
                make_uint4((uint32_t)r, (uint32_t)b, s0, s1), k0, k1);
            planes[r * nb + b] = v;
            cnt += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        }
    }
    if (pc == nullptr) return;      // planes only (uniform over the grid)
    // every lane of the warp is here (no early exit), and a group never
    // straddles a warp: group divides 32
    for (int off = group >> 1; off > 0; off >>= 1)
        cnt += __shfl_xor_sync(0xffffffffu, cnt, off, group);
    if (r < rows && g == 0) pc[r] = (float)cnt;
}

}  // namespace kgt

extern "C" int kgt_gen_planes(void* planes, float* pc, long long rows,
                              int w32, unsigned long long seed,
                              unsigned long long step, void* stream) {
    using namespace kgt;
    if (rows <= 0 || w32 <= 0 || w32 % 4) return (int)cudaErrorInvalidValue;
    const int nb = w32 / 4;
    int group = 1;
    while (group < nb && group < 32) group <<= 1;
    const long long threads = rows * group;
    const long long blocks = (threads + kGenThreads - 1) / kGenThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    gen_planes_kernel<<<(unsigned)blocks, kGenThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint4*>(planes), pc, rows, nb, group,
        (uint32_t)seed, (uint32_t)(seed >> 32), (uint32_t)step,
        (uint32_t)(step >> 32));
    return (int)cudaGetLastError();
}
