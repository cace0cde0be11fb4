// Frozen copy of kmersgwas_tpu_torch/csrc/gen_planes.cu at commit 6d84111 (the
// port's K6), kept as the benchmark's traffic generator: a later change to
// the port's kernel does not change the benchmark's rows. Built by
// benchmark/gen/__init__.py into benchmark/build/; its plain twin is
// benchmark.gen.gen_planes_plain. Its one change is of names: the kernels
// live in namespace benchgen and the C entry point is bench_gen_planes, so
// a profile tells them from the port's kgt:: kernels.
//
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
// Design. The rows go in chunks of 32 to the warps of a grid of a few
// blocks on each SM; warp w takes chunks w, w + W, w + 2W, ... (W warps in
// the grid). In a chunk of nb = w32 / 4 Philox blocks a row, lane l makes
// the items q = l + 32 k (k < nb) of the chunk's 32 * nb (row, block)
// items, item q being block q % nb of the chunk's row q / nb: every store
// instruction of a warp writes 512 consecutive bytes (16 a lane), and a
// chunk's 32 row counts leave as one 128-byte line of pc. The chunk's
// first row is 64-bit (rows may reach 2^32); offsets inside it are 32-bit.
// - w32 = 32 (nb = 8; the bench, the at-scale stream and every probe) is
//   its own kernel: the 8 items of a lane are unrolled, 8 independent
//   Philox blocks in flight, and item k of lane l is row 4k + l / 8, block
//   l % 8, so no thread divides anything. The row counts meet by a
//   reduce-scatter of the lanes' 8 block counts over the 8 lanes of a row
//   group (3 shuffle stages of 4, 2 and 1 values), then one shuffle puts
//   row i's count in lane i.
// - Other widths take the generic kernel: (row, block) of a lane's item
//   advances by (32 / nb, 32 % nb) with one carry, and the row counts meet
//   in 32 ints of shared memory a warp (shared atomics).
// - popcount=false is a template instance without the counts.
// The round keys are kernel parameters plus constants, the same for every
// thread, so the compiler may keep them in uniform registers. Stores are
// streaming (st.global.cs): the 277 MB of a batch pass L2 in any case.
//
// What bounds it. The bytes written: 2^21 rows x 128 B of planes plus
// 2^21 x 4 B of popcounts, 277 MB per 2M-row batch, 0.083 ms at 3.35 TB/s.
// The integer work is not far below that: a Philox block is 10 rounds of
// two 32 x 32 -> 64-bit multiplies (IMAD.WIDE.U32, or IMAD.HI + IMAD) and
// two 3-input xors (LOP3), and 4 POPCs count it, 2^24 blocks a batch.
// chip_smoke.py (phase 1) reckons the floor from this kernel's SASS
// (cuobjdump): ~76 instructions a block, IMAD-class 27, LOP3 20.5, POPC
// 4, so 0.038 ms at 4 warp instructions a clock on 132 SMs at 1980 MHz,
// above each pipe's own floor; the bytes set the bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace benchgen {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kGenThreads = 256;
constexpr int kGenWarps = kGenThreads / 32;
constexpr unsigned kGenFull = 0xffffffffu;

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

__device__ __forceinline__ int popc4(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// w32 = 32: 8 Philox blocks a row, 4 rows a store instruction.
template <bool POPCOUNT>
__global__ void __launch_bounds__(kGenThreads) gen_planes_w32_kernel(
        uint4* __restrict__ planes, float* __restrict__ pc, long long rows,
        uint32_t k0, uint32_t k1, uint32_t s0, uint32_t s1) {
    constexpr int NB = 8;
    const int lane = threadIdx.x & 31;
    const long long chunks = (rows + 31) >> 5;
    const long long n_warps = (long long)gridDim.x * kGenWarps;
    // one chunk a trip (not unrolled): its 8 blocks are the ILP, and the
    // SASS of one trip is what chip_smoke.py counts per 8 blocks
#pragma unroll 1
    for (long long c = (long long)blockIdx.x * kGenWarps + (threadIdx.x >> 5);
         c < chunks; c += n_warps) {
        const long long r0 = c << 5;
        uint4* __restrict__ out = planes + r0 * NB;
        const uint32_t n_in = (uint32_t)min(32LL, rows - r0);
        int cnt[NB];
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            const uint32_t rr = 4 * k + (lane >> 3);      // row in the chunk
            const uint4 v = philox4x32_10(
                make_uint4((uint32_t)r0 + rr, lane & 7, s0, s1), k0, k1);
            if (rr < n_in) __stcs(out + 32 * k + lane, v);
            if (POPCOUNT) cnt[k] = popc4(v);
        }
        if (POPCOUNT) {
            // reduce-scatter over lane bits 0-2 (the 8 lanes of a row
            // group): stage s keeps the half of the counts whose index bit
            // (2 - s) equals lane bit s and adds the partner's copy of it
            const bool h0 = lane & 1, h1 = lane & 2, h2 = lane & 4;
#pragma unroll
            for (int m = 0; m < 4; ++m)
                cnt[m] = (h0 ? cnt[m + 4] : cnt[m]) + __shfl_xor_sync(
                    kGenFull, h0 ? cnt[m] : cnt[m + 4], 1);
#pragma unroll
            for (int m = 0; m < 2; ++m)
                cnt[m] = (h1 ? cnt[m + 2] : cnt[m]) + __shfl_xor_sync(
                    kGenFull, h1 ? cnt[m] : cnt[m + 2], 2);
            cnt[0] = (h2 ? cnt[1] : cnt[0])
                   + __shfl_xor_sync(kGenFull, h2 ? cnt[0] : cnt[1], 4);
            // lane 8 g + b (b = 4 b2 + 2 b1 + b0) now holds row
            // 4 (b2 + 2 b1 + 4 b0) + g; lane i takes row i
            const int k = lane >> 2;
            const int src = 8 * (lane & 3) + ((k & 1) << 2) + (k & 2)
                          + ((k >> 2) & 1);
            const int mine = __shfl_sync(kGenFull, cnt[0], src);
            if ((uint32_t)lane < n_in) pc[r0 + lane] = (float)mine;
        }
    }
}

// Any w32 (nb = w32 / 4 blocks a row).
template <bool POPCOUNT>
__global__ void __launch_bounds__(kGenThreads) gen_planes_any_kernel(
        uint4* __restrict__ planes, float* __restrict__ pc, long long rows,
        int nb, uint32_t k0, uint32_t k1, uint32_t s0, uint32_t s1) {
    __shared__ int row_cnt[kGenWarps][32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    // item q = lane + 32 k is (row q / nb, block q % nb); q += 32 moves
    // (row, block) by (step_r, step_b), carrying once past nb
    const int step_r = 32 / nb, step_b = 32 % nb;
    const int rr0 = lane / nb, bb0 = lane % nb;
    const long long chunks = (rows + 31) >> 5;
    const long long n_warps = (long long)gridDim.x * kGenWarps;
#pragma unroll 1
    for (long long c = (long long)blockIdx.x * kGenWarps + warp; c < chunks;
         c += n_warps) {
        const long long r0 = c << 5;
        uint4* __restrict__ out = planes + r0 * nb;
        const uint32_t n_in = (uint32_t)min(32LL, rows - r0);
        if (POPCOUNT) {
            row_cnt[warp][lane] = 0;
            __syncwarp();
        }
        uint32_t rr = rr0, bb = bb0;
        for (int k = 0; k < nb; ++k) {
            const uint4 v = philox4x32_10(
                make_uint4((uint32_t)r0 + rr, bb, s0, s1), k0, k1);
            if (rr < n_in) {
                __stcs(out + 32 * k + lane, v);
                if (POPCOUNT) atomicAdd(&row_cnt[warp][rr], popc4(v));
            }
            rr += step_r;
            bb += step_b;
            if (bb >= (uint32_t)nb) {
                bb -= nb;
                ++rr;
            }
        }
        if (POPCOUNT) {
            __syncwarp();
            if ((uint32_t)lane < n_in)
                pc[r0 + lane] = (float)row_cnt[warp][lane];
            __syncwarp();               // read before the next chunk's zero
        }
    }
}

// Launch on a grid of a few blocks on each SM, no more than the chunks
// need.
template <auto Kernel, typename... Args>
void launch_gen(long long rows, cudaStream_t st, Args... args) {
    static int per_sm = 0, sms = 0;     // per instance; benign race
    if (per_sm == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      kGenThreads, 0);
        if (per_sm < 1) per_sm = 1;
    }
    const long long need = ((rows + 31) / 32 + kGenWarps - 1) / kGenWarps;
    const long long cap = (long long)sms * per_sm;
    const unsigned grid = (unsigned)(need < cap ? need : cap);
    Kernel<<<grid, kGenThreads, 0, st>>>(args...);
}

}  // namespace benchgen

extern "C" int bench_gen_planes(void* planes, float* pc, long long rows,
                              int w32, unsigned long long seed,
                              unsigned long long step, void* stream) {
    using namespace benchgen;
    if (rows <= 0 || rows > (1LL << 32) || w32 <= 0 || w32 % 4)
        return (int)cudaErrorInvalidValue;
    const int nb = w32 / 4;
    const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
    const uint32_t s0 = (uint32_t)step, s1 = (uint32_t)(step >> 32);
    uint4* out = static_cast<uint4*>(planes);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (nb == 8 && pc != nullptr)
        launch_gen<gen_planes_w32_kernel<true>>(rows, st, out, pc, rows, k0,
                                                k1, s0, s1);
    else if (nb == 8)
        launch_gen<gen_planes_w32_kernel<false>>(rows, st, out, pc, rows, k0,
                                                 k1, s0, s1);
    else if (pc != nullptr)
        launch_gen<gen_planes_any_kernel<true>>(rows, st, out, pc, rows, nb,
                                                k0, k1, s0, s1);
    else
        launch_gen<gen_planes_any_kernel<false>>(rows, st, out, pc, rows, nb,
                                                 k0, k1, s0, s1);
    return (int)cudaGetLastError();
}
