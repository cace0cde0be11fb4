// kinship_gram: the exact k-mer kinship Gram on Hopper (sm_90a).
//
// Replaces tools/prof_kinship.py `_kin_kernel` (the fused Pallas form of
// kmersgwas_tpu/ops/kinship.py `kinship_accumulate`): for the first n_rows
// rows of a batch of packed presence bits, encode every bit as a = 2g - 1
// in {-1, +1} and add the Gram A^T A, (n_pad, n_pad) int32, into `acc` in
// place. (A^T A)[i][j] = #match - #mismatch of samples i and j over the
// rows, so the XNOR count of the reference (src/emma_kinship_kmers.cpp) is
// (n_rows + A^T A) / 2; the int8 x int8 -> int32 products are exact.
//
// Two kernels, launched one after the other on the caller's stream.
//
// 1. kinship_transpose_kernel reads the dtable's row-major (R, W32) packed
//    words once and writes the bits sample-major, `bits` (n_chunks, n_pad,
//    KW) uint32: word q of sample s in chunk c holds, at bit b, the bit of
//    row c*KC + 32q + b. One chunk of one 128-sample tile is then one
//    contiguous 2 KB block, one bulk copy. Rows n_rows.. are written as 0.
//    A block stages 8 words (a 32-byte sector) of each of a chunk's rows
//    in shared memory, 16 bytes a thread; each of its 8 warps then
//    transposes one word column, 32 x 32 bit blocks with 5 shuffle-and-
//    mask stages.
//
// 2. kinship_gram_kernel multiplies on the tensor cores with
//    wgmma.mma_async m64n128k32 .s32.s8.s8. For 8-bit types wgmma takes
//    K-major operands only, and K is the k-mer rows: each operand is
//    [sample][row] bytes, which is the transposed bits' order.
//    - B (the J tile, 128 samples x 128 rows of a chunk) is expanded from
//      its 2 KB of bits into shared memory by all 256 threads, in the
//      no-swizzle core-matrix layout (8 samples x 16 rows, 128 bytes each;
//      descriptor LBO 128 bytes, SBO 1024), double-buffered, and read by
//      both warpgroups.
//    - A (the I tile) never exists as bytes outside registers: each thread
//      builds its fragments (rows t/4 and t/4 + 8 of its warp's 16, rows
//      4(t%4).. and 16 + 4(t%4).. of each k32 step) from the same staged
//      bits. A diagonal pair uses one tile for both.
//    - Expansion: a nibble of bits -> four 0/1 bytes by
//      (nibble * 0x00204081) & 0x01010101, then +-1 by ~(v * 0xFE): 4
//      instructions per 4 bytes, against ~20 for the gather the first
//      kernel ran per tile pair.
//    - Rows past n_rows: an all-zero bit row is not neutral under +-1 (it
//      adds +1 to every pair). A's bytes of those rows are masked to 0x00
//      in the last chunk, so their products are 0 whatever B holds.
//    - Persistent schedule: the (tile pair, chunk) work items, pair-major,
//      are cut into gridDim.x contiguous spans of equal length (two blocks
//      an SM). A block keeps its 128 x 128 accumulator (64 int32 a thread)
//      across its span and adds it to acc with int32 atomics only when it
//      leaves a pair, to acc[I][J] and, off the diagonal, to acc[J][I]
//      (integer addition in any order: bit-equal to a full product).
//    - The ring: thread 0 keeps STAGES chunks of bits in flight with bulk
//      copies under mbarriers; a stage is refilled once the block barrier
//      of the chunk that read it has passed. Per chunk a warpgroup issues
//      its four k32 products as one group and waits for it; the other
//      warpgroup and the SM's other block overlap it.
//
// What bounds it. One 2^20-row batch at n_pad 1024 is 2^40 multiply-adds
// for the full Gram; the function needs the N (N + 1) / 2 entries on and
// above the diagonal (0.539 ms at 1,979 TOP/s int8 for N = 1008), and the
// 36 upper-triangle tile pairs compute 36 of 64 tiles (0.63 ms). The
// transpose moves 128 MB in and 128 MB out (0.08 ms at 3.35 TB/s). So the
// Gram is bound by operations; what stands between it and the rate is the
// expansion's instructions beside the products.
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_async.cuh"

namespace kgt {

constexpr int KT = 128;                  // tile side, samples
constexpr int KC = 128;                  // rows per chunk
constexpr int KW = KC / 32;              // bit words of a sample per chunk
constexpr int KTHREADS = 256;            // two consumer warpgroups
constexpr int STAGES = 8;                // ring depth, chunks of bits
constexpr int BITS_BYTES = KT * KW * 4;  // one tile's chunk of bits (2 KB)
constexpr int STAGE_BYTES = 2 * BITS_BYTES;
constexpr int B_BYTES = KT * KC;         // one expanded tile chunk, int8
constexpr int BLOCKS_PER_SM = 2;
constexpr size_t GRAM_SMEM = (size_t)STAGES * STAGE_BYTES + 2 * B_BYTES
                           + STAGES * sizeof(uint64_t);

static_assert(KW == 4, "a sample's chunk of bits is one uint4");

// One stage of the warp's 32 x 32 bit transpose: lanes i and i ^ k swap
// the k x k blocks off the diagonal (m: the bits j with j & k == 0).
__device__ __forceinline__ uint32_t swap_blocks(uint32_t x, int lane, int k,
                                                uint32_t m) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, x, k);
    return (lane & k) ? (x & ~m) | ((o & ~m) >> k)
                      : (x & m) | ((o & m) << k);
}

// On return lane j holds, at bit i, bit j of lane i's word.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
    x = swap_blocks(x, lane, 16, 0x0000FFFFu);
    x = swap_blocks(x, lane, 8, 0x00FF00FFu);
    x = swap_blocks(x, lane, 4, 0x0F0F0F0Fu);
    x = swap_blocks(x, lane, 2, 0x33333333u);
    return swap_blocks(x, lane, 1, 0x55555555u);
}

// grid (n_chunks, ceil(w32 / 8)), 256 threads: block (c, y) transposes
// word columns 8y.. 8y + 7 (256 samples; 4 at the edge when w32 % 8 = 4)
// of chunk c's KC rows. Thread i loads 16 bytes of row i / 2 (the rows'
// 32-byte sectors whole) into shared memory (pitch 9 words: the column
// reads below hit 32 banks); warp w then transposes word column 8y + w,
// 32 rows at a time.
__global__ void __launch_bounds__(256) kinship_transpose_kernel(
        const uint32_t* __restrict__ packed, long long n_rows, int w32,
        uint4* __restrict__ bits) {
    __shared__ uint32_t st[KC * 9];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long c = blockIdx.x;
    {
        const int rr = threadIdx.x >> 1, h = threadIdx.x & 1;
        const long long r = c * KC + rr;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_rows && blockIdx.y * 8 + 4 * h < w32)
            v = __ldg(reinterpret_cast<const uint4*>(
                packed + r * w32 + blockIdx.y * 8) + h);
        uint32_t* d = st + rr * 9 + 4 * h;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
    }
    __syncthreads();
    if (blockIdx.y * 8 + w >= w32) return;        // the whole warp leaves
    uint32_t y[KW];
#pragma unroll
    for (int q = 0; q < KW; ++q)
        y[q] = transpose32(st[(q * 32 + lane) * 9 + w], lane);
    bits[c * (w32 * 32) + (blockIdx.y * 8 + w) * 32 + lane] =
        make_uint4(y[0], y[1], y[2], y[3]);
}

// bits 0-3 of x -> four bytes, 0x01 for a set bit and 0x00 for a clear one
__device__ __forceinline__ uint32_t nib01(uint32_t x) {
    return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// bits 0-3 of x -> four +-1 int8 (0x01 set, 0xFF clear)
__device__ __forceinline__ uint32_t nib_pm1(uint32_t x) {
    return ~(nib01(x) * 0xFEu);
}

// wgmma.mma_async m64n128k32, s32 += s8 x s8, A from registers, B K-major
// from shared memory; d[4j + e] is row t/4 (+8 for e >= 2), column
// 8j + 2(t%4) + (e & 1) of the warp's 16 x 128.
#define KIN_D4(j) "+r"(d[4 * (j)]), "+r"(d[4 * (j) + 1]), \
                  "+r"(d[4 * (j) + 2]), "+r"(d[4 * (j) + 3])
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : KIN_D4(0), KIN_D4(1), KIN_D4(2), KIN_D4(3), KIN_D4(4), KIN_D4(5),
          KIN_D4(6), KIN_D4(7), KIN_D4(8), KIN_D4(9), KIN_D4(10),
          KIN_D4(11), KIN_D4(12), KIN_D4(13), KIN_D4(14), KIN_D4(15)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
}
#undef KIN_D4

// Position in the pair-major list of (tile pair, chunk) work items; pairs
// are (bi, bj), bi <= bj, row by row.
struct Cursor {
    long long chunk;
    int bi, bj;

    __device__ Cursor(long long item, long long n_chunks, int n_tiles) {
        long long pair = item / n_chunks;
        chunk = item - pair * n_chunks;
        bi = 0;
        while (pair >= n_tiles - bi) {
            pair -= n_tiles - bi;
            ++bi;
        }
        bj = bi + (int)pair;
    }

    __device__ void advance(long long n_chunks, int n_tiles) {
        if (++chunk < n_chunks) return;
        chunk = 0;
        if (++bj == n_tiles) bj = ++bi;
    }
};

__global__ void __launch_bounds__(KTHREADS, BLOCKS_PER_SM)
kinship_gram_kernel(const uint4* __restrict__ bits, long long n_rows,
                    int n_pad, long long n_items, int* __restrict__ acc) {
    extern __shared__ __align__(128) unsigned char kin_smem[];
    unsigned char* ring = kin_smem;
    unsigned char* bexp = kin_smem + STAGES * STAGE_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(bexp + 2 * B_BYTES);
    const long long it0 = n_items * blockIdx.x / gridDim.x;
    const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;
    if (it0 >= it1) return;                       // the whole block leaves
    const int n_it = (int)(it1 - it0);
    const int n_tiles = n_pad / KT;
    const long long n_chunks = (n_rows + KC - 1) / KC;

    Cursor pc(it0, n_chunks, n_tiles);            // the loads (thread 0)
    auto load = [&](int s) {
        const bool diag = pc.bi == pc.bj;
        const uint32_t bytes = diag ? BITS_BYTES : STAGE_BYTES;
        unsigned char* dst = ring + (size_t)s * STAGE_BYTES;
        const uint4* src = bits + pc.chunk * n_pad;
        mbar_arrive_tx(&full[s], bytes);
        bulk_load(dst, src + pc.bi * KT, BITS_BYTES, &full[s]);
        if (!diag) bulk_load(dst + BITS_BYTES, src + pc.bj * KT, BITS_BYTES,
                             &full[s]);
        pc.advance(n_chunks, n_tiles);
    };
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < STAGES && s < n_it; ++s) load(s);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int ra = (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows ra, ra + 8
    const int sb = threadIdx.x & (KT - 1);        // B: sample sb,
    const int hb = threadIdx.x >> 7;              // words 2hb and 2hb + 1
    Cursor cc(it0, n_chunks, n_tiles);
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    bool fresh = true;                            // d holds no pair yet
    for (int k = 0; k < n_it; ++k) {
        const int s = k % STAGES;
        mbar_wait(&full[s], (uint32_t)((k / STAGES) & 1));
        const uint4* ib = reinterpret_cast<const uint4*>(
            ring + (size_t)s * STAGE_BYTES);
        const bool diag = cc.bi == cc.bj;
        const uint2* jb = reinterpret_cast<const uint2*>(
            diag ? ib : ib + KT);
        const uint4 wa = ib[ra], wb = ib[ra + 8];
        const uint2 wj = jb[2 * sb + hb];
        // B: word q = 2hb + e of sample sb holds rows 32q.. of the chunk:
        // core matrices (sb / 8, k16 = 2q) and (sb / 8, 2q + 1), row sb % 8
        unsigned char* bb = bexp + (k & 1) * B_BYTES;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const uint32_t x = e ? wj.y : wj.x;
            const int k16 = 2 * (2 * hb + e);
            unsigned char* row = bb + ((sb >> 3) * (KC / 16) + k16) * 128
                               + (sb & 7) * 16;
            *reinterpret_cast<uint4*>(row) = make_uint4(
                nib_pm1(x), nib_pm1(x >> 4), nib_pm1(x >> 8),
                nib_pm1(x >> 12));
            *reinterpret_cast<uint4*>(row + 128) = make_uint4(
                nib_pm1(x >> 16), nib_pm1(x >> 20), nib_pm1(x >> 24),
                nib_pm1(x >> 28));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();                 // B complete; stage s fully read
        if (threadIdx.x == 0 && k + STAGES < n_it) load(s);
        __syncwarp();                    // wgmma needs the warp converged

        // A: k32 step ks is word ks; bytes 4t.. of the step are nibble t,
        // bytes 16 + 4t.. nibble t + 4
        const int sh = 4 * t;
        uint32_t a[KW][4];
        uint64_t desc[KW];
        const uint32_t xa[KW] = {wa.x, wa.y, wa.z, wa.w};
        const uint32_t xb[KW] = {wb.x, wb.y, wb.z, wb.w};
        const long long left = n_rows - cc.chunk * KC;   // rows of the chunk
#pragma unroll
        for (int ks = 0; ks < KW; ++ks) {
            a[ks][0] = nib_pm1(xa[ks] >> sh);
            a[ks][1] = nib_pm1(xb[ks] >> sh);
            a[ks][2] = nib_pm1(xa[ks] >> (sh + 16));
            a[ks][3] = nib_pm1(xb[ks] >> (sh + 16));
            if (left < KC) {             // the last chunk: rows >= n_rows
                const long long v = left - 32 * ks;      // -> 0x00
                const uint32_t vm = v >= 32 ? 0xFFFFFFFFu
                                  : v <= 0 ? 0u : (1u << (int)v) - 1u;
                const uint32_t m0 = nib01(vm >> sh) * 0xFFu;
                const uint32_t m1 = nib01(vm >> (sh + 16)) * 0xFFu;
                a[ks][0] &= m0;
                a[ks][1] &= m0;
                a[ks][2] &= m1;
                a[ks][3] &= m1;
            }
            pin(a[ks]);
            desc[ks] = b_desc(smem_u32(bb) + ks * 256);
        }
        pin(desc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < KW; ++ks)
            wgmma_s8(d, a[ks], desc[ks], (fresh && ks == 0) ? 0u : 1u);
        wg_commit();
        wg_wait<0>();
        fresh = false;

        if (k + 1 == n_it || cc.chunk + 1 == n_chunks) {   // leaving the pair
            const int i0 = cc.bi * KT + ra;
            const int j0 = cc.bj * KT + 2 * t;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int v = d[4 * j + e];
                    if (v == 0) continue;
                    const int i = i0 + (e >> 1) * 8;
                    const int jj = j0 + 8 * j + (e & 1);
                    atomicAdd(acc + (size_t)i * n_pad + jj, v);
                    if (!diag) atomicAdd(acc + (size_t)jj * n_pad + i, v);
                }
            fresh = true;
        }
        cc.advance(n_chunks, n_tiles);
    }
}

}  // namespace kgt

// bits (ceil(n_rows / 128), w32 * 32, 4) uint32 <- the bits of rows
// [0, n_rows) of packed (R, w32), sample-major; rows past n_rows as 0.
extern "C" int kgt_kinship_transpose(const uint32_t* packed, long long n_rows,
                                     int w32, uint32_t* bits, void* stream) {
    using namespace kgt;
    if (n_rows <= 0) return 0;
    const long long n_chunks = (n_rows + KC - 1) / KC;
    if (n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kinship_transpose_kernel<<<dim3((unsigned)n_chunks, (w32 + 7) / 8), 256,
                               0, static_cast<cudaStream_t>(stream)>>>(
        packed, n_rows, w32, reinterpret_cast<uint4*>(bits));
    return (int)cudaGetLastError();
}

// acc (n_pad, n_pad) int32 += A^T A over rows [0, n_rows), from the
// transposed bits of kgt_kinship_transpose; n_pad = 32 * w32, a multiple
// of 128; bits 16-byte aligned.
extern "C" int kgt_kinship_gram(const uint32_t* bits, long long n_rows,
                                int w32, int* acc, void* stream) {
    using namespace kgt;
    if (n_rows <= 0) return 0;
    const int n_pad = w32 * 32;
    if (n_pad % KT) return (int)cudaErrorInvalidValue;
    const int n_tiles = n_pad / KT;
    const long long n_chunks = (n_rows + KC - 1) / KC;
    const long long n_items = (long long)n_tiles * (n_tiles + 1) / 2
                            * n_chunks;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kinship_gram_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)GRAM_SMEM);
    if (e != cudaSuccess) return (int)e;
    long long grid = (long long)BLOCKS_PER_SM * sms;
    if (grid > n_items) grid = n_items;
    kinship_gram_kernel<<<(unsigned)grid, KTHREADS, GRAM_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint4*>(bits), n_rows, n_pad, n_items, acc);
    return (int)cudaGetLastError();
}
