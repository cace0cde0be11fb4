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
// Layout. `packed` is the dtable's own row-major (R, W32) uint32, one
// 4*W32-byte row per k-mer, as the host feed delivers it: no host or device
// transpose. Rows n_rows..R-1 contribute NOTHING: an all-zero row is not
// neutral under +-1 (it adds +1 to every pair), so the fixed-size staging
// buffer's tail is masked to 0 bytes in the unpack.
//
// Design. The Gram is symmetric: one block owns an output tile pair
// (I, J) with I <= J, KT x KT samples, over one contiguous split of the
// rows, and adds its partial to acc[I][J] and, off the diagonal, to
// acc[J][I] with int32 atomics (integer addition in any order: the result
// is bit-equal to a full product). The row splits exist because the tile
// pairs alone (36 at n_pad 1024) cannot fill 132 SMs. Per chunk of KC rows
// the block
//   1. stages the chunk's packed words of samples I and J (one 16-byte
//      load per row and tile: KT = 128 samples are 4 words),
//   2. unpacks them to +-1 int8 in shared memory, transposed to
//      [sample][row] so that the row axis is the GEMM's contiguous K axis,
//      four rows per 32-bit word: 0x01 for a set bit, 0xFF for a clear one,
//      0x00 for a row past n_rows,
//   3. runs warp-level mma.sync.m16n8k32.s8.s8.s32 (exact integer tensor
//      core products) over the chunk: 8 warps, each a 64 x 32 output tile.
//
// What bounds it. One 2^20-row batch at n_pad 1024 is 2^40 multiply-adds
// (2.2 T int8 ops, 1.1 ms at the data sheet's 1,979 TOPS dense); the upper
// triangle is 36 of 64 tiles, 0.62 T. The packed input is only 128 MB. This
// first kernel is bound by the unpack in step 2 (about 20 instructions per
// 4 output bytes, on CUDA cores) and by mma.sync's share of the tensor
// cores (wgmma and TMA are later work), not by memory.
//
// Shared memory row stride: SW = KC/4 + 4 words per sample (36 = 4 mod
// 32), so the fragment loads (lanes g*SW + t) and the unpack stores (lanes
// s*SW + q, 8 samples x 4 quads per warp) both hit 32 distinct banks.
#include <cstdint>
#include <cuda_runtime.h>

namespace kgt {

constexpr int KT = 128;              // output tile side, samples
constexpr int KC = 128;              // rows per chunk (the GEMM's K chunk)
constexpr int KQ = KC / 4;           // 32-bit words (4 rows) per sample
constexpr int SW = KQ + 4;           // padded smem words per sample
constexpr int PW = KT / 32 + 1;      // padded staged words per row
constexpr int KTHREADS = 256;        // 8 warps: 2 (i) x 4 (j)
constexpr int TARGET_BLOCKS = 1024;  // row splits x tile pairs, about

static_assert(KTHREADS == 2 * KC, "one staging load per thread and tile");

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(KTHREADS) kinship_gram_kernel(
        const uint32_t* __restrict__ packed, long long n_rows, int w32,
        int n_tiles, long long rows_per_split, int* __restrict__ acc) {
    __shared__ uint32_t pw[2][KC * PW];          // staged packed words
    __shared__ uint32_t sab[2][KT * SW];         // +-1 bytes, [sample][row]

    // tile pair (bi <= bj) of this block
    int bi = 0, rem = blockIdx.x;
    while (rem >= n_tiles - bi) {
        rem -= n_tiles - bi;
        ++bi;
    }
    const int bj = bi + rem;
    const bool diag = bi == bj;
    const long long r_begin = (long long)blockIdx.y * rows_per_split;
    const long long r_end = min(n_rows, r_begin + rows_per_split);
    if (r_begin >= r_end) return;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;      // 64 x 32 warp tile
    const uint32_t* sa = sab[0];
    const uint32_t* sb = diag ? sab[0] : sab[1];

    int c[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0;

    const int n_mats = diag ? 1 : 2;
    for (long long r0 = r_begin; r0 < r_end; r0 += KC) {
        const int nvalid = (int)min((long long)KC, r_end - r0);
        __syncthreads();                 // previous chunk fully consumed
        {   // 1. stage: thread -> (tile, row); 16 bytes per row and tile
            const int which = tid / KC, rr = tid % KC;
            if (which < n_mats) {
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (rr < nvalid) {
                    const int col = (which ? bj : bi) * (KT / 32);
                    v = *reinterpret_cast<const uint4*>(
                        packed + (r0 + rr) * w32 + col);
                }
                uint32_t* d = &pw[which][rr * PW];
                d[0] = v.x;
                d[1] = v.y;
                d[2] = v.z;
                d[3] = v.w;
            }
        }
        __syncthreads();
        // 2. unpack: a warp step covers 8 samples x 4 quads of rows
        for (int it = warp; it < n_mats * (KT / 8) * (KQ / 4); it += 8) {
            const int which = it / ((KT / 8) * (KQ / 4));
            const int sub = it % ((KT / 8) * (KQ / 4));
            const int s = (sub / (KQ / 4)) * 8 + (lane >> 2);
            const int q = (sub % (KQ / 4)) * 4 + (lane & 3);
            const uint32_t* src = &pw[which][4 * q * PW + (s >> 5)];
            const int sh = s & 31;
            const uint32_t x = ((src[0] >> sh) & 1u)
                             | (((src[PW] >> sh) & 1u) << 8)
                             | (((src[2 * PW] >> sh) & 1u) << 16)
                             | (((src[3 * PW] >> sh) & 1u) << 24);
            // bytes: 1 -> 0x01, 0 -> 0xFF (no carries: 0xFE per byte)
            uint32_t v = 0x01010101u | ((x ^ 0x01010101u) * 0xFEu);
            const int left = nvalid - 4 * q;      // rows of this quad kept
            v = left >= 4 ? v : left <= 0 ? 0u
                : v & (0xFFFFFFFFu >> (8 * (4 - left)));
            sab[which][s * SW + q] = v;
        }
        __syncthreads();
        // 3. mma over the chunk: 4 k-steps of 32 rows (8 words)
#pragma unroll
        for (int ks = 0; ks < KQ / 8; ++ks) {
            unsigned a[4][4], b[4][2];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const uint32_t* p = sa + (wm * 64 + mt * 16 + g) * SW
                                  + ks * 8 + t;
                a[mt][0] = p[0];
                a[mt][1] = p[8 * SW];
                a[mt][2] = p[4];
                a[mt][3] = p[8 * SW + 4];
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const uint32_t* p = sb + (wn * 32 + nt * 8 + g) * SW
                                  + ks * 8 + t;
                b[nt][0] = p[0];
                b[nt][1] = p[4];
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    mma_s8(c[mt][nt], a[mt][0], a[mt][1], a[mt][2],
                           a[mt][3], b[nt][0], b[nt][1]);
        }
    }

    // epilogue: c[mt][nt][e] is (i, j) = (row g (+8 for e >= 2), col
    // 2t + (e & 1)) of the m16n8 tile
    const int n_pad = w32 * 32;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int v = c[mt][nt][e];
                if (v == 0) continue;
                const int i = bi * KT + wm * 64 + mt * 16 + g + (e >> 1) * 8;
                const int j = bj * KT + wn * 32 + nt * 8 + 2 * t + (e & 1);
                atomicAdd(acc + (size_t)i * n_pad + j, v);
                if (!diag) atomicAdd(acc + (size_t)j * n_pad + i, v);
            }
}

}  // namespace kgt

// acc (n_pad, n_pad) int32 += A^T A over rows [0, n_rows) of packed
// (R, w32); w32 must be a multiple of 4 and packed 16-byte aligned.
extern "C" int kgt_kinship_gram(const uint32_t* packed, long long n_rows,
                                int w32, int* acc, void* stream) {
    using namespace kgt;
    if (n_rows <= 0) return 0;
    const int n_tiles = w32 * 32 / KT;
    const int n_pairs = n_tiles * (n_tiles + 1) / 2;
    const long long chunks = (n_rows + KC - 1) / KC;
    long long splits = (TARGET_BLOCKS + n_pairs - 1) / n_pairs;
    if (splits > chunks) splits = chunks;
    if (splits > 65535) splits = 65535;
    const long long rows_per_split = ((chunks + splits - 1) / splits) * KC;
    splits = (n_rows + rows_per_split - 1) / rows_per_split;
    kinship_gram_kernel<<<dim3((unsigned)n_pairs, (unsigned)splits),
                          KTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, n_rows, w32, n_tiles, rows_per_split, acc);
    return (int)cudaGetLastError();
}
