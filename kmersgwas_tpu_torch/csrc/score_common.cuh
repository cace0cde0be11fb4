// Shared pieces of the association-score kernels. Every score kernel takes
// its tile height (TILE_ROWS), the top-3 layout (TM_R x TM_C) and the score
// epilogue (score_value / score_epilogue) from here; the tensor-core body
// of score_wgmma.cuh (K1 score_topw.cu, K3 score_tilemax.cu, K2 and K4
// score_plane.cu) sums on the tensor cores. The f32 FMA body below
// (load_packed_tile, add_word, score_tile, TILE_COLS) is K5's alone
// (score_rows.cu).
//
// The FMA body scores one tile of TILE_ROWS k-mers against one chunk of
// TILE_COLS phenotype columns per block:
//
//     yigi[row][c]  = sum of y[k][c] over the set bits k of the row's packed
//                     presence bits (f32, ascending k)
//     score[row][c] = (N*yigi - n1*ysum[c])^2 / (N*n1 - n1^2)
//                     0 when denom <= 0 or the MAC filter fails,
//                     -inf when popcnt == 0 (a padding row)
//
// which is kmersgwas_tpu/ops/score.py's fused epilogue (score.py:492-499);
// score_tile<false> leaves out the -inf of padding rows, as the row-major
// `_score_kernel` (score.py:630-644) does.
//
// Layout. `packed` is row-major (R, W32) uint32, one 4*W32-byte row per
// k-mer, exactly as the host feed delivers it (no device transpose). `y` is
// (N_pad, P_pad) f32 sample-major, with P_pad a multiple of TILE_COLS; the
// wrapper zero-pads it and, for precision "default", rounds it to bf16
// first, so one f32 body serves both precisions.
//
// Threads. 256 threads = 8 warps. Thread (tr = lane, tc = warp) owns rows
// tr + 32*i (i < TM_R) and columns 8*tc + j (j < TM_C). So one warp holds
// every row of the tile for its 8 columns (the per-tile reductions of
// score_topw stay inside a warp), 32 lanes read 32 consecutive rows (no bank
// conflicts with the padded row stride below), and the y values a warp
// reads for one sample are one broadcast address.
//
// Shared memory: the packed tile (TILE_ROWS x (W32+1) words, the +1 breaks
// bank conflicts) plus one K_CHUNK x TILE_COLS f32 stage of y. Full y^T for
// 101 columns at N=1008 is 413 KB in f32, past the 227 KB a block may use,
// so the sample axis is staged in chunks.
//
// Arithmetic. The sum is one fmaf(bit, y, acc) per (sample, row, column),
// with bit exactly 0.0 or 1.0, so acc + y is rounded once, as a plain
// f32 sum is. The epilogue uses the _rn intrinsics so that nvcc does not
// contract it into FMAs: it then rounds at exactly the places PyTorch's
// elementwise ops do, and scores agree bit for bit with the plain version
// wherever the sums are exact (dyadic phenotypes).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace kgt {

constexpr int TILE_ROWS = 128;
constexpr int TILE_COLS = 64;
constexpr int THREADS = 256;
constexpr int TM_R = 4;
constexpr int TM_C = 8;
constexpr int K_CHUNK_WORDS = 4;
constexpr int K_CHUNK = 32 * K_CHUNK_WORDS;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(TILE_ROWS == 32 * TM_R, "a warp holds every row of a tile");
static_assert(TILE_COLS == (THREADS / 32) * TM_C, "one warp per 8 columns");

inline size_t tile_smem_bytes(int w32) {
    return sizeof(float) * K_CHUNK * TILE_COLS
         + sizeof(uint32_t) * TILE_ROWS * (w32 + 1);
}

__device__ __forceinline__ float score_value(float yigi, float n1,
                                             float ysum, float n,
                                             float min_count) {
    const float r = __fsub_rn(__fmul_rn(n, yigi), __fmul_rn(n1, ysum));
    const float denom = __fsub_rn(__fmul_rn(n, n1), __fmul_rn(n1, n1));
    const float s = denom > 0.f ? __fdiv_rn(__fmul_rn(r, r), denom) : 0.f;
    const bool ok = (n1 >= min_count) && (__fsub_rn(n, n1) >= min_count);
    return ok ? s : 0.f;
}

__device__ __forceinline__ float score_epilogue(float yigi, float n1,
                                                float ysum, float n,
                                                float min_count) {
    return n1 > 0.f ? score_value(yigi, n1, ysum, n, min_count)
                    : -CUDART_INF_F;
}

// Copy the tile's packed rows (contiguous in device memory) into shared
// memory with a row stride of w32 + 1 words.
__device__ __forceinline__ void load_packed_tile(
        const uint32_t* __restrict__ packed, long long row0, int w32,
        uint32_t* pk_s) {
    const uint32_t* src = packed + row0 * w32;
    const int n = TILE_ROWS * w32;
    for (int idx = threadIdx.x; idx < n; idx += THREADS) {
        const int r = idx / w32;
        pk_s[r * (w32 + 1) + (idx - r * w32)] = src[idx];
    }
}

// Add y[k][c] for every set bit k of one packed word per row: the unpack of
// a k-mer's presence bits fused into the sum. wd[i] is the word of row
// tr + 32*i; yk points at the staged y of the word's first sample, at the
// thread's first column.
__device__ __forceinline__ void add_word(const uint32_t (&wd)[TM_R],
                                         const float4* yk,
                                         float (&acc)[TM_R][TM_C]) {
#pragma unroll
    for (int b = 0; b < 32; ++b) {
        const float4 ya = yk[b * (TILE_COLS / 4)];
        const float4 yb = yk[b * (TILE_COLS / 4) + 1];
#pragma unroll
        for (int i = 0; i < TM_R; ++i) {
            const float g = ((wd[i] >> b) & 1u) ? 1.f : 0.f;
            acc[i][0] = fmaf(g, ya.x, acc[i][0]);
            acc[i][1] = fmaf(g, ya.y, acc[i][1]);
            acc[i][2] = fmaf(g, ya.z, acc[i][2]);
            acc[i][3] = fmaf(g, ya.w, acc[i][3]);
            acc[i][4] = fmaf(g, yb.x, acc[i][4]);
            acc[i][5] = fmaf(g, yb.y, acc[i][5]);
            acc[i][6] = fmaf(g, yb.z, acc[i][6]);
            acc[i][7] = fmaf(g, yb.w, acc[i][7]);
        }
    }
}

// Scores of the block's tile: s[i][j] for row row0 + tr + 32*i and column
// c0 + 8*tc + j. Every thread of the block must call this. kPadInf: padding
// rows (popcnt == 0) score -inf; without it they score as any other row.
template <bool kPadInf = true>
__device__ __forceinline__ void score_tile(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const float* __restrict__ y, const float* __restrict__ ysum,
        long long row0, int c0, int w32, int p_pad, float n_used,
        float min_count, unsigned char* smem, float (&s)[TM_R][TM_C]) {
    float* ys_s = reinterpret_cast<float*>(smem);
    uint32_t* pk_s = reinterpret_cast<uint32_t*>(
        smem + sizeof(float) * K_CHUNK * TILE_COLS);
    const int tr = threadIdx.x & 31;
    const int tc = threadIdx.x >> 5;

    load_packed_tile(packed, row0, w32, pk_s);
    float acc[TM_R][TM_C];
#pragma unroll
    for (int i = 0; i < TM_R; ++i)
#pragma unroll
        for (int j = 0; j < TM_C; ++j) acc[i][j] = 0.f;

    for (int kw = 0; kw < w32; kw += K_CHUNK_WORDS) {
        __syncthreads();                    // previous stage fully consumed
        const float4* src = reinterpret_cast<const float4*>(
            y + (size_t)kw * 32 * p_pad + c0);
        float4* dst = reinterpret_cast<float4*>(ys_s);
        for (int idx = threadIdx.x; idx < K_CHUNK * TILE_COLS / 4;
             idx += THREADS) {
            const int k = idx / (TILE_COLS / 4);
            const int q = idx - k * (TILE_COLS / 4);
            dst[idx] = src[(size_t)k * (p_pad / 4) + q];
        }
        __syncthreads();                    // stage (and packed tile) ready
#pragma unroll 1
        for (int wi = 0; wi < K_CHUNK_WORDS; ++wi) {
            uint32_t wd[TM_R];
#pragma unroll
            for (int i = 0; i < TM_R; ++i)
                wd[i] = pk_s[(tr + 32 * i) * (w32 + 1) + kw + wi];
            add_word(wd, reinterpret_cast<const float4*>(ys_s)
                             + wi * 32 * (TILE_COLS / 4) + tc * 2, acc);
        }
    }

#pragma unroll
    for (int i = 0; i < TM_R; ++i) {
        const float n1 = popcnt[row0 + tr + 32 * i];
#pragma unroll
        for (int j = 0; j < TM_C; ++j)
            s[i][j] = kPadInf
                ? score_epilogue(acc[i][j], n1, ysum[c0 + tc * 8 + j],
                                 n_used, min_count)
                : score_value(acc[i][j], n1, ysum[c0 + tc * 8 + j], n_used,
                              min_count);
    }
}

}  // namespace kgt
