// score_bmax: the scan step's exact-fallback kernel on Hopper (sm_90a).
//
// Replaces kmersgwas_tpu/ops/score.py `_score_t_bmax_kernel` (and its
// wrapper `score_batch_t_pallas_bmax`): the full (P, R) f32 score matrix of
// one batch plus the maxima of its 16-lane blocks, (P, R/16), which the
// exact top-k extraction (ops/topk.top_k_from_bmax) reads instead of
// re-reading the scores.
//
// Design. The block tile and its scoring are score_topw's
// (score_common.cuh). The TPU kernel folds STRIDED blocks (lane
// b + nb*j of a tile) because Mosaic cannot reshape along lanes; here a
// block is 16 CONSECUTIVE lanes, which are 16 consecutive lanes of one
// warp for a fixed (row group i, column j), so its maximum is four xor
// shuffles. Score stores are coalesced: 32 lanes write 32 consecutive rows
// of one column.
//
// What bounds it. The same ~R*N_pad*P_pad FMAs as score_topw, plus the
// score write: 101 x 2M x 4 B = 808 MB per flagship batch, 0.24 ms at the
// data sheet's 3.35 TB/s, small next to the arithmetic. It
// runs only on the fallback path of a batch, so it is kept simple.
#include "score_common.cuh"

namespace kgt {

__global__ void __launch_bounds__(THREADS) score_bmax_kernel(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const float* __restrict__ y, const float* __restrict__ ysum,
        long long n_rows, int w32, int p, int p_pad, float n_used,
        float min_count, float* __restrict__ scores,
        float* __restrict__ bmax) {
    extern __shared__ __align__(16) unsigned char smem[];
    const long long row0 = (long long)blockIdx.x * TILE_ROWS;
    const int c0 = blockIdx.y * TILE_COLS;
    const int tr = threadIdx.x & 31;
    const int tc = threadIdx.x >> 5;

    float s[TM_R][TM_C];
    score_tile(packed, popcnt, y, ysum, row0, c0, w32, p_pad, n_used,
               min_count, smem, s);

#pragma unroll
    for (int i = 0; i < TM_R; ++i) {
        const long long row = row0 + tr + 32 * i;
#pragma unroll
        for (int j = 0; j < TM_C; ++j) {
            const int c = c0 + tc * TM_C + j;
            float m = s[i][j];
            m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 8));
            m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 4));
            m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 2));
            m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 1));
            if (c < p) {
                scores[(size_t)c * n_rows + row] = s[i][j];
                if ((tr & 15) == 0)
                    bmax[(size_t)c * (n_rows / 16) + (row >> 4)] = m;
            }
        }
    }
}

}  // namespace kgt

extern "C" int kgt_score_bmax(
        const uint32_t* packed, const float* popcnt, const float* y,
        const float* ysum, long long n_rows, int w32, int p, int p_pad,
        float n_used, float min_count, float* scores, float* bmax,
        void* stream) {
    using namespace kgt;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = tile_smem_bytes(w32);
    cudaError_t e = cudaFuncSetAttribute(
        score_bmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    score_bmax_kernel<<<dim3((unsigned)(n_rows / TILE_ROWS),
                             p_pad / TILE_COLS), THREADS, smem, st>>>(
        packed, popcnt, y, ysum, n_rows, w32, p, p_pad, n_used, min_count,
        scores, bmax);
    return (int)cudaGetLastError();
}
