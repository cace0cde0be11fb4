// score_rows: row-major association scores on Hopper (sm_90a).
//
// Replaces kmersgwas_tpu/ops/score.py `_score_kernel` (and its wrapper
// `score_batch_pallas`): the (R, P) f32 scores of one batch, 0 where the
// MAC filter fails and NO padding mask (a popcnt == 0 row scores 0, as
// the pure-XLA `score_batch` gives).
//
// Design. The shared tile body (score_common.cuh) with score_tile<false>,
// so the sums and the epilogue round as the other kernels' and as the
// plain version's. A thread holds 8 consecutive columns of each of its
// rows, so its 8 stores fill one 32-byte run of a row: the L2 merges them
// before the write-back, though one warp store touches 32 rows.
//
// What bounds it. The tile body's ~R*N_pad*P_pad FMAs on CUDA cores, as
// for K1-K4; the (R, P) write is the same 808 MB per flagship batch as
// score_t's, in a less friendly pattern.
#include "score_common.cuh"

namespace kgt {

__global__ void __launch_bounds__(THREADS) score_rows_kernel(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const float* __restrict__ y, const float* __restrict__ ysum,
        int w32, int p, int p_pad, float n_used, float min_count,
        float* __restrict__ scores) {
    extern __shared__ __align__(16) unsigned char smem[];
    const long long row0 = (long long)blockIdx.x * TILE_ROWS;
    const int c0 = blockIdx.y * TILE_COLS;
    const int tr = threadIdx.x & 31;
    const int tc = threadIdx.x >> 5;

    float s[TM_R][TM_C];
    score_tile<false>(packed, popcnt, y, ysum, row0, c0, w32, p_pad, n_used,
                      min_count, smem, s);

#pragma unroll
    for (int i = 0; i < TM_R; ++i) {
        float* out = scores + (size_t)(row0 + tr + 32 * i) * p;
#pragma unroll
        for (int j = 0; j < TM_C; ++j) {
            const int c = c0 + tc * TM_C + j;
            if (c < p) out[c] = s[i][j];
        }
    }
}

}  // namespace kgt

extern "C" int kgt_score_rows(
        const uint32_t* packed, const float* popcnt, const float* y,
        const float* ysum, long long n_rows, int w32, int p, int p_pad,
        float n_used, float min_count, float* scores, void* stream) {
    using namespace kgt;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = tile_smem_bytes(w32);
    cudaError_t e = cudaFuncSetAttribute(
        score_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    score_rows_kernel<<<dim3((unsigned)(n_rows / TILE_ROWS),
                             p_pad / TILE_COLS), THREADS, smem, st>>>(
        packed, popcnt, y, ysum, w32, p, p_pad, n_used, min_count, scores);
    return (int)cudaGetLastError();
}
