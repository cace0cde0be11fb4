// score_t: transposed association scores on Hopper (sm_90a).
//
// Replaces kmersgwas_tpu/ops/score.py `_score_t_kernel` (and its wrapper
// `score_batch_t_pallas`), the kernel behind the plain scan step
// (`scan_step(kernel="pallas")`): the full (P, R) f32 score matrix of one
// batch, with -inf for padding rows (popcnt == 0).
//
// Design. score_bmax's kernel without the block maxima: the shared tile
// body (score_common.cuh: one fmaf(bit, y, acc) per set sample in
// ascending order, the _rn epilogue), so its scores equal K1-K3's and the
// plain version's bit for bit wherever the sums are exact. Stores are
// coalesced: 32 lanes write 32 consecutive rows of one column.
//
// What bounds it. The ~R*N_pad*P_pad FMAs of the tile body on CUDA cores
// (2M x 1024 x 128 = 275 G per flagship batch), as for K1-K3, plus the
// score write, 101 x 2M x 4 B = 808 MB, 0.24 ms at 3.35 TB/s.
#include "score_common.cuh"

namespace kgt {

__global__ void __launch_bounds__(THREADS) score_t_kernel(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const float* __restrict__ y, const float* __restrict__ ysum,
        long long n_rows, int w32, int p, int p_pad, float n_used,
        float min_count, float* __restrict__ scores) {
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
            if (c < p) scores[(size_t)c * n_rows + row] = s[i][j];
        }
    }
}

}  // namespace kgt

extern "C" int kgt_score_t(
        const uint32_t* packed, const float* popcnt, const float* y,
        const float* ysum, long long n_rows, int w32, int p, int p_pad,
        float n_used, float min_count, float* scores, void* stream) {
    using namespace kgt;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = tile_smem_bytes(w32);
    cudaError_t e = cudaFuncSetAttribute(
        score_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    score_t_kernel<<<dim3((unsigned)(n_rows / TILE_ROWS), p_pad / TILE_COLS),
                     THREADS, smem, st>>>(
        packed, popcnt, y, ysum, n_rows, w32, p, p_pad, n_used, min_count,
        scores);
    return (int)cudaGetLastError();
}
