// score_topw: the scan step's per-batch kernel on Hopper (sm_90a).
//
// Replaces kmersgwas_tpu/ops/score.py `_score_t_topw_kernel` (and its
// wrapper `score_batch_t_pallas_topw`): score one batch of k-mers against
// every phenotype column and return, per column, the exact top-W
// (score, batch lane) list plus a guard `ok` that is conservative: ok[c]
// true means no row tile holds more than 3 lanes scoring > thresh[c], so
// every such lane is among the 3*n_tiles candidates the list is cut from
// (the caller adds the check that the W-th value is <= thresh[c]).
//
// Design. The TPU kernel carries one replace-min list serially across its
// grid steps; blocks on this card run in parallel and in no order, so the
// work is split in two launches (score_topw.cuh, shared with
// score_parity.cu):
//   A. score_topw_tiles: per (128-row tile, column) the exact top-3
//      (score, lane), lowest lane first on ties, and the count of lanes
//      scoring > thresh (tile_top3.cuh, shared with score_tilemax.cu).
//   B. topw_select: per column the exact top-W of the 3*n_tiles candidates
//      by (score desc, lane asc), radix select and bitonic sort, and the
//      AND of the tile guards; padded with (-inf, 0) below W candidates.
// Lanes are exact, so the TPU kernel's sum-encoded 2nd/3rd lanes and their
// n2/n3 ambiguity guards have no counterpart here.
//
// What bounds it. Launch A is ~R*N_pad*P_pad f32 FMAs (2.1M x 1024 x 128
// at the flagship batch): CUDA-core arithmetic, with packed bits read once
// (128 B per k-mer) and nothing but 24 B per (column, tile) written. Each
// sample costs one broadcast shared-memory load per 4 columns, one bit
// test per row and 32 FMAs per thread. Tensor cores (mma/wgmma on 0/1
// operands) are the next step and are not used yet. Launch B reads the
// 3*n_tiles candidates of its column nine times (L2-resident).
#include "score_topw.cuh"

extern "C" int kgt_score_topw(
        const uint32_t* packed, const float* popcnt, const float* y,
        const float* ysum, const float* thresh, long long n_rows, int w32,
        int p, int p_pad, float n_used, float min_count, int cand_w,
        int sort_cap, float* tile_v, int* tile_g, int* tile_cnt,
        float* out_v, int* out_g, int* out_ok, void* stream) {
    using namespace kgt;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = launch_topw_tiles(
        packed, popcnt, y, ysum, thresh, n_rows, w32, p, p_pad, n_used,
        min_count, tile_v, tile_g, tile_cnt, st);
    if (e != cudaSuccess) return (int)e;
    const int n_tiles = (int)(n_rows / TILE_ROWS);
    topw_select_kernel<<<p, THREADS, sizeof(unsigned long long) * sort_cap,
                         st>>>(
        tile_v, tile_g, tile_cnt, n_tiles, cand_w, sort_cap, out_v, out_g,
        out_ok);
    return (int)cudaGetLastError();
}

extern "C" const char* kgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
