// score_parity: the two-list top-W epilogue of the step-budget probe on
// Hopper (sm_90a).
//
// Replaces tools/prof_r5_epi.py `_parity_kernel` (:419-491, called at
// :506): K1's GEMM and score epilogue over probe tiles of `tile_rows`
// lanes; per probe tile the top-3 and a count of lanes > thresh; the
// candidates of even probe tiles go to list A and those of odd tiles to
// list B; ok = no probe tile holds more than 3 lanes > thresh. The TPU
// kernel carries two replace-min lists across its grid steps, so which of
// several equal values a list keeps depends on the order of its inserts;
// here each list is the exact top-W of its tiles' candidates by (score
// desc, lane asc), lanes exact, as K1's is. The n2/n3 clauses of the TPU
// guard exist for its sum-encoded lanes and have no counterpart.
//
// Design: three launches.
//   A. K1's tile launch (score_topw.cuh, defined in score_topw.cu): per
//      128-row tile and column the exact top-3 and the hot count, on the
//      tensor cores (score_wgmma.cuh).
//   M. merge (only when tile_rows > 128): one thread per (column, probe
//      tile) inserts the tile_rows/128 sub-tiles' top-3s into the probe
//      tile's top-3 (the lowest lane wins ties: the top-3 of the union of
//      the sub-tiles' top-3s is the probe tile's) and sums their counts.
//   B. K1's select launch with two lists: block (column, L) selects list
//      L's top-W from the tiles t with t % 2 == L.
//
// What bounds it. Launch A, as K1: the (R, N) x (N, P) score product on
// the tensor cores (4.3e11 FLOP at the flagship batch). M reads 24 B
// per (column, 128-row tile) and B reads the merged candidates of its
// column, both L2-sized at the flagship batch.
#include <climits>

#include "score_topw.cuh"

namespace kgt {

__global__ void __launch_bounds__(THREADS) parity_merge_kernel(
        const float* __restrict__ tile_v, const int* __restrict__ tile_g,
        const int* __restrict__ tile_cnt, int p, int n_tiles, int m,
        float* __restrict__ mrg_v, int* __restrict__ mrg_g,
        int* __restrict__ mrg_cnt) {
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int n_probe = n_tiles / m;
    if (idx >= (long long)p * n_probe) return;
    const int c = (int)(idx / n_probe);
    const int t = (int)(idx % n_probe);
    Top3 top = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                INT_MAX, INT_MAX, INT_MAX};
    int cnt = 0;
    const size_t col = (size_t)c * 3 * n_tiles;
    for (int s = t * m; s < (t + 1) * m; ++s) {
        for (int j = 0; j < 3; ++j)
            top3_insert(top, tile_v[col + 3 * s + j],
                        tile_g[col + 3 * s + j]);
        cnt += tile_cnt[(size_t)c * n_tiles + s];
    }
    const size_t o = (size_t)c * 3 * n_probe + 3 * t;
    mrg_v[o] = top.v0;
    mrg_v[o + 1] = top.v1;
    mrg_v[o + 2] = top.v2;
    mrg_g[o] = top.i0;
    mrg_g[o + 1] = top.i1;
    mrg_g[o + 2] = top.i2;
    mrg_cnt[(size_t)c * n_probe + t] = cnt;
}

}  // namespace kgt

// b, ysum, thresh: as launch_topw_tiles takes them (score_topw.cuh);
// tile_*: (p, 3*R/128) and (p, R/128) scratch of launch A; mrg_*: (p,
// 3*R/tile_rows) and (p, R/tile_rows) scratch of the merge (unused when
// tile_rows == 128); out_v/out_g: (2, p, w) lists A and B; out_ok: (p,);
// fallbacks as K1's select takes it (score_topw.cuh).
extern "C" int kgt_score_parity(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, const float* thresh, long long n_rows, int w32,
        int p, int nc, int n_cc, int planes, float n_used, float min_count,
        int tile_rows, int w, float* tile_v, int* tile_g, int* tile_cnt,
        float* mrg_v, int* mrg_g, int* mrg_cnt, float* out_v, int* out_g,
        int* out_ok, unsigned* fallbacks, void* stream) {
    using namespace kgt;
    if (tile_rows <= 0 || tile_rows % TILE_ROWS || n_rows % tile_rows)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_topw_tiles(
        packed, popcnt, b, ysum, thresh, n_rows, w32, p, nc, n_cc, planes,
        n_used, min_count, tile_v, tile_g, tile_cnt, st);
    if (e != cudaSuccess) return (int)e;
    const int n_tiles = (int)(n_rows / TILE_ROWS);
    const int m = tile_rows / TILE_ROWS;
    const int n_probe = n_tiles / m;
    if (m > 1) {
        const long long threads = (long long)p * n_probe;
        parity_merge_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS),
                              THREADS, 0, st>>>(
            tile_v, tile_g, tile_cnt, p, n_tiles, m, mrg_v, mrg_g, mrg_cnt);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    } else {
        mrg_v = tile_v;
        mrg_g = tile_g;
        mrg_cnt = tile_cnt;
    }
    return (int)launch_topw_select(mrg_v, mrg_g, mrg_cnt, n_probe, p, 2, w,
                                   out_v, out_g, out_ok, fallbacks, st);
}
