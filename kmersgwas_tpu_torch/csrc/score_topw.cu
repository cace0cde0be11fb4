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
//      by (score desc, lane asc) and the AND of the tile guards; padded
//      with (-inf, 0) below W candidates. One 1024-thread block a column
//      reads the scores, bounds the W-th score by the W-th largest of
//      its threads' top-2 and sorts only the candidates at or above it
//      (score_topw.cuh has the paths).
// Lanes are exact, so the TPU kernel's sum-encoded 2nd/3rd lanes and their
// n2/n3 ambiguity guards have no counterpart here.
//
// What bounds it. Launch A is the (R, N) x (N, P) score product, 4.3e11
// FLOP at the flagship batch (2.1M x 1008 x 101): 0.43 ms at the bf16
// tensor-core peak, against 0.08 ms to read the packed bits (128 B per
// k-mer). It runs on the tensor cores (score_wgmma.cuh): the bits become
// A fragments in registers, y streams through shared memory as bf16 (three
// planes at "highest"), and the columns are padded to 8, not 64 (104 at
// P = 101), in chunks of at most 128 at two blocks an SM. What holds it
// above the bound is the body more than the per-tile epilogue: on an H100
// the launch takes ~1.67 ms at the flagship batch and K4's kernel, the
// same body storing the score plane in place of the top-3, ~1.35 ms
// (~0.96 against ~0.69 at N=100, whose k loop is 8x shorter; chip_smoke.py
// phase 2 times both). The scores go through shared memory and every
// column's top-3 is three rounds of two warp reductions (tile_top3.cuh),
// per 128-row tile. The epilogue does not overlap the next tile's products
// within a block; the SM's second block covers part of it. Launch B's
// bound is the scores and tile counts read once and the winners' lanes,
// 25 MB at the flagship batch (7.6 us at 3.35 TB/s); it reads the scores
// once (a few warps twice), the counts once and the lanes of the few
// hundred candidates it sorts.
#include "score_topw.cuh"
#include "score_wgmma.cuh"

namespace kgt {

template <int N8>
__global__ void __launch_bounds__(WG_THREADS, 2)
score_topw_tiles_kernel(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const unsigned char* __restrict__ b, const float* __restrict__ ysum,
        const float* __restrict__ thresh, int w32, int p, int planes,
        float n_used, float min_count, int stages, uint32_t stage_bytes,
        size_t ring_bytes, float* __restrict__ tile_v,
        int* __restrict__ tile_g, int* __restrict__ tile_cnt) {
    extern __shared__ __align__(128) unsigned char smem[];
    const long long tile = blockIdx.x;
    const long long n_tiles = gridDim.x;
    const long long row0 = tile * TILE_ROWS;
    const int c0 = blockIdx.y * 8 * N8;
    const size_t chunk_bytes = (size_t)(w32 * 32 / KC) * stage_bytes;
    if (!wgmma_score_tile<N8>(packed, popcnt, b + blockIdx.y * chunk_bytes,
                              ysum + c0, row0, w32, planes, n_used,
                              min_count, stages, stage_bytes, ring_bytes,
                              smem))
        return;
    const float* st = reinterpret_cast<const float*>(smem);
    const int tr = threadIdx.x & 31;
    for (int g = threadIdx.x >> 5; g < N8 && c0 + 8 * g < p;
         g += WG_CONSUMERS / 32) {
        float s[TM_R][TM_C];
        load_column_group(st, g, tr, s);
#pragma unroll
        for (int j = 0; j < TM_C; ++j) {
            const int c = c0 + 8 * g + j;
            const float th = thresh[c];
            const Top3 t = column_top3(s, j, tr);
            const int cnt = column_count(s, j,
                                         [th](float v) { return v > th; });
            if (tr == 0 && c < p) {
                const size_t base = (size_t)c * 3 * n_tiles + 3 * tile;
                tile_v[base] = t.v0;
                tile_v[base + 1] = t.v1;
                tile_v[base + 2] = t.v2;
                tile_g[base] = (int)(row0 + t.i0);
                tile_g[base + 1] = (int)(row0 + t.i1);
                tile_g[base + 2] = (int)(row0 + t.i2);
                tile_cnt[(size_t)c * n_tiles + tile] = cnt;
            }
        }
    }
}

cudaError_t launch_topw_tiles(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, const float* thresh, long long n_rows, int w32,
        int p, int nc, int n_cc, int planes, float n_used, float min_count,
        float* tile_v, int* tile_g, int* tile_cnt, cudaStream_t st) {
    if (n_rows % TILE_ROWS || w32 % 2 || (planes != 1 && planes != 3))
        return cudaErrorInvalidValue;
    const WgmmaShape sh = wgmma_shape(nc, planes);
    return dispatch_chunk(nc, [&](auto n8) {
        constexpr int N8 = decltype(n8)::value;
        const cudaError_t e = wgmma_smem(score_topw_tiles_kernel<N8>, sh);
        if (e != cudaSuccess) return e;
        score_topw_tiles_kernel<N8><<<dim3((unsigned)(n_rows / TILE_ROWS),
                                           n_cc), WG_THREADS, sh.smem_bytes,
                                      st>>>(
            packed, popcnt, static_cast<const unsigned char*>(b), ysum,
            thresh, w32, p, planes, n_used, min_count, sh.stages,
            sh.stage_bytes, sh.ring_bytes, tile_v, tile_g, tile_cnt);
        return cudaGetLastError();
    });
}

}  // namespace kgt

extern "C" int kgt_score_topw(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, const float* thresh, long long n_rows, int w32,
        int p, int nc, int n_cc, int planes, float n_used, float min_count,
        int cand_w, float* tile_v, int* tile_g, int* tile_cnt,
        float* out_v, int* out_g, int* out_ok, unsigned* fallbacks,
        void* stream) {
    using namespace kgt;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = launch_topw_tiles(
        packed, popcnt, b, ysum, thresh, n_rows, w32, p, nc, n_cc, planes,
        n_used, min_count, tile_v, tile_g, tile_cnt, st);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_topw_select(
        tile_v, tile_g, tile_cnt, (int)(n_rows / TILE_ROWS), p, 1, cand_w,
        out_v, out_g, out_ok, fallbacks, st);
}

// The select alone on candidates already in tile_v/tile_g/tile_cnt (the
// layout launch A writes; with lists == 2, K8's two lists): for tests and
// chip_smoke.py.
extern "C" int kgt_topw_select(
        const float* tile_v, const int* tile_g, const int* tile_cnt,
        int n_tiles, int p, int lists, int w, float* out_v, int* out_g,
        int* out_ok, unsigned* fallbacks, void* stream) {
    return (int)kgt::launch_topw_select(
        tile_v, tile_g, tile_cnt, n_tiles, p, lists, w, out_v, out_g, out_ok,
        fallbacks, static_cast<cudaStream_t>(stream));
}

// The path the select takes for these shapes (score_topw.cuh select_path:
// 0 sort, 1 stream, as ops/score.py SELECT_PATHS names them; -1 refused).
// Host only: the wrappers count launches by it.
extern "C" int kgt_select_path(int n_tiles, int lists, int w) {
    return kgt::select_path(n_tiles, lists, w);
}

extern "C" const char* kgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
