// score_tilemax: the multi-process scan step's per-batch kernel on Hopper
// (sm_90a), the `cand_c` mode of ops/scanstep.scan_step_compact.
//
// Replaces kmersgwas_tpu/ops/score.py `_score_t_tilemax_kernel` (and its
// wrapper `score_batch_t_pallas_tilemax`): score one batch of k-mers
// against every phenotype column and return, per (column c, tile t of
// TILE_ROWS lanes), nine (P, n_tiles) planes. With s the tile's scores
// (-inf on padding rows):
//   tmax, targ    the largest score and the lowest lane holding it;
//   tmax2, targ2  the same over s2 = s with lane targ set to -inf;
//   tmax3, targ3  the same over s3 = s2 with lane targ2 set to -inf;
//   n2, n3        #{l : s2[l] == tmax2}, #{l : s3[l] == tmax3} (the masked
//                 lanes count too when the value is -inf, as in the
//                 reference's XLA mirror, kmersgwas_tpu/ops/scanstep.py
//                 `_tilemax`);
//   cnt           #{l : s[l] > thresh[c]}.
// targ* are lanes within the tile. (tmax, targ), (tmax2, targ2), (tmax3,
// targ3) are the first three of the tile's lanes ordered by (score desc,
// lane asc), exactly: the TPU kernel sum-encodes the 2nd and 3rd lanes and
// reports n2/n3 so its caller can fall back where they are ambiguous; here
// they are exact, and n2/n3 are kept because the step's guards read them.
//
// Design. One launch, one block per (128-row tile, column chunk of up to
// 128): the block scores its tile on the tensor cores (score_wgmma.cuh, the
// body of K1's tile launch), and each warp reduces 8 columns at a time with
// the top-3 of K1's tile launch (tile_top3.cuh: warp max and min reductions
// on ordered keys), then counts the lanes equal to the 2nd and 3rd values
// and above thresh (warp sums). Lane
// 0 writes one entry per column to each plane. Nothing else reaches device
// memory: 9 x P x n_tiles x 4 B (57 MB at the flagship batch of 2,000,000
// rows and P = 101). The TPU kernel's VMEM-resident and blocked output
// modes exist only for Mosaic and have no counterpart.
//
// What bounds it. The (R, N) x (N, P) score product of K1's tile launch,
// 4.3e11 FLOP at the flagship batch (0.43 ms at the bf16 tensor-core peak);
// the packed bits are read once (128 B per k-mer) and the planes written
// once (0.02 ms each at the HBM rate). The product runs on the tensor
// cores with the columns padded to 8. As in K1's tile launch
// (score_topw.cu), the body holds it above the bound more than the
// per-tile epilogue does; this epilogue adds two warp sums per column to
// K1's, and the plane stores are 4 B scattered writes.
#include "score_wgmma.cuh"

namespace kgt {

template <int N8>
__global__ void __launch_bounds__(WG_THREADS, 2)
score_tilemax_kernel(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const unsigned char* __restrict__ b, const float* __restrict__ ysum,
        const float* __restrict__ thresh, int w32, int p, int planes,
        float n_used, float min_count, int stages, uint32_t stage_bytes,
        size_t ring_bytes, float* __restrict__ tmax, int* __restrict__ targ,
        float* __restrict__ tmax2, int* __restrict__ targ2,
        float* __restrict__ tmax3, int* __restrict__ targ3,
        int* __restrict__ n2, int* __restrict__ n3, int* __restrict__ cnt) {
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
            const int hot = column_count(s, j,
                                         [th](float v) { return v > th; });
            const float v1 = t.v1, v2 = t.v2;
            const int eq1 = column_count(s, j,
                                         [v1](float v) { return v == v1; });
            const int eq2 = column_count(s, j,
                                         [v2](float v) { return v == v2; });
            if (tr == 0 && c < p) {
                // s2 drops lane i0 (score v0) and holds -inf there; s3 also
                // drops lane i1 (score v1)
                const bool inf1 = v1 == -CUDART_INF_F;
                const bool inf2 = v2 == -CUDART_INF_F;
                const size_t o = (size_t)c * n_tiles + tile;
                tmax[o] = t.v0;
                targ[o] = t.i0;
                tmax2[o] = v1;
                targ2[o] = t.i1;
                tmax3[o] = v2;
                targ3[o] = t.i2;
                n2[o] = eq1 - (t.v0 == v1) + inf1;
                n3[o] = eq2 - (t.v0 == v2) - (v1 == v2) + 2 * inf2;
                cnt[o] = hot;
            }
        }
    }
}

}  // namespace kgt

// b: the (n_cc, N_pad / 64, planes, nc / 8, 8, 8, 8) bf16 operand of
// ops/score.wgmma_operand; ysum and thresh padded to n_cc * nc columns; the
// nine planes (p, n_rows / 128).
extern "C" int kgt_score_tilemax(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, const float* thresh, long long n_rows, int w32,
        int p, int nc, int n_cc, int planes, float n_used, float min_count,
        float* tmax, int* targ, float* tmax2, int* targ2, float* tmax3,
        int* targ3, int* n2, int* n3, int* cnt, void* stream) {
    using namespace kgt;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (n_rows % TILE_ROWS || w32 % 2 || (planes != 1 && planes != 3))
        return (int)cudaErrorInvalidValue;
    const WgmmaShape sh = wgmma_shape(nc, planes);
    return (int)dispatch_chunk(nc, [&](auto n8) {
        constexpr int N8 = decltype(n8)::value;
        const cudaError_t e = wgmma_smem(score_tilemax_kernel<N8>, sh);
        if (e != cudaSuccess) return e;
        score_tilemax_kernel<N8><<<dim3((unsigned)(n_rows / TILE_ROWS), n_cc),
                                   WG_THREADS, sh.smem_bytes, st>>>(
            packed, popcnt, static_cast<const unsigned char*>(b), ysum,
            thresh, w32, p, planes, n_used, min_count, sh.stages,
            sh.stage_bytes, sh.ring_bytes, tmax, targ, tmax2, targ2, tmax3,
            targ3, n2, n3, cnt);
        return cudaGetLastError();
    });
}
