// The two launches of the top-W scan kernels: shared by score_topw.cu (K1)
// and score_parity.cu (K8's two-list epilogue).
//
//   launch_topw_tiles (defined in score_topw.cu): one block per (128-row
//      tile, column chunk) scores its tile on the tensor cores
//      (score_wgmma.cuh) and writes, per (column, tile), the top-3 (score,
//      batch lane) with the lowest lane winning ties, and the count of lanes
//      scoring > thresh. A warp holds all 128 rows of a column, so both
//      reductions are warp reductions (tile_top3.cuh).
//   topw_select_kernel: one block per (column, list) takes the exact top-W
//      of its list's candidates by (score desc, lane asc) with a radix
//      select on a 64-bit key, sorts them (bitonic, shared memory) and ANDs
//      the tile guards (cnt <= 3 in every tile). With one list (K1) every
//      tile's candidates form the list; with two (K8) list L holds the
//      tiles t with t % 2 == L. With fewer than W candidates a list is
//      padded with (-inf, 0), as the reference's XLA mirror pads
//      (kmersgwas_tpu/ops/scanstep.py `_topw_xla`).
//
// The select kernel has internal linkage (static), so each source that
// includes this header carries its own copy and the objects link into one
// library.
#pragma once

#include "tile_top3.cuh"

namespace kgt {

// Launch A on `st`: b is the (n_cc, N_pad / 64, planes, nc / 8, 8, 8, 8)
// bf16 operand of ops/score.wgmma_operand; ysum and thresh are padded to
// n_cc * nc columns. tile_v/tile_g: (p, 3 * n_tiles), tile_cnt: (p,
// n_tiles). Returns the launch's error code.
cudaError_t launch_topw_tiles(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, const float* thresh, long long n_rows, int w32,
        int p, int nc, int n_cc, int planes, float n_used, float min_count,
        float* tile_v, int* tile_g, int* tile_cnt, cudaStream_t st);

// 64-bit key ordered like (score desc, lane asc): the score's key
// (tile_top3.cuh score_key) above the complemented lane. Key 0 sorts below
// every real candidate and fills the sort buffer past W.
__device__ __forceinline__ unsigned long long cand_key(float v, int g) {
    return ((unsigned long long)score_key(v) << 32)
           | (unsigned)(~(unsigned)g);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
    return key_score((unsigned)(key >> 32));
}

__device__ __forceinline__ int key_lane(unsigned long long key) {
    return (int)(~(unsigned)key);
}

// tile_v/tile_g: (p, 3*n_tiles), tile_cnt: (p, n_tiles); out_v/out_g:
// (gridDim.y, p, w) lists; out_ok: (p,), written by list 0.
static __global__ void __launch_bounds__(THREADS) topw_select_kernel(
        const float* __restrict__ tile_v, const int* __restrict__ tile_g,
        const int* __restrict__ tile_cnt, int n_tiles, int w, int sort_cap,
        float* __restrict__ out_v, int* __restrict__ out_g,
        int* __restrict__ out_ok) {
    extern __shared__ unsigned long long keys[];    // sort_cap entries
    __shared__ unsigned hist[256];
    __shared__ unsigned long long s_prefix;
    __shared__ unsigned s_rem;
    __shared__ unsigned s_count;

    const int c = blockIdx.x;
    const int p = gridDim.x;
    const int list = blockIdx.y;
    const bool split = gridDim.y > 1;
    // candidate j of the list is entry cand(j) of the column's 3*n_tiles:
    // slot j % 3 of the list's tile j / 3
    const int n = split ? 3 * ((n_tiles - list + 1) / 2) : 3 * n_tiles;
    auto cand = [=](int j) {
        return split ? 3 * (2 * (j / 3) + list) + j % 3 : j;
    };
    const float* cv = tile_v + (size_t)c * 3 * n_tiles;
    const int* cg = tile_g + (size_t)c * 3 * n_tiles;

    int good = 1;
    for (int t = threadIdx.x; t < n_tiles; t += THREADS)
        good &= tile_cnt[(size_t)c * n_tiles + t] <= 3;
    good = __syncthreads_and(good);

    if (n <= w) {
        const unsigned long long pad = cand_key(-CUDART_INF_F, 0);
        for (int i = threadIdx.x; i < sort_cap; i += THREADS)
            keys[i] = i < n ? cand_key(cv[cand(i)], cg[cand(i)])
                            : (i < w ? pad : 0ull);
    } else {
        // radix select of the w-th largest key, 8 bits at a time from the
        // top; keys are unique (lanes are), so exactly w keys are >= it
        unsigned long long prefix = 0, mask = 0;
        unsigned rem = w;
        for (int shift = 56; shift >= 0; shift -= 8) {
            for (int i = threadIdx.x; i < 256; i += THREADS) hist[i] = 0;
            __syncthreads();
            for (int i = threadIdx.x; i < n; i += THREADS) {
                const unsigned long long k = cand_key(cv[cand(i)],
                                                      cg[cand(i)]);
                if ((k & mask) == prefix)
                    atomicAdd(&hist[(k >> shift) & 255], 1u);
            }
            __syncthreads();
            if (threadIdx.x == 0) {
                unsigned cum = 0;
                int d = 255;
                for (; d > 0; --d) {
                    if (cum + hist[d] >= rem) break;
                    cum += hist[d];
                }
                s_prefix = prefix | ((unsigned long long)d << shift);
                s_rem = rem - cum;
            }
            __syncthreads();
            prefix = s_prefix;
            rem = s_rem;
            mask |= 255ull << shift;
        }
        if (threadIdx.x == 0) s_count = 0;
        for (int i = threadIdx.x; i < sort_cap; i += THREADS) keys[i] = 0ull;
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += THREADS) {
            const unsigned long long k = cand_key(cv[cand(i)], cg[cand(i)]);
            if (k >= prefix) {
                const unsigned slot = atomicAdd(&s_count, 1u);
                if (slot < (unsigned)w) keys[slot] = k;
            }
        }
    }
    __syncthreads();

    // bitonic sort, descending, of the sort_cap (power of two) keys
    for (int k = 2; k <= sort_cap; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < sort_cap; i += THREADS) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const unsigned long long a = keys[i], b = keys[ixj];
                    const bool desc = (i & k) == 0;
                    if (desc ? (a < b) : (a > b)) {
                        keys[i] = b;
                        keys[ixj] = a;
                    }
                }
            }
            __syncthreads();
        }
    }

    const size_t o = ((size_t)list * p + c) * w;
    for (int i = threadIdx.x; i < w; i += THREADS) {
        out_v[o + i] = key_value(keys[i]);
        out_g[o + i] = key_lane(keys[i]);
    }
    if (threadIdx.x == 0 && list == 0) out_ok[c] = good;
}

}  // namespace kgt
