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
// work is split in two launches:
//   A. score_topw_tiles: one block per (128-row tile, 64-column chunk)
//      scores its tile (score_common.cuh) and writes, per (column, tile),
//      the top-3 (score, lane) with the lowest lane winning ties, and the
//      count of lanes scoring > thresh. The 128 rows of a column live in
//      one warp, so both reductions are warp shuffles (tile_top3.cuh,
//      shared with score_tilemax.cu).
//   B. topw_select: one block per column takes the exact top-W of the
//      3*n_tiles candidates by (score desc, lane asc) with a radix select
//      on a 64-bit key, sorts them (bitonic, shared memory) and ANDs the
//      tile guards. With fewer than W candidates it pads with (-inf, 0),
//      as the reference's XLA mirror does (kmersgwas_tpu/ops/scanstep.py
//      `_topw_xla`).
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
#include "tile_top3.cuh"

namespace kgt {

__global__ void __launch_bounds__(THREADS) score_topw_tiles_kernel(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const float* __restrict__ y, const float* __restrict__ ysum,
        const float* __restrict__ thresh, int w32, int p, int p_pad,
        float n_used, float min_count, float* __restrict__ tile_v,
        int* __restrict__ tile_g, int* __restrict__ tile_cnt) {
    extern __shared__ __align__(16) unsigned char smem[];
    const long long tile = blockIdx.x;
    const long long n_tiles = gridDim.x;
    const long long row0 = tile * TILE_ROWS;
    const int c0 = blockIdx.y * TILE_COLS;
    const int tr = threadIdx.x & 31;
    const int tc = threadIdx.x >> 5;

    float s[TM_R][TM_C];
    score_tile(packed, popcnt, y, ysum, row0, c0, w32, p_pad, n_used,
               min_count, smem, s);

#pragma unroll
    for (int j = 0; j < TM_C; ++j) {
        const int c = c0 + tc * TM_C + j;
        const float th = thresh[c];
        const Top3 t = column_top3(s, j, tr);
        const int cnt = column_count(s, j, [th](float v) { return v > th; });
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

// 64-bit key ordered like (score desc, lane asc): the float's order-
// preserving bit pattern above the complemented lane. Key 0 sorts below
// every real candidate and fills the sort buffer past W.
__device__ __forceinline__ unsigned long long cand_key(float v, int g) {
    unsigned u = __float_as_uint(v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)u << 32) | (unsigned)(~(unsigned)g);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
    unsigned u = (unsigned)(key >> 32);
    u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    return __uint_as_float(u);
}

__device__ __forceinline__ int key_lane(unsigned long long key) {
    return (int)(~(unsigned)key);
}

__global__ void __launch_bounds__(THREADS) topw_select_kernel(
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
    const int n = 3 * n_tiles;
    const float* cv = tile_v + (size_t)c * n;
    const int* cg = tile_g + (size_t)c * n;

    int good = 1;
    for (int t = threadIdx.x; t < n_tiles; t += THREADS)
        good &= tile_cnt[(size_t)c * n_tiles + t] <= 3;
    good = __syncthreads_and(good);

    if (n <= w) {
        const unsigned long long pad = cand_key(-CUDART_INF_F, 0);
        for (int i = threadIdx.x; i < sort_cap; i += THREADS)
            keys[i] = i < n ? cand_key(cv[i], cg[i]) : (i < w ? pad : 0ull);
    } else {
        // radix select of the w-th largest key, 8 bits at a time from the
        // top; keys are unique (lanes are), so exactly w keys are >= it
        unsigned long long prefix = 0, mask = 0;
        unsigned rem = w;
        for (int shift = 56; shift >= 0; shift -= 8) {
            for (int i = threadIdx.x; i < 256; i += THREADS) hist[i] = 0;
            __syncthreads();
            for (int i = threadIdx.x; i < n; i += THREADS) {
                const unsigned long long k = cand_key(cv[i], cg[i]);
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
            const unsigned long long k = cand_key(cv[i], cg[i]);
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

    for (int i = threadIdx.x; i < w; i += THREADS) {
        out_v[(size_t)c * w + i] = key_value(keys[i]);
        out_g[(size_t)c * w + i] = key_lane(keys[i]);
    }
    if (threadIdx.x == 0) out_ok[c] = good;
}

}  // namespace kgt

extern "C" int kgt_score_topw(
        const uint32_t* packed, const float* popcnt, const float* y,
        const float* ysum, const float* thresh, long long n_rows, int w32,
        int p, int p_pad, float n_used, float min_count, int cand_w,
        int sort_cap, float* tile_v, int* tile_g, int* tile_cnt,
        float* out_v, int* out_g, int* out_ok, void* stream) {
    using namespace kgt;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = tile_smem_bytes(w32);
    cudaError_t e = cudaFuncSetAttribute(
        score_topw_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int n_tiles = (int)(n_rows / TILE_ROWS);
    score_topw_tiles_kernel<<<dim3(n_tiles, p_pad / TILE_COLS), THREADS,
                              smem, st>>>(
        packed, popcnt, y, ysum, thresh, w32, p, p_pad, n_used, min_count,
        tile_v, tile_g, tile_cnt);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    topw_select_kernel<<<p, THREADS, sizeof(unsigned long long) * sort_cap,
                         st>>>(
        tile_v, tile_g, tile_cnt, n_tiles, cand_w, sort_cap, out_v, out_g,
        out_ok);
    return (int)cudaGetLastError();
}

extern "C" const char* kgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
