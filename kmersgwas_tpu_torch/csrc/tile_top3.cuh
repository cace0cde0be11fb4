// Per-(column, tile) top-3 of a scored tile: shared by score_topw.cu (K1's
// tile launch) and score_tilemax.cu (K3).
//
// After load_column_group (score_wgmma.cuh), lane tr of a warp holds
// s[i][j], the score of row tr + 32*i and column j of the warp's 8-column
// group, so one warp holds all TILE_ROWS rows of its columns. column_top3
// reduces one column j of the warp to the tile's three best (score, lane)
// pairs in the order (score desc, lane asc): the lowest lane wins ties, as
// the stable sorts of the plain versions order them. Padding rows score
// -inf and take part like any other lane, so a tile of padding gives
// (-inf, 0), (-inf, 1), (-inf, 2).
#pragma once

#include <climits>

#include "score_common.cuh"

namespace kgt {

struct Top3 {
    float v0, v1, v2;
    int i0, i1, i2;
};

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
    return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void top3_insert(Top3& t, float v, int i) {
    if (!better(v, i, t.v2, t.i2)) return;
    if (better(v, i, t.v1, t.i1)) {
        t.v2 = t.v1; t.i2 = t.i1;
        if (better(v, i, t.v0, t.i0)) {
            t.v1 = t.v0; t.i1 = t.i0;
            t.v0 = v; t.i0 = i;
        } else {
            t.v1 = v; t.i1 = i;
        }
    } else {
        t.v2 = v; t.i2 = i;
    }
}

// The tile's top-3 of column j, in every lane of the warp. Every lane of
// the warp must call this (it shuffles).
__device__ __forceinline__ Top3 column_top3(const float (&s)[TM_R][TM_C],
                                            int j, int tr) {
    Top3 t = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
              INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
    for (int i = 0; i < TM_R; ++i) top3_insert(t, s[i][j], tr + 32 * i);
    // butterfly: after step `off` each lane holds the top-3 of the 2*off
    // lanes of its group; the groups merged are disjoint
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float v0 = __shfl_xor_sync(FULL_MASK, t.v0, off);
        const float v1 = __shfl_xor_sync(FULL_MASK, t.v1, off);
        const float v2 = __shfl_xor_sync(FULL_MASK, t.v2, off);
        const int i0 = __shfl_xor_sync(FULL_MASK, t.i0, off);
        const int i1 = __shfl_xor_sync(FULL_MASK, t.i1, off);
        const int i2 = __shfl_xor_sync(FULL_MASK, t.i2, off);
        top3_insert(t, v0, i0);
        top3_insert(t, v1, i1);
        top3_insert(t, v2, i2);
    }
    return t;
}

// Number of the tile's lanes in column j whose score satisfies `pred`, in
// every lane of the warp.
template <typename Pred>
__device__ __forceinline__ int column_count(const float (&s)[TM_R][TM_C],
                                            int j, Pred pred) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < TM_R; ++i) n += pred(s[i][j]) ? 1 : 0;
    return __reduce_add_sync(FULL_MASK, n);
}

}  // namespace kgt
