// Per-(column, tile) top-3 of a scored tile: shared by score_topw.cu (K1's
// tile launch, also run by K8's score_parity.cu) and score_tilemax.cu (K3).
//
// After load_column_group (score_wgmma.cuh), lane tr of a warp holds
// s[i][j], the score of row tr + 32*i and column j of the warp's 8-column
// group, so one warp holds all TILE_ROWS rows of its columns. column_top3
// reduces one column j of the warp to the tile's three best (score, lane)
// pairs in the order (score desc, lane asc): the lowest lane wins ties, as
// the stable sorts of the plain versions order them. Padding rows score
// -inf and take part like any other lane, so a tile of padding gives
// (-inf, 0), (-inf, 1), (-inf, 2).
//
// Design: three rounds of two warp reductions on an order-preserving
// 32-bit key of the score (score_key). In each round every lane offers its
// best row not yet taken (the largest key, the lowest i among equal keys,
// so the lowest row: rows of a lane are tr + 32*i); __reduce_max_sync gives
// the round's key m, and __reduce_min_sync over the rows of the lanes
// whose best key is m gives the lowest row holding m; the lane holding
// that row marks it taken (key 0, below every score's key). That is 6
// redux instructions and a few dozen selects and compares a column, with
// no branch for a lane to diverge on. Scores are never NaN or -0.0
// (score_epilogue), so equal scores have equal keys and a key decodes to
// the score's own bits.
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

// Inserts (v, i) into a top-3 ordered by (score desc, lane asc): K8's merge
// of sub-tile top-3s (score_parity.cu).
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

// A float's order-preserving bit pattern: a > b as floats (neither NaN,
// no -0.0) iff score_key(a) > score_key(b). -inf maps to 0x007fffff, so
// key 0 lies below every score.
__device__ __forceinline__ unsigned score_key(float v) {
    const unsigned u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The tile's top-3 of column j, in every lane of the warp. Every lane of
// the warp must call this (it reduces across the warp).
__device__ __forceinline__ Top3 column_top3(const float (&s)[TM_R][TM_C],
                                            int j, int tr) {
    unsigned k[TM_R];
#pragma unroll
    for (int i = 0; i < TM_R; ++i) k[i] = score_key(s[i][j]);
    unsigned m[3];
    int row[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        unsigned best = k[0];
        int best_row = tr;
#pragma unroll
        for (int i = 1; i < TM_R; ++i) {
            if (k[i] > best) {
                best = k[i];
                best_row = tr + 32 * i;
            }
        }
        m[r] = __reduce_max_sync(FULL_MASK, best);
        row[r] = (int)__reduce_min_sync(
            FULL_MASK, best == m[r] ? (unsigned)best_row : UINT_MAX);
        if (r < 2) {
            const int d = row[r] - tr;
#pragma unroll
            for (int i = 0; i < TM_R; ++i) k[i] = d == 32 * i ? 0u : k[i];
        }
    }
    return {key_score(m[0]), key_score(m[1]), key_score(m[2]),
            row[0], row[1], row[2]};
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
