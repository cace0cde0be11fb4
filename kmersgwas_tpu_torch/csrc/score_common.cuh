// Shared pieces of the association-score kernels: the tile height
// (TILE_ROWS), the top-3 layout of a tile's column group (TM_R x TM_C), the
// block size of the small selection and merge kernels (THREADS), and the
// score of one (row, column):
//
//     score = (N*yigi - n1*ysum)^2 / (N*n1 - n1^2)
//             0 when denom <= 0 or the MAC filter fails (score_value),
//             -inf when popcnt == 0, a padding row (score_epilogue)
//
// which is kmersgwas_tpu/ops/score.py's fused epilogue (score.py:492-499);
// score_value alone is the row-major `_score_kernel`'s (score.py:630-644).
// The sums yigi come from the tensor-core body (score_wgmma.cuh). The
// epilogue uses the _rn intrinsics so that nvcc does not contract it into
// FMAs: it then rounds at exactly the places PyTorch's elementwise ops do,
// and scores agree bit for bit with the plain version wherever the sums
// are exact (dyadic phenotypes).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace kgt {

constexpr int TILE_ROWS = 128;
constexpr int THREADS = 256;
constexpr int TM_R = 4;
constexpr int TM_C = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(TILE_ROWS == 32 * TM_R, "a warp holds every row of a tile");

__device__ __forceinline__ float score_value(float yigi, float n1,
                                             float ysum, float n,
                                             float min_count) {
    const float r = __fsub_rn(__fmul_rn(n, yigi), __fmul_rn(n1, ysum));
    const float denom = __fsub_rn(__fmul_rn(n, n1), __fmul_rn(n1, n1));
    const float s = denom > 0.f ? __fdiv_rn(__fmul_rn(r, r), denom) : 0.f;
    const bool ok = (n1 >= min_count) && (__fsub_rn(n, n1) >= min_count);
    return ok ? s : 0.f;
}

__device__ __forceinline__ float score_epilogue(float yigi, float n1,
                                                float ysum, float n,
                                                float min_count) {
    return n1 > 0.f ? score_value(yigi, n1, ysum, n, min_count)
                    : -CUDART_INF_F;
}

}  // namespace kgt
