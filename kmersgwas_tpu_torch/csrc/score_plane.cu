// score_plane: the scores of one batch, whole, on Hopper (sm_90a): the
// scan step's exact-fallback kernel (K2, kgt_score_bmax), the plain step's
// kernel (K4, kgt_score_t) and the row-major score function (K5,
// kgt_score_rows).
//
// Replaces kmersgwas_tpu/ops/score.py `_score_t_bmax_kernel` (wrapper
// `score_batch_t_pallas_bmax`), `_score_t_kernel` (`score_batch_t_pallas`)
// and `_score_kernel` (`score_batch_pallas`). K2 and K4: the full (P, R)
// f32 scores of one batch, -inf on padding rows (popcnt == 0); K2 also
// returns the maxima of its 16-lane blocks, (P, R/16), which the exact
// top-k extraction (ops/topk.top_k_from_bmax) reads instead of re-reading
// the scores. The TPU kernel folds STRIDED blocks (lane b + nb*j of a
// tile) because Mosaic cannot reshape along lanes; here a block is 16
// CONSECUTIVE lanes. K5: the (R, P) f32 scores, 0 where the MAC test fails
// and no padding mask (a popcnt == 0 row scores 0); its scores are K4's,
// transposed, with -inf as 0, bit for bit.
//
// Design. One template, score_plane_kernel<N8, MODE>, one block per
// (128-row tile, column chunk of up to 128): the block scores its tile on
// the tensor cores (score_wgmma.cuh, the body of K1's tile launch and K3,
// so K2's scores equal K1's bit for bit at the same column chunks), which
// leaves the tile in shared memory. The epilogue by MODE:
//   PLANE_T, PLANE_BMAX (K4, K2): the tile is column-major with a row
//     stride of S_LD = 132 floats: column c is 128 contiguous f32 (512
//     bytes) at a 16-byte aligned address, and so is its destination, the
//     run scores[(c0 + c) * R + row0 ...]. Consumer thread c stores column
//     c with one bulk copy (cp.async.bulk shared -> global, 512 bytes) and
//     waits for its read of shared memory before it exits. The copy engine
//     moves the tile while the warps compute the block maxima, and the SM's
//     other block runs its k loop. The block is not persistent, so no ring
//     refill can overwrite the tile under the copies.
//   PLANE_BMAX (K2) also: each consumer warp reads its columns from shared
//     memory, lane l rows 4l to 4l+3 as one float4: a block's maximum is
//     the max of 4 values and 2 xor shuffles; lanes l % 4 == 0 write it.
//   PLANE_ROWS (K5): the tile is row-major (score_wgmma.cuh `row_ld`). The
//     block's destination is rows row0 + [0, 128) of the chunk's nc real
//     columns: runs of nc floats P apart, one contiguous run of 128 * P
//     floats when one chunk holds every column (P <= 128). Such runs are
//     16-byte aligned only where P % 4 == 0 (not at P = 101, 257, 509,
//     1013), so bulk copies cannot serve them: the consumer threads store
//     the region element by element in row-major order, thread t elements
//     t, t + 256, ..., so a warp writes 32 consecutive floats of a run and
//     reads 32 consecutive floats of a tile row. Offsets are 64-bit: row x
//     P passes 2^31 at R = 2^21 and P >= 1024.
//
// Registers. __launch_bounds__(WG_THREADS, 2), as K1 and K3 have it, let
// ptxas serialize the 128-column chunk's products (C7512) in this kernel,
// with or without an epilogue; a hard cap of 96 registers (__maxnreg__)
// does not, and still fits two blocks an SM.
//
// What bounds it. The (R, N) x (N, P) score product, 4.3e11 FLOP at the
// flagship batch (2,097,152 x 1008 x 101): 0.43 ms at the bf16
// tensor-core peak. The score plane is 0.85 GB at that batch (0.25 ms at
// 3.35 TB/s) in either layout, the block maxima 1/16 of it.
#include "score_wgmma.cuh"

namespace kgt {

// score_plane_kernel's modes (its second template argument)
constexpr int PLANE_T = 0;          // K4: (P, R) scores
constexpr int PLANE_BMAX = 1;       // K2: (P, R) scores, 16-lane maxima
constexpr int PLANE_ROWS = 2;       // K5: (R, P) scores, no padding mask

template <int N8, int MODE>
__global__ void __maxnreg__(96)
score_plane_kernel(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const unsigned char* __restrict__ b, const float* __restrict__ ysum,
        int w32, int p, int planes, float n_used, float min_count,
        int stages, uint32_t stage_bytes, size_t ring_bytes,
        float* __restrict__ scores, float* __restrict__ bmax) {
    constexpr bool ROWS = MODE == PLANE_ROWS;
    extern __shared__ __align__(128) unsigned char smem[];
    const long long n_rows = (long long)gridDim.x * TILE_ROWS;
    const long long row0 = (long long)blockIdx.x * TILE_ROWS;
    const int c0 = blockIdx.y * 8 * N8;
    const size_t chunk_bytes = (size_t)(w32 * 32 / KC) * stage_bytes;
    if (!wgmma_score_tile<N8, !ROWS, ROWS>(
            packed, popcnt, b + blockIdx.y * chunk_bytes, ysum + c0, row0,
            w32, planes, n_used, min_count, stages, stage_bytes, ring_bytes,
            smem))
        return;
    const float* st = reinterpret_cast<const float*>(smem);
    const int nc = min(8 * N8, p - c0);         // the chunk's real columns
    const int t = threadIdx.x;
    if (ROWS) {
        // element i = r * nc + c of the region; thread t walks i = t, t +
        // 256, ... carrying (r, c) instead of dividing. Unrolled by 4 so
        // that several loads of the tile can be in flight before their
        // stores: the loop not unrolled was slower in every turn of an A/B
        // timing (P = 101 and 1013, both precisions).
        constexpr int LD = row_ld(8 * N8);
        const int dr = WG_CONSUMERS / nc, dc = WG_CONSUMERS % nc;
        float* dst = scores + row0 * p + c0;
        int r = t / nc, c = t % nc;
#pragma unroll 4
        for (int i = t; i < TILE_ROWS * nc; i += WG_CONSUMERS) {
            dst[(long long)r * p + c] = st[r * LD + c];
            r += dr;
            c += dc;
            if (c >= nc) {
                c -= nc;
                ++r;
            }
        }
        return;
    }
    if (t < nc) {
        bulk_store(scores + (size_t)(c0 + t) * n_rows + row0, st + t * S_LD,
                   TILE_ROWS * sizeof(float));
        bulk_commit();
    }
    if (MODE == PLANE_BMAX) {
        const int lane = t & 31;
        for (int c = t >> 5; c < nc; c += WG_CONSUMERS / 32) {
            const float4 v =
                reinterpret_cast<const float4*>(st + c * S_LD)[lane];
            float m = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
            m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 1));
            m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, 2));
            if ((lane & 3) == 0)
                bmax[(size_t)(c0 + c) * (n_rows / 16) + row0 / 16
                     + lane / 4] = m;
        }
    }
    if (t < nc) bulk_wait_read();   // the tile stays till the copy read it
}

template <int MODE>
cudaError_t launch_score_plane(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, long long n_rows, int w32, int p, int nc,
        int n_cc, int planes, float n_used, float min_count, float* scores,
        float* bmax, cudaStream_t st) {
    if (n_rows % TILE_ROWS || w32 % 2 || (planes != 1 && planes != 3))
        return cudaErrorInvalidValue;
    const WgmmaShape sh = wgmma_shape(nc, planes, MODE == PLANE_ROWS);
    return dispatch_chunk(nc, [&](auto n8) {
        constexpr int N8 = decltype(n8)::value;
        const cudaError_t e = wgmma_smem(score_plane_kernel<N8, MODE>, sh);
        if (e != cudaSuccess) return e;
        score_plane_kernel<N8, MODE>
            <<<dim3((unsigned)(n_rows / TILE_ROWS), n_cc), WG_THREADS,
               sh.smem_bytes, st>>>(
                packed, popcnt, static_cast<const unsigned char*>(b), ysum,
                w32, p, planes, n_used, min_count, sh.stages, sh.stage_bytes,
                sh.ring_bytes, scores, bmax);
        return cudaGetLastError();
    });
}

}  // namespace kgt

// b: the (n_cc, N_pad / 64, planes, nc / 8, 8, 8, 8) bf16 operand of
// ops/score.wgmma_operand; ysum padded to n_cc * nc columns; scores (p,
// n_rows), (n_rows, p) for kgt_score_rows; bmax (p, n_rows / 16).
extern "C" int kgt_score_bmax(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, long long n_rows, int w32, int p, int nc,
        int n_cc, int planes, float n_used, float min_count, float* scores,
        float* bmax, void* stream) {
    return (int)kgt::launch_score_plane<kgt::PLANE_BMAX>(
        packed, popcnt, b, ysum, n_rows, w32, p, nc, n_cc, planes, n_used,
        min_count, scores, bmax, static_cast<cudaStream_t>(stream));
}

extern "C" int kgt_score_t(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, long long n_rows, int w32, int p, int nc,
        int n_cc, int planes, float n_used, float min_count, float* scores,
        void* stream) {
    return (int)kgt::launch_score_plane<kgt::PLANE_T>(
        packed, popcnt, b, ysum, n_rows, w32, p, nc, n_cc, planes, n_used,
        min_count, scores, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int kgt_score_rows(
        const uint32_t* packed, const float* popcnt, const void* b,
        const float* ysum, long long n_rows, int w32, int p, int nc,
        int n_cc, int planes, float n_used, float min_count, float* scores,
        void* stream) {
    return (int)kgt::launch_score_plane<kgt::PLANE_ROWS>(
        packed, popcnt, b, ysum, n_rows, w32, p, nc, n_cc, planes, n_used,
        min_count, scores, nullptr, static_cast<cudaStream_t>(stream));
}
