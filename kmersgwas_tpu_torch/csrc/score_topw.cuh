// The two launches of the top-W scan kernels: shared by score_topw.cu (K1)
// and score_parity.cu (K8's two-list epilogue).
//
//   launch_topw_tiles (defined in score_topw.cu): one block per (128-row
//      tile, column chunk) scores its tile on the tensor cores
//      (score_wgmma.cuh) and writes, per (column, tile), the top-3 (score,
//      batch lane) with the lowest lane winning ties, and the count of lanes
//      scoring > thresh. A warp holds all 128 rows of a column, so both
//      reductions are warp reductions (tile_top3.cuh).
//   topw_select_kernel<PATH>: one block of 1024 threads per (column, list)
//      takes the exact top-W of its list's candidates by (score desc, lane
//      asc), as a 64-bit key (cand_key), and ANDs the tile guards (cnt <= 3
//      in every tile). With one list (K1) every tile's candidates form the
//      list; with two (K8) list L holds the tiles t with t % 2 == L. With
//      fewer than W candidates a list is padded with (-inf, 0), as the
//      reference's XLA mirror pads (kmersgwas_tpu/ops/scanstep.py
//      `_topw_xla`). The path follows the lists' candidate counts and W
//      (select_path; ops/score.py counts it as topw_select.<path>):
//        sort    a list of at most SEL_SORT_MAX (1024), or one of fewer
//                than W: every key into shared memory, one bitonic sort.
//        stream  longer lists: a pass over the scores (from L2,
//                SEL_UNROLL coalesced loads in flight a thread) turns them
//                into order-preserving 32-bit keys and keeps each thread's
//                two largest. Those 2048 are distinct candidates, so the
//                W-th largest of them (bit by bit, one barrier count a bit)
//                is a bound at or below the list's W-th largest score. A
//                thread whose second largest is below the bound holds one
//                candidate at or above it, its largest; the few others
//                read their scores again. The candidates at or above the
//                bound go to a sort buffer (one shared atomic each), then
//                their lanes load at once, and one bitonic sort of those
//                gives the top-W. On random scores W to ~1.3 W pass.
//      Fallback, counted in a device integer: more than SEL_CAP candidates
//      at or above the bound (equal scores, -inf tiles) take an exact radix
//      select, four 8-bit passes over the score keys, then four over the
//      complemented lanes of the W-th score's ties, each histogram one
//      shared atomic per distinct digit a warp (__match_any_sync).
//      What bounds it: what it has to read once, each tile's three scores
//      and its count (16 B a tile and column) and the lanes of the W
//      winners: 25 MB at the flagship batch (101 x 15,625 tiles, W 256),
//      7.6 us at 3.35 TB/s. The stream path reads the scores once or twice
//      and the counts once; the bound's 64 barrier counts and the sort are
//      what it adds.
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

// ------------------------------------------------------------ the select

// Threads of a select block; candidates the sort path takes; keys the
// stream path's sort buffer holds; score loads in flight a thread.
constexpr int SEL_THREADS = 1024;
constexpr int SEL_SORT_MAX = 1024;
constexpr int SEL_CAP = 4096;
constexpr int SEL_UNROLL = 8;
// the paths, as ops/score.py SELECT_PATHS names them
constexpr int SEL_SORT = 0, SEL_STREAM = 1;

struct SelShared {
    unsigned hist[256];
    unsigned count, prefix, rem, tied;
};

static_assert(2 * SEL_THREADS >= 1024, "the bound ranks W <= 1024 keys");

// A select block's list: candidate j is entry at(j) of its column's
// 3*n_tiles; with two lists (K8) list L holds the tiles t with t % 2 == L,
// so candidate j is slot j % 3 of the list's tile j / 3.
struct SelList {
    const float* v;
    const int* g;
    int n, list;
    bool split;

    __device__ __forceinline__ int at(int j) const {
        return split ? 3 * (2 * (j / 3) + list) + j % 3 : j;
    }
    __device__ __forceinline__ unsigned score(int j) const {
        return score_key(__ldg(v + at(j)));
    }
    __device__ __forceinline__ unsigned lane_key(int j) const {
        return ~(unsigned)__ldg(g + at(j));
    }
    // cand_key of candidate j, whose score key is sk
    __device__ __forceinline__ unsigned long long key(int j,
                                                      unsigned sk) const {
        return ((unsigned long long)sk << 32) | lane_key(j);
    }
};

__host__ __device__ __forceinline__ int pow2_at_least(int x) {
    int n = 1;
    while (n < x) n <<= 1;
    return n;
}

// Calls f(j, key(j), j < n) for every j below n rounded up to the block,
// SEL_UNROLL keys loaded a thread before any is used (j >= n: key 0, below
// every candidate's). The lanes of a warp call f together, so f may vote.
template <class Key, class F>
__device__ __forceinline__ void sweep(int n, Key key, F f) {
    for (int base = 0; base < n; base += SEL_THREADS * SEL_UNROLL) {
        unsigned k[SEL_UNROLL];
#pragma unroll
        for (int u = 0; u < SEL_UNROLL; ++u) {
            const int j = base + u * SEL_THREADS + (int)threadIdx.x;
            k[u] = j < n ? key(j) : 0u;
        }
#pragma unroll
        for (int u = 0; u < SEL_UNROLL; ++u) {
            const int j = base + u * SEL_THREADS + (int)threadIdx.x;
            f(j, k[u], j < n);
        }
    }
}

// hist[d] += 1 where `in` holds: one shared atomic per distinct d a warp,
// so equal digits (the exponent bytes of close scores) do not serialize.
__device__ __forceinline__ void hist_add(bool in, unsigned d,
                                         unsigned* hist) {
    const unsigned m = __ballot_sync(FULL_MASK, in);
    if (in) {
        const unsigned peers = __match_any_sync(m, d);
        if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
            atomicAdd(&hist[d], (unsigned)__popc(peers));
    }
}

// After a histogram of the digits (x >> shift) & 255 of the x in play:
// adds the digit of the rem-th largest x to prefix, leaves in rem its rank
// among the x of that digit and in tied their number. Every thread calls
// it; the histogram may be cleared again once it returns.
__device__ __forceinline__ void radix_pick(SelShared& sh, int shift,
                                           unsigned& prefix, unsigned& rem,
                                           unsigned& tied) {
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned cum = 0;
        int d = 255;
        for (; d > 0 && cum + sh.hist[d] < rem; --d) cum += sh.hist[d];
        sh.prefix = prefix | ((unsigned)d << shift);
        sh.rem = rem - cum;
        sh.tied = sh.hist[d];
    }
    __syncthreads();
    prefix = sh.prefix;
    rem = sh.rem;
    tied = sh.tied;
}

// Sorts a[0, n) descending, n a power of two. Every thread calls it; it
// starts and ends with a barrier. Thread t compares keys i and i + j with
// i = 2t - t % j, so while j <= 32 a warp's pairs lie in 64 keys of its
// own: a step there and the next orders the warp alone.
template <class K>
__device__ void bitonic_desc(K* a, int n) {
    __syncthreads();
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < n / 2; t += SEL_THREADS) {
                const int i = 2 * t - (t & (j - 1));    // bit j clear
                const K x = a[i], y = a[i + j];
                if ((i & k) == 0 ? x < y : x > y) {
                    a[i] = y;
                    a[i + j] = x;
                }
            }
            // the next step's stride: j / 2, or 2k / 2 after j == 1
            if (j >= 64 || (j == 1 && k >= 64))
                __syncthreads();
            else
                __syncwarp();
        }
    }
    __syncthreads();
}

// The w-th largest of the block's 2 * SEL_THREADS keys (a and b of every
// thread), bit by bit from the top: a key count a barrier reduces
// (__syncthreads_count) decides each bit, no histogram and no sort. Every
// thread calls it and gets the key.
__device__ __forceinline__ unsigned block_kth(unsigned a, unsigned b,
                                              int w) {
    unsigned kth = 0, rem = (unsigned)w;
    for (int bit = 31; bit >= 0; --bit) {
        const unsigned hi = kth | (1u << bit);
        const unsigned mask = ~0u << bit;       // the bits decided, and bit
        const unsigned n = __syncthreads_count((a & mask) == hi)
                         + __syncthreads_count((b & mask) == hi);
        if (n >= rem)
            kth = hi;
        else
            rem -= n;
    }
    return kth;
}

// tile_v/tile_g: (p, 3*n_tiles), tile_cnt: (p, n_tiles); out_v/out_g:
// (gridDim.y, p, w) lists; out_ok: (p,), written by list 0; *fallbacks
// counts the blocks that took the radix fallback. Dynamic shared memory:
// the sort buffer (SORT: 2^k >= max(n, w) keys, at most 2048; STREAM:
// SEL_CAP keys).
template <int PATH>
static __global__ void __launch_bounds__(SEL_THREADS) topw_select_kernel(
        const float* __restrict__ tile_v, const int* __restrict__ tile_g,
        const int* __restrict__ tile_cnt, int n_tiles, int w,
        float* __restrict__ out_v, int* __restrict__ out_g,
        int* __restrict__ out_ok, unsigned* __restrict__ fallbacks) {
    extern __shared__ __align__(16) unsigned long long buf[];
    __shared__ SelShared sh;

    const int c = blockIdx.x;
    const int p = gridDim.x;
    const int list = blockIdx.y;
    const bool split = gridDim.y > 1;
    const size_t col = (size_t)c * 3 * n_tiles;
    const SelList L{tile_v + col, tile_g + col,
                    split ? 3 * ((n_tiles - list + 1) / 2) : 3 * n_tiles,
                    list, split};

    int good = 1;
    if (list == 0) {
        const int* cnt = tile_cnt + (size_t)c * n_tiles;
#pragma unroll 8
        for (int t = threadIdx.x; t < n_tiles; t += SEL_THREADS)
            good &= __ldg(cnt + t) <= 3;
    }
    good = __syncthreads_and(good);

    if constexpr (PATH == SEL_SORT) {
        // every candidate, with the (-inf, 0) pads below w, in one sort
        const int sn = pow2_at_least(max(L.n, w));
        const unsigned long long pad = cand_key(-CUDART_INF_F, 0);
        for (int i = threadIdx.x; i < sn; i += SEL_THREADS)
            buf[i] = i < L.n ? L.key(i, L.score(i))
                             : (i < w ? pad : 0ull);
        bitonic_desc(buf, sn);
    } else {
        // the bound: each thread's two largest score keys are 2048
        // distinct candidates (at least w of them real, as n >= w), so the
        // w-th largest of them is at most the list's w-th largest score
        unsigned m1 = 0, m2 = 0;
        int j1 = 0;                             // where m1 lies
        auto take = [&](int j, unsigned k) {
            if (k > m1) {
                m2 = m1;
                m1 = k;
                j1 = j;
            } else {
                m2 = max(m2, k);
            }
        };
        auto skey = [&](int j) { return L.score(j); };
        sweep(L.n, skey, [&](int j, unsigned k, bool) { take(j, k); });
        const unsigned bound = block_kth(m1, m2, w);
        if (threadIdx.x == 0) sh.count = 0;
        __syncthreads();

        // slots at or past SEL_CAP are counted and not written
        auto append = [&](unsigned long long e) {
            const unsigned slot = atomicAdd(&sh.count, 1u);
            if (slot < (unsigned)SEL_CAP) buf[slot] = e;
        };
        auto at_j = [](int j, unsigned k) {
            return ((unsigned long long)k << 32) | (unsigned)j;
        };
        // the candidates at or above it into buf, as (score key, j): a
        // thread whose second largest is below the bound has one there, j1;
        // the few others read their scores again. Then j gives way to the
        // complemented lane, all lanes loaded at once.
        if (m2 >= bound) {
#pragma unroll 4
            for (int j = threadIdx.x; j < L.n; j += SEL_THREADS) {
                const unsigned k = skey(j);
                if (k >= bound) append(at_j(j, k));
            }
        } else if (m1 >= bound) {
            append(at_j(j1, m1));
        }
        __syncthreads();
        const unsigned n_above = sh.count;
        __syncthreads();
        if (n_above <= (unsigned)SEL_CAP) {
            const int sn = pow2_at_least((int)n_above);
            for (int i = threadIdx.x; i < sn; i += SEL_THREADS) {
                const unsigned long long e = buf[i];
                buf[i] = i < (int)n_above
                    ? (e & ~0xffffffffull) | L.lane_key((int)(unsigned)e)
                    : 0ull;
            }
            bitonic_desc(buf, sn);
        } else {
            // more than SEL_CAP at or above the bound (ties, -inf tiles):
            // radix passes find the w-th largest score key s, then among
            // the keys of score s the lane of the w-th largest key
            if (threadIdx.x == 0) atomicAdd(fallbacks, 1u);
            unsigned s = 0, mask = 0, rem = (unsigned)w, tied = 0;
            for (int shift = 24; shift >= 0; shift -= 8) {
                for (int i = threadIdx.x; i < 256; i += SEL_THREADS)
                    sh.hist[i] = 0;
                __syncthreads();
                sweep(L.n, skey, [&](int, unsigned k, bool in) {
                    hist_add(in && k >= bound && (k & mask) == s,
                             (k >> shift) & 255u, sh.hist);
                });
                radix_pick(sh, shift, s, rem, tied);
                mask |= 255u << shift;
            }
            unsigned lk = 0;        // complemented lane: 0 takes all tied
            if (rem < tied) {
                unsigned lmask = 0, ltied = 0;
                for (int shift = 24; shift >= 0; shift -= 8) {
                    for (int i = threadIdx.x; i < 256; i += SEL_THREADS)
                        sh.hist[i] = 0;
                    __syncthreads();
                    sweep(L.n, skey, [&](int j, unsigned k, bool in) {
                        const bool at_s = in && k == s;
                        const unsigned x = at_s ? L.lane_key(j) : 0u;
                        hist_add(at_s && (x & lmask) == lk,
                                 (x >> shift) & 255u, sh.hist);
                    });
                    radix_pick(sh, shift, lk, rem, ltied);
                    lmask |= 255u << shift;
                }
            }
            // the w keys at or above (s, lk), lanes unique
            const unsigned long long kth =
                ((unsigned long long)s << 32) | lk;
            if (threadIdx.x == 0) sh.count = 0;
            __syncthreads();
            sweep(L.n, skey, [&](int j, unsigned k, bool in) {
                if (in && k >= s) {
                    const unsigned long long key = L.key(j, k);
                    if (key >= kth) append(key);
                }
            });
            const int sn = pow2_at_least(w);
            __syncthreads();
            for (int i = w + threadIdx.x; i < sn; i += SEL_THREADS)
                buf[i] = 0ull;
            bitonic_desc(buf, sn);
        }
    }

    const size_t o = ((size_t)list * p + c) * w;
    for (int i = threadIdx.x; i < w; i += SEL_THREADS) {
        out_v[o + i] = key_value(buf[i]);
        out_g[o + i] = key_lane(buf[i]);
    }
    if (threadIdx.x == 0 && list == 0) out_ok[c] = good;
}

// The select's path for n_tiles tiles of candidates in `lists` lists (K8:
// 2, tiles alternating) and w: SEL_SORT where the longer list holds at
// most SEL_SORT_MAX or the shorter fewer than w (the bound needs w in
// every list), else SEL_STREAM; -1 for shapes the select refuses.
static int select_path(int n_tiles, int lists, int w) {
    if (n_tiles < 1 || w < 1 || w > 1024 || (lists != 1 && lists != 2))
        return -1;
    const int n_max = 3 * ((n_tiles + lists - 1) / lists);
    const int n_min = 3 * (n_tiles / lists);
    return n_max <= SEL_SORT_MAX || n_min < w ? SEL_SORT : SEL_STREAM;
}

// Launches the select on `st`, one block per (column, list), by
// select_path. lists: 1 (K1) or 2 (K8).
static cudaError_t launch_topw_select(
        const float* tile_v, const int* tile_g, const int* tile_cnt,
        int n_tiles, int p, int lists, int w, float* out_v, int* out_g,
        int* out_ok, unsigned* fallbacks, cudaStream_t st) {
    const int path = select_path(n_tiles, lists, w);
    if (p < 1 || path < 0) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)p, (unsigned)lists);
    const size_t key = sizeof(unsigned long long);
    if (path == SEL_SORT) {
        // the longer list or w keys: at most 1026 (select_path), so the
        // buffer holds at most 2048
        const int n_sort = 3 * ((n_tiles + lists - 1) / lists);
        topw_select_kernel<SEL_SORT><<<
            grid, SEL_THREADS, key * pow2_at_least(n_sort > w ? n_sort : w),
            st>>>(tile_v, tile_g, tile_cnt, n_tiles, w, out_v, out_g, out_ok,
                  fallbacks);
    } else {
        topw_select_kernel<SEL_STREAM><<<grid, SEL_THREADS, key * SEL_CAP,
                                         st>>>(
            tile_v, tile_g, tile_cnt, n_tiles, w, out_v, out_g, out_ok,
            fallbacks);
    }
    return cudaGetLastError();
}

}  // namespace kgt
