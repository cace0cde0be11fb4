// tile_reduce and tile_topc: the per-(column, tile) reductions of the
// tile-reduction probes on Hopper (sm_90a).
//
// Replaces the kernels of tools/exp_kernel.py (k_fold_store :54 ...
// k_t4 :645, reached from run :33 ... runN :508): each reads one
// (P_PAD, TR) tile of an f32 plane x of (P, NT*TR) per grid step and
// stores per-column reductions into (P, NT) planes; and k_topc (:689), a
// running sorted insert of each tile's maximum across the grid steps.
//
// tile_reduce(x, th, fold_to): for column c and tile t, with s the tile's
// TR lanes, the (P, NT) planes whose pointers are not null:
//   m1       max s;
//   a1       the lowest lane holding m1;
//   a1_fold  the lane that wins the halving fold of k_vi_fold (:86-95):
//            while width > fold_to, lane j keeps the left half's value and
//            lane where left >= right (j against j + width/2); then the
//            lowest surviving lane index at the max (k_vi_hybrid, :218-230,
//            folds to 128; fold_to >= TR gives a1);
//   m2       max of s with lane a1 set to -inf (the 2nd of a descending
//            sort);
//   a2_sum   the sum of the lanes l with s2[l] == m2, s2 that masked s
//            (k_top2's sum-encoded lane, :568);
//   n_eq     #{l : s[l] == m1} (k_t1);
//   cnt      #{l : s[l] > th[c]}.
// One warp per (column, tile), all from registers: lane l loads the
// float4s l + 32 i of its tile (TR / 128 of them, all issued before any is
// used), so element e of the tile sits in lane (e / 4) mod 32, register
// slot e / 128, component e mod 4. Every order-free plane is a per-lane
// partial merged across the warp:
//   pass 1: each lane's max (and its count above th[c]); m1 is the warp's
//           max of them (5 shuffle stages);
//   pass 2: over the same registers, each lane's count, lowest lane and
//           lane sum at m1, and its largest value below m1; n_eq, a1 and
//           the sum meet by __reduce_*_sync, the second distinct value by
//           5 more shuffle stages;
//   m2     = m1 if n_eq >= 2, else the second distinct value;
//   a2_sum = the sum at m1 less a1 if n_eq >= 2, else (pass 3, only then)
//            the sum of the lanes at the second value; plus a1 when m2 is
//            -inf, where lane a1's mask ties.
// (A single pass of partials relative to each lane's own top, v1 / v2 /
// their counts and sums, took about twice the instructions an element,
// and the seven planes are bound by issue, not latency.)
// The halving fold runs in the same layout: a stage of half h >= 128 pairs
// register slots of one lane, h in {64, ..., 4} pairs lane l with lane
// l + h / 4 (a shuffle), h in {2, 1} pairs components of one float4; then
// the lowest surviving lane at m1. At TR = 4096 the fold's first stage
// runs as the second half's float4s arrive, so no lane holds 128 floats;
// pass 2 then reads the tile again (from L2). The plane set and TR / 128
// are template parameters: a launch computes what its planes need and
// nothing else. TR < 128 leaves lanes l >= TR / 4 idle.
//
// tile_topc(m1): per column, NT inserts in tile order into a list of NT
// slots that starts at (-inf, 0): the rank of tile t's max is the number of
// slots holding a value >= it (so the earlier tile stays first on ties),
// the slots past the rank shift down by one, and a max whose rank is NT
// (a -inf one) is dropped, as k_topc's :706-714. The result is a stable
// descending sort of the maxima that are not -inf, padded with (-inf, 0):
// tile t lands in slot #{s : m_s > m_t} + #{s < t : m_s == m_t}. So the
// kernel has no chain of inserts: one block per column stages the column
// in shared memory, each thread counts the rank of one or two tiles and
// stores its (value, tile) straight to its slot, and the slots past the
// count of such maxima get (-inf, 0).
//
// What bounds them. tile_reduce reads x once (109 MB at P_PAD 104, NT 128,
// TR 2048: 0.033 ms at 3.35 TB/s) and writes 4 B per plane entry; it is
// bound by those bytes while the loads stay in flight (~8 KB a warp at TR
// 2048) and the passes over the registers, a few instructions an element,
// issue under them: m1 alone costs one FMNMX an element, all seven planes
// come near the issue limit, so pass 3 runs only where one lane holds the
// max. tile_topc moves 160 KB at the probe's shape and makes NT^2
// comparisons per column out of shared memory (16 K at NT 128, one pass
// of 128 broadcast reads per thread): bound by the launch and one block's
// latency, not by bytes.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace kgt {

constexpr int kRedWarps = 4;            // warps (tiles) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTopcTiles = 2048;        // tile_topc: NT <= 2048
constexpr int kTopcThreads = 1024;

// what a tile_reduce launch computes beyond m1 (TIES): 1 adds a1 and n_eq
// (also the fold's a1 when fold_to >= TR), 2 adds m2 and a2_sum
constexpr int kTiesNone = 0, kTiesFirst = 1, kTiesSecond = 2;

// pass 1 over one float4: the lane's max and its count above t
template <bool CNT>
__device__ __forceinline__ void pass1(float& mx, int& c, float4 v, float t) {
    mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
    if constexpr (CNT) c += (v.x > t) + (v.y > t) + (v.z > t) + (v.w > t);
}

// pass 2 over one element x at lane e (increasing e): at the warp's top,
// the lane's count n, lowest lane a and lane sum s; below it, the lane's
// largest value `below`
template <int TIES>
__device__ __forceinline__ void pass2(int& n, int& a, int& s, float& below,
                                      float x, int e, float top) {
    const bool eq = x == top;
    n += eq;
    a = min(a, eq ? e : INT_MAX);
    if constexpr (TIES == kTiesSecond) {
        s += eq ? e : 0;
        below = fmaxf(below, eq ? -CUDART_INF_F : x);
    }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

// the fold's pairs: keep the left value and lane where left >= right
__device__ __forceinline__ void keep_left(float& l, int& li, float r,
                                          int ri) {
    const bool keep = l >= r;
    l = keep ? l : r;
    li = keep ? li : ri;
}

__device__ __forceinline__ void keep_left4(float4& l, int4& li, float4 r,
                                           int4 ri) {
    keep_left(l.x, li.x, r.x, ri.x);
    keep_left(l.y, li.y, r.y, ri.y);
    keep_left(l.z, li.z, r.z, ri.z);
    keep_left(l.w, li.w, r.w, ri.w);
}

// the fold's register stages, H slots apart, then H / 2, ... 1 (template
// recursion: every slot index is a constant, so v and ix stay registers)
template <int H>
__device__ __forceinline__ void fold_slots(float4* v, int4* ix, int& width,
                                           int fold_to) {
    if constexpr (H >= 1) {
        if (width > fold_to) {
#pragma unroll
            for (int i = 0; i < H; ++i)
                keep_left4(v[i], ix[i], v[i + H], ix[i + H]);
            width >>= 1;
        }
        fold_slots<H / 2>(v, ix, width, fold_to);
    }
}

// NV = max(1, TR / 128) float4s a lane; FOLD: a1_fold; TIES and CNT as
// above (FOLD needs TIES >= kTiesFirst)
template <int NV, bool FOLD, int TIES, bool CNT>
__global__ void __launch_bounds__(32 * kRedWarps) tile_reduce_kernel(
        const float* __restrict__ x, const float* __restrict__ th, int p,
        int nt, int tr, int fold_to, float* __restrict__ m1,
        int* __restrict__ a1, int* __restrict__ a1_fold,
        float* __restrict__ m2, int* __restrict__ a2_sum,
        int* __restrict__ n_eq, int* __restrict__ cnt) {
    static_assert(!FOLD || TIES >= kTiesFirst, "the fold needs a1");
    // slots held at once: at NV = 32 the second half folds as it arrives
    constexpr int NH = NV > 16 ? NV / 2 : NV;
    const int lane = threadIdx.x & 31;
    const long long o = (long long)blockIdx.x * kRedWarps
                      + (threadIdx.x >> 5);
    if (o >= (long long)p * nt) return;          // the whole warp leaves
    const float t_c = CNT ? th[o / nt] : 0.f;
    // tile (c, t) is x[c][t*tr : (t+1)*tr], i.e. x + o*tr
    const float4* src = reinterpret_cast<const float4*>(x + o * tr) + lane;
    const bool active = 4 * lane < tr;           // false only for TR < 128
    const int e0 = 4 * lane;                     // lane of slot 0, comp 0

    float4 v[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i)
        v[i] = active ? __ldcs(src + 32 * i)
                      : make_float4(-CUDART_INF_F, -CUDART_INF_F,
                                    -CUDART_INF_F, -CUDART_INF_F);
    float mx = -CUDART_INF_F;
    int c_above = 0;
#pragma unroll
    for (int i = 0; i < NH; ++i) pass1<CNT>(mx, c_above, v[i], t_c);
    int width = tr;                              // the fold's live lanes
    int4 ix[FOLD ? NH : 1];                      // the fold's lane indices
    if constexpr (FOLD) {
#pragma unroll
        for (int i = 0; i < NH; ++i)
            ix[i] = make_int4(e0 + 128 * i, e0 + 128 * i + 1,
                              e0 + 128 * i + 2, e0 + 128 * i + 3);
    }
    if constexpr (NV > NH) {
        // the second half: pass 1 over each float4, and fold it into slot
        // i at once (the fold's first stage, half 64 * NV) when the fold
        // runs
        const bool fold1 = FOLD && width > fold_to;
#pragma unroll
        for (int i = 0; i < NH; ++i) {
            const float4 w = __ldcs(src + 32 * (NH + i));
            pass1<CNT>(mx, c_above, w, t_c);
            if constexpr (FOLD) {
                const int e = e0 + 128 * (NH + i);
                if (fold1)
                    keep_left4(v[i], ix[i], w,
                               make_int4(e, e + 1, e + 2, e + 3));
            }
        }
        if (fold1) width >>= 1;
    }

    // the warp's planes
    const float top = warp_max(mx);
    int n_top = 0, a_top = INT_MAX;
    if constexpr (TIES >= kTiesFirst) {
        int n = 0, a = INT_MAX, s = 0;
        float below = -CUDART_INF_F;
        if (active) {
#pragma unroll
            for (int i = 0; i < NV; ++i) {
                // slot i from registers, or again from memory at NV = 32
                const float4 w = NV > NH ? __ldg(src + 32 * i) : v[i % NH];
                const int e = e0 + 128 * i;
                pass2<TIES>(n, a, s, below, w.x, e, top);
                pass2<TIES>(n, a, s, below, w.y, e + 1, top);
                pass2<TIES>(n, a, s, below, w.z, e + 2, top);
                pass2<TIES>(n, a, s, below, w.w, e + 3, top);
            }
        }
        n_top = __reduce_add_sync(kFull, n);
        a_top = __reduce_min_sync(kFull, a);
        if constexpr (TIES == kTiesSecond) {
            const int s_top = __reduce_add_sync(kFull, s);
            const float second = warp_max(below);
            const float m2v = n_top >= 2 ? top : second;
            int a2v;
            if (n_top >= 2) {
                a2v = s_top - a_top;
            } else {
                // pass 3: the lanes at the second value
                int s2 = 0;
                if (active) {
#pragma unroll
                    for (int i = 0; i < NV; ++i) {
                        const float4 w = NV > NH ? __ldg(src + 32 * i)
                                                 : v[i % NH];
                        const int e = e0 + 128 * i;
                        s2 += (w.x == second ? e : 0)
                            + (w.y == second ? e + 1 : 0)
                            + (w.z == second ? e + 2 : 0)
                            + (w.w == second ? e + 3 : 0);
                    }
                }
                a2v = __reduce_add_sync(kFull, s2);
            }
            a2v += m2v == -CUDART_INF_F ? a_top : 0;
            if (lane == 0 && m2 != nullptr) m2[o] = m2v;
            if (lane == 0 && a2_sum != nullptr) a2_sum[o] = a2v;
        }
        if (lane == 0 && a1 != nullptr) a1[o] = a_top;
        if (lane == 0 && n_eq != nullptr) n_eq[o] = n_top;
    }
    if constexpr (CNT) {
        const int nc = __reduce_add_sync(kFull, c_above);
        if (lane == 0) cnt[o] = nc;
    }
    if (lane == 0 && m1 != nullptr) m1[o] = top;

    if constexpr (FOLD) {
        fold_slots<NH / 2>(v, ix, width, fold_to);
        // lane stages (width 128 ... 8): lane l against lane l + width / 8
#pragma unroll
        for (int d = 16; d >= 1; d >>= 1) {
            if (width == 8 * d && width > fold_to) {
                float4 r;
                int4 ri;
                r.x = __shfl_down_sync(kFull, v[0].x, d);
                r.y = __shfl_down_sync(kFull, v[0].y, d);
                r.z = __shfl_down_sync(kFull, v[0].z, d);
                r.w = __shfl_down_sync(kFull, v[0].w, d);
                ri.x = __shfl_down_sync(kFull, ix[0].x, d);
                ri.y = __shfl_down_sync(kFull, ix[0].y, d);
                ri.z = __shfl_down_sync(kFull, ix[0].z, d);
                ri.w = __shfl_down_sync(kFull, ix[0].w, d);
                keep_left4(v[0], ix[0], r, ri);
                width >>= 1;
            }
        }
        // component stages (width 4, 2): components c against c + width/2
        if (width == 4 && width > fold_to) {
            keep_left(v[0].x, ix[0].x, v[0].z, ix[0].z);
            keep_left(v[0].y, ix[0].y, v[0].w, ix[0].w);
            width = 2;
        }
        if (width == 2 && width > fold_to) {
            keep_left(v[0].x, ix[0].x, v[0].y, ix[0].y);
            width = 1;
        }
        // the lowest surviving lane at m1; positions 128 i + 4 l + c
        // below width survive (every position when nothing folded: a1)
        int best = INT_MAX;
        if (width >= tr) {
            best = a_top;
        } else {
#pragma unroll
            for (int i = 0; i < NH; ++i) {
                const int q = 128 * i + e0;
                if (q + 0 < width && v[i].x == top) best = min(best, ix[i].x);
                if (q + 1 < width && v[i].y == top) best = min(best, ix[i].y);
                if (q + 2 < width && v[i].z == top) best = min(best, ix[i].z);
                if (q + 3 < width && v[i].w == top) best = min(best, ix[i].w);
            }
            best = __reduce_min_sync(kFull, best);
        }
        if (lane == 0) a1_fold[o] = best;
    }
}

// One block per column, one or two tiles per thread: tile t's slot is
// its stable descending rank over the column staged in shared memory.
__global__ void __launch_bounds__(kTopcThreads) tile_topc_kernel(
        const float* __restrict__ m1, int nt, float* __restrict__ out_v,
        int* __restrict__ out_i) {
    __shared__ float mcol[kTopcTiles];
    const size_t c0 = (size_t)blockIdx.x * nt;
    for (int k = threadIdx.x; k < nt; k += blockDim.x) mcol[k] = m1[c0 + k];
    __syncthreads();
    int n_fin = 0;                      // maxima that are not -inf
    for (int t = threadIdx.x; t - (int)threadIdx.x < nt; t += blockDim.x) {
        const bool fin = t < nt && mcol[t] != -CUDART_INF_F;
        n_fin += __syncthreads_count(fin);
        if (!fin) continue;
        const float mv = mcol[t];
        int rank = 0;
        for (int s = 0; s < nt; ++s) {
            const float o = mcol[s];
            rank += (o > mv) | ((o == mv) & (s < t));
        }
        out_v[c0 + rank] = mv;
        out_i[c0 + rank] = t;
    }
    for (int k = n_fin + threadIdx.x; k < nt; k += blockDim.x) {
        out_v[c0 + k] = -CUDART_INF_F;
        out_i[c0 + k] = 0;
    }
}

}  // namespace kgt

namespace kgt {

struct ReduceArgs {
    const float* x;
    const float* th;
    int p, nt, tr, fold_to;
    float* m1;
    int* a1;
    int* a1_fold;
    float* m2;
    int* a2_sum;
    int* n_eq;
    int* cnt;
};

template <int NV, bool FOLD, int TIES, bool CNT>
void launch_reduce(const ReduceArgs& a, cudaStream_t st) {
    const long long warps = (long long)a.p * a.nt;
    tile_reduce_kernel<NV, FOLD, TIES, CNT>
        <<<(unsigned)((warps + kRedWarps - 1) / kRedWarps), 32 * kRedWarps,
           0, st>>>(a.x, a.th, a.p, a.nt, a.tr, a.fold_to, a.m1, a.a1,
                    a.a1_fold, a.m2, a.a2_sum, a.n_eq, a.cnt);
}

// the instance for the requested planes
template <int NV>
void dispatch_reduce(const ReduceArgs& a, cudaStream_t st) {
    const bool fold = a.a1_fold != nullptr;
    const bool cnt = a.cnt != nullptr;
    const int ties = (a.m2 != nullptr || a.a2_sum != nullptr) ? kTiesSecond
                   : (a.a1 != nullptr || a.n_eq != nullptr || fold)
                   ? kTiesFirst : kTiesNone;
#define KGT_REDUCE(F, T)                                                     \
    (cnt ? launch_reduce<NV, F, T, true>(a, st)                              \
         : launch_reduce<NV, F, T, false>(a, st))
    if (fold && ties == kTiesSecond) KGT_REDUCE(true, kTiesSecond);
    else if (fold) KGT_REDUCE(true, kTiesFirst);
    else if (ties == kTiesSecond) KGT_REDUCE(false, kTiesSecond);
    else if (ties == kTiesFirst) KGT_REDUCE(false, kTiesFirst);
    else KGT_REDUCE(false, kTiesNone);
#undef KGT_REDUCE
}

}  // namespace kgt

// x: (p, nt*tr) f32, 16-byte aligned; th: (p,) f32 (read only for cnt);
// tr a power of two in [4, 4096]; null plane pointers are skipped.
extern "C" int kgt_tile_reduce(const float* x, const float* th, int p, int nt,
                               int tr, int fold_to, float* m1, int* a1,
                               int* a1_fold, float* m2, int* a2_sum,
                               int* n_eq, int* cnt, void* stream) {
    using namespace kgt;
    if (p <= 0 || nt <= 0 || tr < 4 || tr > 4096 || (tr & (tr - 1))
            || fold_to < 1)
        return (int)cudaErrorInvalidValue;
    const ReduceArgs a{x, th, p, nt, tr, fold_to, m1, a1, a1_fold, m2,
                       a2_sum, n_eq, cnt};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (tr <= 128 ? 1 : tr / 128) {
        case 1: dispatch_reduce<1>(a, st); break;
        case 2: dispatch_reduce<2>(a, st); break;
        case 4: dispatch_reduce<4>(a, st); break;
        case 8: dispatch_reduce<8>(a, st); break;
        case 16: dispatch_reduce<16>(a, st); break;
        default: dispatch_reduce<32>(a, st); break;
    }
    return (int)cudaGetLastError();
}

// m1: (p, nt) f32 with nt <= 2048; out_v/out_i: (p, nt).
extern "C" int kgt_tile_topc(const float* m1, int p, int nt, float* out_v,
                             int* out_i, void* stream) {
    using namespace kgt;
    if (p <= 0 || nt <= 0 || nt > kTopcTiles)
        return (int)cudaErrorInvalidValue;
    const int threads = nt < kTopcThreads ? (nt + 31) / 32 * 32
                                          : kTopcThreads;
    tile_topc_kernel<<<p, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        m1, nt, out_v, out_i);
    return (int)cudaGetLastError();
}
