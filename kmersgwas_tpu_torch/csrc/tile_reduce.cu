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
// One warp per (column, tile): it stages the tile in shared memory with
// 16-byte loads, then every plane is a warp reduction over the staged lanes
// (shuffles, __reduce_*_sync); the fold runs in place in shared memory,
// last.
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
// bound by those bytes. tile_topc moves 160 KB at the probe's shape and
// makes NT^2 comparisons per column out of shared memory (16 K at NT 128,
// one pass of 128 broadcast reads per thread): bound by the launch and one
// block's latency, not by bytes.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace kgt {

constexpr int kRedWarps = 4;            // warps (tiles) per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTopcTiles = 2048;        // tile_topc: NT <= 2048
constexpr int kTopcThreads = 1024;

__device__ __forceinline__ void take_first_max(float& bv, int& bi, float v,
                                               int i) {
    if (v > bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
    }
}

__global__ void __launch_bounds__(32 * kRedWarps) tile_reduce_kernel(
        const float* __restrict__ x, const float* __restrict__ th, int p,
        int nt, int tr, int fold_to, float* __restrict__ m1,
        int* __restrict__ a1, int* __restrict__ a1_fold,
        float* __restrict__ m2, int* __restrict__ a2_sum,
        int* __restrict__ n_eq, int* __restrict__ cnt) {
    extern __shared__ __align__(16) float red_smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long o = (long long)blockIdx.x * kRedWarps + warp;
    if (o >= (long long)p * nt) return;          // the whole warp leaves
    const bool fold = a1_fold != nullptr;
    float* v = red_smem + (size_t)warp * tr * (fold ? 2 : 1);
    int* ix = reinterpret_cast<int*>(v + tr);

    // tile (c, t) is x[c][t*tr : (t+1)*tr], i.e. x + o*tr
    const float4* src = reinterpret_cast<const float4*>(x + o * tr);
    for (int k = lane; k < tr / 4; k += 32)
        reinterpret_cast<float4*>(v)[k] = src[k];
    __syncwarp();

    float mx = -CUDART_INF_F;
    int am = INT_MAX;
    for (int k = lane; k < tr; k += 32) take_first_max(mx, am, v[k], k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, mx, off);
        const int oi = __shfl_xor_sync(kFull, am, off);
        take_first_max(mx, am, ov, oi);
    }
    if (n_eq != nullptr || cnt != nullptr) {
        const float t_c = cnt != nullptr ? th[o / nt] : 0.f;
        int ne = 0, nc = 0;
        for (int k = lane; k < tr; k += 32) {
            ne += v[k] == mx;
            nc += v[k] > t_c;
        }
        ne = __reduce_add_sync(kFull, ne);
        nc = __reduce_add_sync(kFull, nc);
        if (lane == 0 && n_eq != nullptr) n_eq[o] = ne;
        if (lane == 0 && cnt != nullptr) cnt[o] = nc;
    }
    if (m2 != nullptr || a2_sum != nullptr) {
        float mx2 = -CUDART_INF_F;
        for (int k = lane; k < tr; k += 32) {
            const float a = k == am ? -CUDART_INF_F : v[k];
            mx2 = a > mx2 ? a : mx2;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(kFull, mx2, off);
            mx2 = ov > mx2 ? ov : mx2;
        }
        int sum = 0;
        for (int k = lane; k < tr; k += 32) {
            const float a = k == am ? -CUDART_INF_F : v[k];
            sum += a == mx2 ? k : 0;
        }
        sum = __reduce_add_sync(kFull, sum);
        if (lane == 0 && m2 != nullptr) m2[o] = mx2;
        if (lane == 0 && a2_sum != nullptr) a2_sum[o] = sum;
    }
    if (lane == 0 && m1 != nullptr) m1[o] = mx;
    if (lane == 0 && a1 != nullptr) a1[o] = am;
    if (fold) {
        __syncwarp();                   // every pass above has read v
        int width = tr;
        bool first = true;              // ix is written by the first stage
        while (width > fold_to) {
            const int half = width >> 1;
            for (int j = lane; j < half; j += 32) {
                const float l = v[j], r = v[j + half];
                const int li = first ? j : ix[j];
                const int ri = first ? j + half : ix[j + half];
                const bool keep = l >= r;
                v[j] = keep ? l : r;
                ix[j] = keep ? li : ri;
            }
            __syncwarp();
            width = half;
            first = false;
        }
        int best = INT_MAX;
        for (int j = lane; j < width; j += 32) {
            const int i = first ? j : ix[j];
            if (v[j] == mx && i < best) best = i;
        }
        best = __reduce_min_sync(kFull, best);
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
    const size_t smem = sizeof(float) * kRedWarps * (size_t)tr
                      * (a1_fold != nullptr ? 2 : 1);
    cudaError_t e = cudaFuncSetAttribute(
        tile_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long warps = (long long)p * nt;
    tile_reduce_kernel<<<(unsigned)((warps + kRedWarps - 1) / kRedWarps),
                         32 * kRedWarps, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        x, th, p, nt, tr, fold_to, m1, a1, a1_fold, m2, a2_sum, n_eq, cnt);
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
