// Tensor-core tile body of the port's score kernels on Hopper (sm_90a):
// K1's tile launch (score_topw.cu, also run by K8's score_parity.cu), K3
// (score_tilemax.cu), and K2, K4 and K5 (score_plane.cu).
//
// One block scores one TILE_ROWS-row tile of k-mers against one chunk of NC
// phenotype columns (NC = 8 * N8 <= 128, a multiple of 8: P = 101 runs as
// 104), as the (128 x N_pad) x (N_pad x NC) product
//
//     yigi[row][c] = sum over samples k of bit[row][k] * y[k][c]
//
// on the tensor cores, then writes the tile's f32 scores to shared memory
// for the caller's epilogue: column-major with `score_epilogue` (-inf on
// padding rows) for per-column reductions (tile_top3.cuh) and the score
// plane's bulk stores (K2, K4), or row-major with `score_value` (no padding
// mask) for K5's row-major stores (score_plane.cu).
//
// Roles. 288 threads: warpgroups 0 and 1 are consumers and own rows 0-63 and
// 64-127 of the tile; warp 8 is the producer.
//   A (the 0/1 presence bits) never exists as bf16 outside registers: each
//     consumer thread loads its two rows' packed words straight from device
//     memory (8 bytes per row per stage, one stage ahead) and builds its
//     `wgmma` A fragments (m64 x k16, bf16) from them. Lane t of a warp holds
//     rows t/4 and t/4 + 8 of the warp's 16 and samples 2(t%4), +1, +8, +9 of
//     the k16 step: a set bit becomes 0x3F80 (bf16 1.0), a clear bit 0. One
//     32-bit word covers two k16 steps.
//   B (y as bf16) comes from shared memory. The wrapper writes it once per
//     call (ops/score.wgmma_operand) in the layout the descriptor reads: per
//     (column chunk, stage of KC samples, plane) one contiguous block of 8x8
//     core matrices (8 columns x 8 samples, 16 bytes per column), 8 samples
//     apart by 128 bytes (the descriptor's LBO) and 8 columns apart by 1024
//     (SBO), no swizzle. The producer streams the stages into a ring with one
//     bulk copy each (cp.async.bulk, completion on an mbarrier); the
//     consumers release a stage once the products that read it are done.
//   Per stage a consumer warpgroup builds the A fragments of its four k16
//     steps, issues their products as one group (one group per step for
//     chunks of 128 columns, see wgmma_k_loop) and waits for it
//     before it releases the stage and builds the next fragments; meanwhile
//     the block's other warpgroup and the SM's other block keep the tensor
//     cores busy. Overlapping within a warpgroup is not safe: the products read A
//     from registers until they retire, ptxas does not keep those registers
//     (with wait_group 1 it either serialized the products, warning C7513,
//     or, not seeing the hazard, let the next fragments overwrite them).
//
// Precision. "default": one bf16 plane, bf16(y). "highest": three planes,
// hi = bf16(y), mid = bf16(y - hi), lo = bf16(y - hi - mid), which sum to y
// exactly; each k16 step runs one product per plane into the same f32
// accumulator. The 0/1 x bf16 products are exact, so the only differences
// from a plain f32 sum are the order of the additions and the tensor core's
// adder. On dyadic phenotypes (multiples of 1/8, |yigi| <= 8064) every
// partial sum is exact and the scores are bit-equal to the plain version.
//
// Registers. The 128-column chunk sits at the cap of two blocks an SM (96
// registers): each kernel's ptxas lines are checked for spills and
// serialized products (chip_smoke.py phase 1); score_plane.cu caps its
// kernel with __maxnreg__(96) where the launch bound made ptxas serialize.
//
// Shared memory: max(ring, score tile) + the ring's mbarriers. The score
// tile reuses the ring once every product is done. Column-major it is NC
// columns x S_LD floats; S_LD = 132 makes the accumulator stores and the
// column reads conflict-free. Row-major it is 128 rows x row_ld(NC) floats,
// a stride that is an odd multiple of 8: the 8-byte stores of a half-warp
// (4 rows x 4 column pairs) then cover the 32 banks once, and the
// epilogue's reads, 32 consecutive floats of a row, are conflict-free (at
// NC = 128 the tile is 68 KB, under the 96 KB ring budget, so two blocks
// still fit an SM).
#pragma once

#include <cstdint>
#include <type_traits>

#include "hopper_async.cuh"
#include "tile_top3.cuh"

namespace kgt {

constexpr int WG_THREADS = 288;     // 2 consumer warpgroups + 1 producer warp
constexpr int WG_CONSUMERS = 256;
constexpr int KC = 64;              // samples per ring stage (2 packed words)
constexpr int S_LD = TILE_ROWS + 4;
constexpr int RING_BUDGET = 96 * 1024;

// Row stride of the row-major score tile of nc columns: the smallest odd
// multiple of 8 that holds them.
__host__ __device__ constexpr int row_ld(int nc) { return nc | 8; }

// Floats of the score tile of nc columns, row-major (ROWS) or column-major.
__host__ __device__ constexpr int tile_floats(int nc, bool rows) {
    return rows ? TILE_ROWS * row_ld(nc) : nc * S_LD;
}

// --------------------------------------------------------------- wgmma
// wgmma.mma_async m64n(8*N8)k16, f32 += bf16 x bf16, A from registers, B
// K-major from shared memory. Operands %0 to %(4*N8 - 1) are the
// accumulators (four per 8 columns: row t/4, columns 2(t%4) and +1; row
// t/4 + 8, the same columns), then the A fragment, the B descriptor and
// scale-d; KGT_WGMMA names the numbers of the last three.
#define KGT_C0 "%0, %1, %2, %3"
#define KGT_C1 ", %4, %5, %6, %7"
#define KGT_C2 ", %8, %9, %10, %11"
#define KGT_C3 ", %12, %13, %14, %15"
#define KGT_C4 ", %16, %17, %18, %19"
#define KGT_C5 ", %20, %21, %22, %23"
#define KGT_C6 ", %24, %25, %26, %27"
#define KGT_C7 ", %28, %29, %30, %31"
#define KGT_C8 ", %32, %33, %34, %35"
#define KGT_C9 ", %36, %37, %38, %39"
#define KGT_C10 ", %40, %41, %42, %43"
#define KGT_C11 ", %44, %45, %46, %47"
#define KGT_C12 ", %48, %49, %50, %51"
#define KGT_C13 ", %52, %53, %54, %55"
#define KGT_C14 ", %56, %57, %58, %59"
#define KGT_C15 ", %60, %61, %62, %63"
#define KGT_L1 KGT_C0
#define KGT_L2 KGT_L1 KGT_C1
#define KGT_L3 KGT_L2 KGT_C2
#define KGT_L4 KGT_L3 KGT_C3
#define KGT_L5 KGT_L4 KGT_C4
#define KGT_L6 KGT_L5 KGT_C5
#define KGT_L7 KGT_L6 KGT_C6
#define KGT_L8 KGT_L7 KGT_C7
#define KGT_L9 KGT_L8 KGT_C8
#define KGT_L10 KGT_L9 KGT_C9
#define KGT_L11 KGT_L10 KGT_C10
#define KGT_L12 KGT_L11 KGT_C11
#define KGT_L13 KGT_L12 KGT_C12
#define KGT_L14 KGT_L13 KGT_C13
#define KGT_L15 KGT_L14 KGT_C14
#define KGT_L16 KGT_L15 KGT_C15
#define KGT_F(j) "+f"(d[4 * (j)]), "+f"(d[4 * (j) + 1]), \
                 "+f"(d[4 * (j) + 2]), "+f"(d[4 * (j) + 3])
#define KGT_O1 KGT_F(0)
#define KGT_O2 KGT_O1, KGT_F(1)
#define KGT_O3 KGT_O2, KGT_F(2)
#define KGT_O4 KGT_O3, KGT_F(3)
#define KGT_O5 KGT_O4, KGT_F(4)
#define KGT_O6 KGT_O5, KGT_F(5)
#define KGT_O7 KGT_O6, KGT_F(6)
#define KGT_O8 KGT_O7, KGT_F(7)
#define KGT_O9 KGT_O8, KGT_F(8)
#define KGT_O10 KGT_O9, KGT_F(9)
#define KGT_O11 KGT_O10, KGT_F(10)
#define KGT_O12 KGT_O11, KGT_F(11)
#define KGT_O13 KGT_O12, KGT_F(12)
#define KGT_O14 KGT_O13, KGT_F(13)
#define KGT_O15 KGT_O14, KGT_F(14)
#define KGT_O16 KGT_O15, KGT_F(15)

template <int N8> struct Wgmma;

#define KGT_WGMMA(N8, N, A, DESC, SCALE)                                      \
    template <> struct Wgmma<N8> {                                           \
        static __device__ __forceinline__ void mma(                          \
                float (&d)[4 * N8], const uint32_t (&a)[4], uint64_t desc,   \
                uint32_t scale_d) {                                          \
            asm volatile(                                                    \
                "{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"            \
                "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                KGT_L##N8 "}, {" A "}, " DESC ", p, 1, 1, 0;\n}\n"           \
                : KGT_O##N8                                                  \
                : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),     \
                  "r"(scale_d));                                             \
        }                                                                    \
    };

// the column chunks the kernels are built for (ops/_cuda.WGMMA_CHUNKS)
KGT_WGMMA(1, 8, "%4, %5, %6, %7", "%8", "%9")
KGT_WGMMA(2, 16, "%8, %9, %10, %11", "%12", "%13")
KGT_WGMMA(4, 32, "%16, %17, %18, %19", "%20", "%21")
KGT_WGMMA(8, 64, "%32, %33, %34, %35", "%36", "%37")
KGT_WGMMA(13, 104, "%52, %53, %54, %55", "%56", "%57")
KGT_WGMMA(16, 128, "%64, %65, %66, %67", "%68", "%69")

template <class F>
inline cudaError_t dispatch_chunk(int nc, F&& f) {
    switch (nc) {
        case 8: return f(std::integral_constant<int, 1>{});
        case 16: return f(std::integral_constant<int, 2>{});
        case 32: return f(std::integral_constant<int, 4>{});
        case 64: return f(std::integral_constant<int, 8>{});
        case 104: return f(std::integral_constant<int, 13>{});
        case 128: return f(std::integral_constant<int, 16>{});
        default: return cudaErrorInvalidValue;
    }
}

// Two presence bits (bits 0 and 1 of x) -> two bf16 (low half: bit 0).
__device__ __forceinline__ uint32_t bits_bf16x2(uint32_t x) {
    return ((x & 1u) | ((x & 2u) << 15)) * 0x3F80u;
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from shared to global memory, tracked by this thread's bulk groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
}

// ----------------------------------------------------------------- shape

struct WgmmaShape {
    int stages;                 // ring depth
    uint32_t stage_bytes;       // planes x KC x NC bf16
    size_t ring_bytes, smem_bytes;
};

inline WgmmaShape wgmma_shape(int nc, int planes, bool rows = false) {
    WgmmaShape s;
    s.stage_bytes = (uint32_t)(planes * KC * nc * 2);
    s.stages = (int)(RING_BUDGET / s.stage_bytes);
    s.stages = s.stages < 2 ? 2 : (s.stages > 4 ? 4 : s.stages);
    s.ring_bytes = (size_t)s.stages * s.stage_bytes;
    const size_t tile = sizeof(float) * tile_floats(nc, rows);
    s.smem_bytes = (s.ring_bytes > tile ? s.ring_bytes : tile)
                 + 2 * sizeof(uint64_t) * s.stages;
    return s;
}

// Dynamic shared memory of kernel `k` for `shape`; a refusal is returned
// as the launch's error.
template <class K>
inline cudaError_t wgmma_smem(K k, const WgmmaShape& shape) {
    return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)shape.smem_bytes);
}

// ------------------------------------------------------------------ body

// The k loop of one consumer thread: rows pa and pb (packed words), the
// ring's stages as the producer fills them.
template <int N8, int PLANES>
__device__ __forceinline__ void wgmma_k_loop(
        const uint2* __restrict__ pa, const uint2* __restrict__ pb,
        int n_kc, int stages, uint32_t stage_bytes, unsigned char* ring,
        uint64_t* full, uint64_t* empty, float (&acc)[4 * N8]) {
    // Registers. A product group's A fragments (4 registers per k16 step)
    // stay live until its products retire, beside the 4 * N8 accumulators,
    // under ptxas's cap of 96 for two blocks an SM. Chunks up to 104
    // columns issue a stage's four steps as one group and load the next
    // stage's packed words ahead. At 128 columns that spilled and ptxas
    // serialized the products (C7512), so the widest chunk issues one step
    // per group and loads a stage's words when the stage starts (94
    // registers, no spills; the fastest of the variants timed on the card).
    constexpr bool WIDE = N8 >= 16;
    constexpr int KG = WIDE ? 1 : 4;
    const int lane = threadIdx.x & 31;
    const int shift = 2 * (lane & 3);
    const uint32_t plane_bytes = stage_bytes / PLANES;
    uint2 wa = __ldg(pa), wb = __ldg(pb);
    for (int kc = 0; kc < n_kc; ++kc) {
        uint2 na = wa, nb = wb;
        if (WIDE) {
            wa = __ldg(pa + kc);
            wb = __ldg(pb + kc);
        } else if (kc + 1 < n_kc) {
            na = __ldg(pa + kc + 1);
            nb = __ldg(pb + kc + 1);
        }
        const int s = kc % stages;
        mbar_wait(&full[s], (uint32_t)((kc / stages) & 1));
        __syncwarp();                   // wgmma needs the warp converged
        const uint32_t base = smem_u32(ring + (size_t)s * stage_bytes);
#pragma unroll
        for (int k0 = 0; k0 < KC / 16; k0 += KG) {
            // the group's A fragments and descriptors, all defined before
            // the fence (ptxas serializes products whose inputs an ordinary
            // instruction defines after it)
            uint32_t a[KG][4];
            uint64_t desc[KG][PLANES];
#pragma unroll
            for (int i = 0; i < KG; ++i) {
                const int ks = k0 + i;
                const uint32_t xa =
                    (ks < 2 ? wa.x : wa.y) >> (16 * (ks & 1) + shift);
                const uint32_t xb =
                    (ks < 2 ? wb.x : wb.y) >> (16 * (ks & 1) + shift);
                a[i][0] = bits_bf16x2(xa);
                a[i][1] = bits_bf16x2(xb);
                a[i][2] = bits_bf16x2(xa >> 8);
                a[i][3] = bits_bf16x2(xb >> 8);
                pin(a[i]);
#pragma unroll
                for (int pl = 0; pl < PLANES; ++pl)
                    desc[i][pl] = b_desc(base + pl * plane_bytes + ks * 256);
                pin(desc[i]);
            }
            wg_fence();
#pragma unroll
            for (int i = 0; i < KG; ++i)
#pragma unroll
                for (int pl = 0; pl < PLANES; ++pl)
                    Wgmma<N8>::mma(acc, a[i], desc[i][pl], 1u);
            wg_commit();
            wg_wait<0>();
        }
        if (lane == 0) mbar_arrive(&empty[s]);       // stage s is free
        __syncwarp();
        if (!WIDE) {
            wa = na;
            wb = nb;
        }
    }
    pin(acc);
}

// Scores of the block's tile (rows row0 + [0, 128), columns c0 + [0, NC))
// into shared memory: st[c * S_LD + r], `score_epilogue`. Every thread of
// the block calls this; it returns false in the producer warp, which has
// nothing more to do, and true in the consumers once the whole tile is in
// shared memory. `b` holds the chunk's n_kc stages of `shape.stage_bytes`;
// ysum the chunk's column sums. ASYNC_READ: the caller reads the tile with
// bulk copies (the async proxy), so each thread fences its tile writes
// before the closing barrier. ROWS (K5): st[r * row_ld(NC) + c],
// `score_value`. The row-major layout and the unmasked score go together
// as K5's alone, so one parameter selects both and K1-K4 compile as they
// did; the mask is left out where the score is computed rather than
// undone per stored element (score_value is never -inf, so both give the
// same scores).
template <int N8, bool ASYNC_READ = false, bool ROWS = false>
__device__ __forceinline__ bool wgmma_score_tile(
        const uint32_t* __restrict__ packed, const float* __restrict__ popcnt,
        const unsigned char* __restrict__ b, const float* __restrict__ ysum,
        long long row0, int w32, int planes, float n_used, float min_count,
        int stages, uint32_t stage_bytes, size_t ring_bytes,
        unsigned char* smem) {
    const int n_kc = w32 * 32 / KC;
    const size_t tile_bytes = sizeof(float) * tile_floats(8 * N8, ROWS);
    uint64_t* full = reinterpret_cast<uint64_t*>(
        smem + (ring_bytes > tile_bytes ? ring_bytes : tile_bytes));
    uint64_t* empty = full + stages;
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], WG_CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= WG_CONSUMERS) {              // producer warp
        if (threadIdx.x == WG_CONSUMERS) {
            for (int kc = 0; kc < n_kc; ++kc) {
                const int s = kc % stages;
                if (kc >= stages)
                    mbar_wait(&empty[s], (uint32_t)((kc / stages - 1) & 1));
                mbar_arrive_tx(&full[s], stage_bytes);
                bulk_load(smem + (size_t)s * stage_bytes,
                          b + (size_t)kc * stage_bytes, stage_bytes,
                          &full[s]);
            }
        }
        return false;
    }

    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int r = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16
                + gid;                              // rows r and r + 8
    const long long ra = row0 + r;
    const uint2* pa = reinterpret_cast<const uint2*>(packed + ra * w32);
    const uint2* pb = reinterpret_cast<const uint2*>(packed + (ra + 8) * w32);
    float acc[4 * N8];
#pragma unroll
    for (int i = 0; i < 4 * N8; ++i) acc[i] = 0.f;
    pin(acc);
    if (planes == 1)
        wgmma_k_loop<N8, 1>(pa, pb, n_kc, stages, stage_bytes, smem, full,
                            empty, acc);
    else
        wgmma_k_loop<N8, 3>(pa, pb, n_kc, stages, stage_bytes, smem, full,
                            empty, acc);

    // every product of both warpgroups is done before the ring is reused
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    float* st = reinterpret_cast<float*>(smem);
    const float n1a = popcnt[ra], n1b = popcnt[ra + 8];
#pragma unroll
    for (int j = 0; j < N8; ++j) {
        const int c = 8 * j + 2 * tig;
        const float y0 = ysum[c], y1 = ysum[c + 1];
        if (ROWS) {
            // columns c and c + 1 of a row are adjacent: one 8-byte store
            constexpr int LD = row_ld(8 * N8);
            *reinterpret_cast<float2*>(st + r * LD + c) = make_float2(
                score_value(acc[4 * j], n1a, y0, n_used, min_count),
                score_value(acc[4 * j + 1], n1a, y1, n_used, min_count));
            *reinterpret_cast<float2*>(st + (r + 8) * LD + c) = make_float2(
                score_value(acc[4 * j + 2], n1b, y0, n_used, min_count),
                score_value(acc[4 * j + 3], n1b, y1, n_used, min_count));
            continue;
        }
        st[c * S_LD + r] = score_epilogue(acc[4 * j], n1a, y0, n_used,
                                          min_count);
        st[(c + 1) * S_LD + r] = score_epilogue(acc[4 * j + 1], n1a, y1,
                                                n_used, min_count);
        st[c * S_LD + r + 8] = score_epilogue(acc[4 * j + 2], n1b, y0,
                                              n_used, min_count);
        st[(c + 1) * S_LD + r + 8] = score_epilogue(acc[4 * j + 3], n1b, y1,
                                                    n_used, min_count);
    }
    if (ASYNC_READ)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
    return true;
}

// Column group g (8 columns) of the score tile in the layout of
// tile_top3.cuh: s[i][j] = score of row tr + 32*i, column 8g + j.
__device__ __forceinline__ void load_column_group(const float* st, int g,
                                                  int tr,
                                                  float (&s)[TM_R][TM_C]) {
#pragma unroll
    for (int j = 0; j < TM_C; ++j)
#pragma unroll
        for (int i = 0; i < TM_R; ++i)
            s[i][j] = st[(8 * g + j) * S_LD + tr + 32 * i];
}

}  // namespace kgt
