// The Hopper (sm_90a) block-product core shared by the count pass
// (ld_count_sm90.cu: K5, K6) and the stored-epilogue kernel
// (ld_block_sm90.cu: K1, K8, K1b, K3, K4).
//
// What it holds, and what each kernel adds around it:
//  - the PTX wrappers: mbarriers, TMA loads (cp.async.bulk.tensor), the
//    wgmma descriptor of a K-major operand in the 128-byte swizzle, and
//    wgmma.mma_async m64n160 / m64n128 in three operand types: k32
//    s8.s8 -> s32, k16 bf16.bf16 -> f32, k8 tf32.tf32 -> f32;
//  - the shared-memory ring: 3 stages of one 128-byte swizzle row of
//    operand elements a row of A (the tile's 128 rows) and B (its TN
//    columns): 128 int8, 64 bf16 or 32 f32 haplotypes.  Every form's
//    wgmma k-step is 32 bytes of that row, so one descriptor walk serves
//    all three.  For the bit-plane form 4 more stages of the 16 packed
//    bytes a row that unpack into one s8 stage;
//  - the tile walk: a linear index over blocks x (ceil(block_m / 128) x
//    ceil(block_n / TN)) tiles, walked by min(SMs, tiles) persistent
//    thread blocks; each kernel says which tiles are live (Walk);
//  - the roles: warpgroup 0 (and for the reshaped forms warpgroup 1)
//    produce, its thread 0 issuing every TMA load, warps 1-7 reshaping
//    what TMA landed into the ring's operand type (unpack: bit-planes to
//    s8; widen: int8 to bf16 or f32); the last two warpgroups consume, 64
//    rows each, two wgmmas of TN / 2 columns per 32 bytes of K.
//    setmaxnreg moves registers from the producers (40) to the consumers
//    (232, or 216 for the reshaped forms);
//  - the consumers' main loop over one tile's K stages, and the per-warp
//    16 x 32 shared-memory chunk through which an epilogue reads the
//    accumulators (as exact int32 counts) one column a lane;
//  - the host side: the tensor map of a row matrix (cuTensorMapEncodeTiled
//    through the runtime's driver entry point: no -lcuda).
//
// The producer takes two tensor maps, A for the tile's rows and B for its
// columns: the band sweep reads two matrices; the count pass and the
// triangle pass one map twice.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ld_common.cuh"

namespace {

constexpr int CT_M = 128;          // tile rows: two consumer warpgroups x 64
constexpr int MAX_CT_N = 320;      // the widest tile (TN is 320 or 256)
constexpr int BOX_ROWS = 64;       // rows of one TMA box (at most 256)
constexpr int KB = 128;            // bytes a row of a ring stage (one swizzle row)
constexpr int KB_PACKED = KB / 8;  // packed bytes that unpack into a stage
constexpr int STAGES = 3;          // the operand ring
constexpr int PSTAGES = 4;         // the packed ring (FORM_BITS)
constexpr int LAND_ROWS = 32;      // rows of a widened form's TMA box
constexpr int N_CONSUMER = 256;    // the last two warpgroups
constexpr int MAX_BLOCK_SIDE = 2048;  // keeps bi * block (bi < 2^15) in int32
constexpr int CONSUMER_BAR = 1;    // named barrier of the 256 consumers
constexpr int CHUNK = 32;          // epilogue columns a warp reads at once
constexpr int SCR_ROW = CHUNK + 1; // padded: conflict-free column reads

// The bytes of one operand element in the ring: int8 (FORM_S8, and
// FORM_BITS once unpacked), bf16 or f32 (the widened forms).  A stage
// holds KB / elem_bytes(form) haplotypes of K a row.
__host__ __device__ constexpr int elem_bytes(int form) {
    return form == FORM_BF16 ? 2 : form == FORM_TF32 ? 4 : 1;
}

// The bytes of the source matrix a row of one stage takes: KB int8, 16
// packed, or KB / elem_bytes int8 that widen to a full stage.
__host__ __device__ constexpr int stage_src_bytes(int form) {
    return form == FORM_BITS ? KB_PACKED : KB / elem_bytes(form);
}

// The rows of one TMA box: LAND_ROWS for the widened forms, which land
// each 32-row group of a stage inside that group's own rows.
__host__ __device__ constexpr int box_rows(int form) {
    return elem_bytes(form) > 1 ? LAND_ROWS : BOX_ROWS;
}

// Forms whose TMA loads reach the s8-shaped stages through the warps of
// a second producer warpgroup: the bit-planes (unpacked) and the widened
// int8 rows (bf16 or f32).  Only FORM_S8 lands as the consumers read it.
template <int FORM>
__host__ __device__ constexpr bool reshaped() {
    return FORM != FORM_S8;
}

// The widened forms: int8 rows multiplied in bf16 or tf32, summed in f32.
template <int FORM>
__host__ __device__ constexpr bool widened() {
    return elem_bytes(FORM) > 1;
}

// The producer warpgroups: one for FORM_S8 (its thread 0 issues the TMA
// loads); two for the reshaped forms, whose other 7 warps reshape.
template <int FORM>
__host__ __device__ constexpr int n_producer() {
    return reshaped<FORM>() ? 256 : 128;
}
template <int FORM>
__host__ __device__ constexpr int n_threads() {
    return n_producer<FORM>() + N_CONSUMER;
}
constexpr int N_UNPACK = 256 - 32;
// setmaxnreg: the registers of a producer and of a consumer thread, 65,536
// in all (40 x 128 + 232 x 256, or 40 x 256 + 216 x 256)
constexpr int PRODUCER_REGS = 40;
template <int FORM>
__host__ __device__ constexpr int consumer_regs() {
    return reshaped<FORM>() ? 216 : 232;
}

// The consumers' accumulators: s32 for s8 products, f32 for the widened
// forms (exact integers below 2^24 for products of int8 values).
template <int FORM>
using Acc = std::conditional_t<widened<FORM>(), float, int>;

// The operand ring.  Every stage is 1024-byte aligned (the 128-byte
// swizzle's 8-row atom) when the ring starts the aligned shared memory.
// full[s]: the stage holds its operands (TMA's bytes for FORM_S8, the
// reshaping warps' arrivals otherwise); empty[s]: both consumer
// warpgroups are done with it.  FORM_BITS lands in the packed ring
// (pfull / pempty); the widened forms land inside the stage itself and
// use pfull[s] as the stage's landing barrier.
struct Ring {
    int8_t a[STAGES][CT_M * KB];
    int8_t b[STAGES][MAX_CT_N * KB];
    uint8_t pa[PSTAGES][CT_M * KB_PACKED];
    uint8_t pb[PSTAGES][MAX_CT_N * KB_PACKED];
    uint64_t full[STAGES], empty[STAGES];
    uint64_t pfull[PSTAGES], pempty[PSTAGES];
};
static_assert(PSTAGES >= STAGES, "a landing barrier for every stage");

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The kernel's shared memory as a T at the first 1024-byte boundary.
template <typename T>
__device__ __forceinline__ T& aligned_smem(uint8_t* raw) {
    return *reinterpret_cast<T*>(
        raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}

// One TMA box (BOX_ROWS rows from row y, bytes from x) into shared memory,
// completing on ``bar``.  Rows past the map's rows and bytes past its
// width arrive as zeros, also for a box wholly past them.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global"
        ".mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(x), "r"(y) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_bar() {
    asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(N_CONSUMER)
                 : "memory");
}

// The wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: start address >> 4 (bits 0-13), leading offset 1 (unused by
// this layout), stride 1024 bytes between 8-row groups (bits 32-45),
// layout 1 = SWIZZLE_128B (bits 62-63).  Adding 2 advances 32 K-bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(1) << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) |
           (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands of a wgmma, {%0, ..., %63} or {%0, ..., %79},
// then the descriptors and the predicate: "%80, %81, p" or "%64, %65, p"
// after "setp.ne.b32 p, %82, 0" or "%66".
#define LDK_D64                                                              \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                              \
    "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                     \
    "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                     \
    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                     \
    "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                     \
    "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                     \
    "%60, %61, %62, %63"
#define LDK_D80                                                              \
    LDK_D64 ", %64, %65, %66, %67, %68, %69, "                               \
    "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define LDK_PRED64 "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
#define LDK_PRED80 "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
#define LDK_OPS64 "}, %64, %65, p"
#define LDK_OPS80 "}, %80, %81, p"

#define LDK_ACC8(c, i)                                                       \
    c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),             \
        c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define LDK_ACC64(c)                                                         \
    LDK_ACC8(c, 0), LDK_ACC8(c, 8), LDK_ACC8(c, 16), LDK_ACC8(c, 24),        \
        LDK_ACC8(c, 32), LDK_ACC8(c, 40), LDK_ACC8(c, 48), LDK_ACC8(c, 56)
#define LDK_ACC80(c) LDK_ACC64(c), LDK_ACC8(c, 64), LDK_ACC8(c, 72)
#define LDK_S32(x) "+r"(x)
#define LDK_F32(x) "+f"(x)

// d = A (64 rows x 32 bytes of K, descriptor da) . B (N rows x 32 bytes,
// descriptor db)^T + (accumulate ? d : 0), one function a shape and
// operand type: N = 160 or 128 (80 or 64 accumulators a thread); s8
// (k32, s32 d), bf16 (k16, f32 d; both operands K-major: scale 1,
// transpose flags 0) or tf32 (k8, f32 d; K-major only, scale 1).
#define LDK_WGMMA(NAME, T, CON, NACC, INSTR, TAIL)                           \
    __device__ __forceinline__ void NAME(T (&d)[NACC], uint64_t da,          \
                                         uint64_t db, int accumulate) {      \
        asm volatile(LDK_PRED##NACC                                          \
                     "wgmma.mma_async.sync.aligned." INSTR " "               \
                     LDK_D##NACC LDK_OPS##NACC TAIL ";\n}\n"                 \
                     : LDK_ACC##NACC(CON)                                    \
                     : "l"(da), "l"(db), "r"(accumulate));                   \
    }

LDK_WGMMA(wgmma_m64n160k32, int, LDK_S32, 80, "m64n160k32.s32.s8.s8", "")
LDK_WGMMA(wgmma_m64n128k32, int, LDK_S32, 64, "m64n128k32.s32.s8.s8", "")
LDK_WGMMA(wgmma_m64n160k16, float, LDK_F32, 80, "m64n160k16.f32.bf16.bf16",
          ", 1, 1, 0, 0")
LDK_WGMMA(wgmma_m64n128k16, float, LDK_F32, 64, "m64n128k16.f32.bf16.bf16",
          ", 1, 1, 0, 0")
LDK_WGMMA(wgmma_m64n160k8, float, LDK_F32, 80, "m64n160k8.f32.tf32.tf32",
          ", 1, 1")
LDK_WGMMA(wgmma_m64n128k8, float, LDK_F32, 64, "m64n128k8.f32.tf32.tf32",
          ", 1, 1")

#undef LDK_WGMMA
#undef LDK_F32
#undef LDK_S32
#undef LDK_ACC80
#undef LDK_ACC64
#undef LDK_ACC8
#undef LDK_OPS80
#undef LDK_OPS64
#undef LDK_PRED80
#undef LDK_PRED64
#undef LDK_D80
#undef LDK_D64

// wgmma of a warpgroup's 64 rows against HALF_N columns (160 or 128) over
// 32 bytes of K, in the operand type of FORM
template <int FORM, int HALF_N>
__device__ __forceinline__ void wgmma_half(Acc<FORM> (&d)[HALF_N / 2],
                                           uint64_t da, uint64_t db,
                                           int accumulate) {
    static_assert(HALF_N == 160 || HALF_N == 128, "wgmma width");
    constexpr bool WIDE = HALF_N == 160;
    if constexpr (FORM == FORM_BF16) {
        if constexpr (WIDE) wgmma_m64n160k16(d, da, db, accumulate);
        else wgmma_m64n128k16(d, da, db, accumulate);
    } else if constexpr (FORM == FORM_TF32) {
        if constexpr (WIDE) wgmma_m64n160k8(d, da, db, accumulate);
        else wgmma_m64n128k8(d, da, db, accumulate);
    } else {
        if constexpr (WIDE) wgmma_m64n160k32(d, da, db, accumulate);
        else wgmma_m64n128k32(d, da, db, accumulate);
    }
}

// ---- the tile walk ----------------------------------------------------------

struct Tile {
    int k;      // index into the block list
    int row0;   // first matrix row of the tile
    int col0;   // first matrix column of the tile
    int lr0;    // first row of the tile inside its logical block
    int lc0;    // first column of the tile inside its logical block
    int rows;   // tile rows the kernel keeps (Walk)
    int cols;   // tile cols the kernel keeps (Walk)
    bool live;  // loaded and computed at all
};

// Which tiles a kernel computes, and which of their cells it keeps
// (tests/test_torch_count_kernel.py mirrors each rule on the host):
//  WALK_COUNT     rows inside the block and the matrix, cols inside the
//                 block; live when its last row lies below its first
//                 column (it holds a cell strictly below the diagonal);
//  WALK_TRIANGLE  rows and cols inside the block and the matrix; live when
//                 it holds a cell inside the matrix;
//  WALK_SWEEP     rows and cols inside the block; always live (every cell
//                 of a listed block is written, past the matrix too).
enum WalkKind : int { WALK_COUNT = 0, WALK_TRIANGLE = 1, WALK_SWEEP = 2 };

template <int KIND, int TN>
struct Walk {
    const int* cij;  // bi * 2^16 + bj, bi < 2^15
    int n_tm, n_tn, block_m, block_n, n_rows;

    __device__ Walk(const int* cij_, int block_m_, int block_n_, int n_rows_)
        : cij(cij_), n_tm((block_m_ + CT_M - 1) / CT_M),
          n_tn((block_n_ + TN - 1) / TN), block_m(block_m_),
          block_n(block_n_), n_rows(n_rows_) {}

    __device__ __forceinline__ int tiles(int n_blocks) const {
        return n_blocks * n_tm * n_tn;
    }

    // tile t of the linear walk
    __device__ __forceinline__ Tile at(int t) const {
        Tile c;
        const int per = n_tm * n_tn;
        c.k = t / per;
        const int s = t - c.k * per;
        const int tr = s / n_tn;
        const int tc = s - tr * n_tn;
        const int code = __ldg(cij + c.k);
        c.lr0 = tr * CT_M;
        c.lc0 = tc * TN;
        c.row0 = (code >> 16) * block_m + c.lr0;
        c.col0 = (code & 0xffff) * block_n + c.lc0;
        c.rows = min(CT_M, block_m - c.lr0);
        c.cols = min(TN, block_n - c.lc0);
        if (KIND == WALK_COUNT) {
            c.rows = min(c.rows, n_rows - c.row0);
            c.live = c.rows > 0 && c.col0 < c.row0 + c.rows - 1;
        } else if (KIND == WALK_TRIANGLE) {
            c.rows = min(c.rows, n_rows - c.row0);
            c.cols = min(c.cols, n_rows - c.col0);
            c.live = c.rows > 0 && c.cols > 0;
        } else {
            c.live = true;
        }
        return c;
    }
};

// ---- the roles --------------------------------------------------------------

// The ring's barriers, by thread 0 before the block's __syncthreads.
template <int FORM>
__device__ __forceinline__ void ring_init(Ring& sm) {
    for (int s = 0; s < STAGES; ++s) {
        mbar_init(&sm.full[s], reshaped<FORM>() ? N_UNPACK / 32 : 1);
        mbar_init(&sm.empty[s], N_CONSUMER / 128);
    }
    for (int p = 0; p < PSTAGES; ++p) {
        mbar_init(&sm.pfull[p], 1);
        mbar_init(&sm.pempty[p], N_UNPACK / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Thread 0: TMA loads of every stage of every live tile of this thread
// block (A's CT_M rows from map_a, B's TN rows from map_b), then waits
// until the consumers have released the last stages.  FORM_S8 lands
// straight in the s8 stage; FORM_BITS in the packed ring; the widened
// forms land the int8 bytes of each 32-row group of the stage in the last
// 32 x stage_src_bytes bytes of that group's own rows, where widen()
// reads them (the box's own 64- or 32-byte swizzle).
template <int FORM, int TN, class W>
__device__ __forceinline__ void produce(Ring& sm, const CUtensorMap* map_a,
                                        const CUtensorMap* map_b,
                                        const W& walk, int n_tiles, int nk) {
    constexpr bool BITS = FORM == FORM_BITS;
    constexpr bool WIDE = widened<FORM>();
    constexpr int RING = BITS ? PSTAGES : STAGES;
    constexpr int KSTEP = stage_src_bytes(FORM);
    constexpr int ROWS = box_rows(FORM);
    constexpr uint32_t BOX_BYTES = ROWS * KSTEP;
    constexpr int N_BOXES = (CT_M + TN) / ROWS;
    // box i of a stage at i * BOX_STRIDE + BOX_OFFSET
    constexpr int BOX_STRIDE = WIDE ? ROWS * KB : BOX_BYTES;
    constexpr int BOX_OFFSET = WIDE ? ROWS * KB - BOX_BYTES : 0;
    uint64_t* full = FORM == FORM_S8 ? sm.full : sm.pfull;
    uint64_t* empty = BITS ? sm.pempty : sm.empty;
    uint32_t q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile c = walk.at(t);
        if (!c.live) continue;
        for (int kc = 0; kc < nk; ++kc, ++q) {
            const int s = q % RING;
            mbar_wait(&empty[s], ((q / RING) & 1) ^ 1);
            mbar_expect_tx(&full[s], N_BOXES * BOX_BYTES);
            uint8_t* a = (BITS ? sm.pa[s] : reinterpret_cast<uint8_t*>(sm.a[s]))
                         + BOX_OFFSET;
            uint8_t* b = (BITS ? sm.pb[s] : reinterpret_cast<uint8_t*>(sm.b[s]))
                         + BOX_OFFSET;
#pragma unroll
            for (int i = 0; i < CT_M / ROWS; ++i)
                tma_load(a + i * BOX_STRIDE, map_a, &full[s], kc * KSTEP,
                         c.row0 + i * ROWS);
#pragma unroll
            for (int i = 0; i < TN / ROWS; ++i)
                tma_load(b + i * BOX_STRIDE, map_b, &full[s], kc * KSTEP,
                         c.col0 + i * ROWS);
        }
    }
    for (int i = 0; i < RING; ++i, ++q)
        mbar_wait(&empty[q % RING], ((q / RING) & 1) ^ 1);
}

// FORM_BITS, warps 1-7 of the producer warpgroups: each packed stage into
// the s8 stage of the same index, bit s of packed byte b at K offset 16 s
// + b, written in the 128-byte swizzle (16-byte chunk j of row r at chunk
// j ^ (r % 8)) that TMA writes and the wgmma descriptor reads.  A and B
// share this (byte, plane) -> K map, so the sum over K is the exact
// haplotype count.  CT_M + TN rows, up to 2 a thread.
template <int TN, class W>
__device__ __forceinline__ void unpack(Ring& sm, const W& walk, int n_tiles,
                                       int nk) {
    constexpr int ROWS = CT_M + TN;
    constexpr int PER = (ROWS + N_UNPACK - 1) / N_UNPACK;
    const int u = threadIdx.x - 32;
    uint32_t q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile c = walk.at(t);
        if (!c.live) continue;
        for (int kc = 0; kc < nk; ++kc, ++q) {
            const int p = q % PSTAGES;
            const int s = q % STAGES;
            mbar_wait(&sm.pfull[p], (q / PSTAGES) & 1);
            mbar_wait(&sm.empty[s], ((q / STAGES) & 1) ^ 1);
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int r = u + i * N_UNPACK;
                if (PER * N_UNPACK != ROWS && r >= ROWS) continue;
                const bool in_a = r < CT_M;
                const int rr = in_a ? r : r - CT_M;
                const uint4 x = *reinterpret_cast<const uint4*>(
                    (in_a ? sm.pa[p] : sm.pb[p]) + rr * KB_PACKED);
                int8_t* dst = (in_a ? sm.a[s] : sm.b[s]) + rr * KB;
                const int sw = rr & 7;
#pragma unroll
                for (int pl = 0; pl < 8; ++pl) {
                    uint4 v;
                    v.x = (x.x >> pl) & 0x01010101u;
                    v.y = (x.y >> pl) & 0x01010101u;
                    v.z = (x.z >> pl) & 0x01010101u;
                    v.w = (x.w >> pl) & 0x01010101u;
                    *reinterpret_cast<uint4*>(dst + ((pl ^ sw) << 4)) = v;
                }
            }
            fence_proxy_async();  // the generic writes, before wgmma reads
            __syncwarp();
            if ((threadIdx.x & 31) == 0) {  // one arrival per warp
                mbar_arrive(&sm.pempty[p]);
                mbar_arrive(&sm.full[s]);
            }
        }
    }
}

// int8 byte k of u ^ 0x80808080 (the bytes plus 128, 0..255) as the f32
// of the signed byte: (2^23 + byte) - (2^23 + 128), both steps exact.
template <int K>
__device__ __forceinline__ float s8_as_f32(uint32_t biased) {
    return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | K)) -
           8388736.0f;
}

// The bf16 pair of bytes i, i + 1 of w when both are 0 or 1: [b_i, 0,
// b_i+1, 0] x 0x3F80 (bf16 1.0), one permute and one multiply.
__device__ __forceinline__ uint32_t bf16x2_of_bits(uint32_t w, int sel) {
    return __byte_perm(w, 0, sel) * 0x3F80u;
}

// 16 int8 K values (chunk j of a row's landed bytes) into their bf16 (two
// 16-byte chunks) or f32 (four) chunks of row ``dst``: logical chunk i at
// i ^ sw, the 128-byte swizzle.  Exact for every int8: bf16 is the f32's
// upper half, whose lower half is zero for an integer below 2^8, and
// tf32 reads the f32 bits.  ``bits`` (all 16 bytes 0 or 1, the
// haplotypes) takes bf16's short path: one op a value, not 2.75.
template <int FORM>
__device__ __forceinline__ void widen_chunk(uint4 x, uint8_t* dst, int j,
                                            int sw, bool bits) {
    const uint32_t w[4] = {x.x ^ 0x80808080u, x.y ^ 0x80808080u,
                           x.z ^ 0x80808080u, x.w ^ 0x80808080u};
    if constexpr (FORM == FORM_TF32) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            const uint4 v = make_uint4(
                __float_as_uint(s8_as_f32<0>(w[h])),
                __float_as_uint(s8_as_f32<1>(w[h])),
                __float_as_uint(s8_as_f32<2>(w[h])),
                __float_as_uint(s8_as_f32<3>(w[h])));
            *reinterpret_cast<uint4*>(dst + (((4 * j + h) ^ sw) << 4)) = v;
        }
    } else if (bits) {
        const uint32_t b[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const uint32_t lo = b[2 * half], hi = b[2 * half + 1];
            *reinterpret_cast<uint4*>(dst + (((2 * j + half) ^ sw) << 4)) =
                make_uint4(bf16x2_of_bits(lo, 0x4140),
                           bf16x2_of_bits(lo, 0x4342),
                           bf16x2_of_bits(hi, 0x4140),
                           bf16x2_of_bits(hi, 0x4342));
        }
    } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            uint32_t o[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t b = w[2 * half + h];
                o[2 * h] = __byte_perm(__float_as_uint(s8_as_f32<0>(b)),
                                       __float_as_uint(s8_as_f32<1>(b)),
                                       0x7632);
                o[2 * h + 1] = __byte_perm(__float_as_uint(s8_as_f32<2>(b)),
                                           __float_as_uint(s8_as_f32<3>(b)),
                                           0x7632);
            }
            *reinterpret_cast<uint4*>(dst + (((2 * j + half) ^ sw) << 4)) =
                make_uint4(o[0], o[1], o[2], o[3]);
        }
    }
}

// The widened forms (FORM_BF16, FORM_TF32), warps 1-7 of the producer
// warpgroups: each stage's int8 bytes, landed by produce() in the last
// 32 x stage_src_bytes bytes of each 32-row group of the stage, widened
// in place across the group's 32 x 128 bytes in the 128-byte swizzle
// that the wgmma descriptor reads.  A warp owns whole groups (CT_M + TN
// rows in 32-row groups, 2 a warp for TN = 320), a lane one row of each:
// it reads its row's landed bytes (chunk c of landed row l at c ^ (l / 2
// % 4) in the 64-byte swizzle, c ^ (l / 4 % 2) in the 32-byte one: no
// bank conflicts), the warp meets (every landed byte read before any is
// overwritten), and it writes its row widened.  The K order is the
// source's, the same for A and B.
template <int FORM, int TN, class W>
__device__ __forceinline__ void widen(Ring& sm, const W& walk, int n_tiles,
                                      int nk) {
    constexpr int SRC = stage_src_bytes(FORM);        // 64 or 32
    constexpr int GROUP = LAND_ROWS * KB;              // a group's bytes
    constexpr int LAND = LAND_ROWS * SRC;              // its landed bytes
    constexpr int A_GROUPS = CT_M / LAND_ROWS;
    constexpr int GROUPS = (CT_M + TN) / LAND_ROWS;
    const int warp = (threadIdx.x >> 5) - 1;           // 0..6
    const int lane = threadIdx.x & 31;
    const int lsw = FORM == FORM_BF16 ? (lane >> 1) & 3 : (lane >> 2) & 1;
    uint32_t q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile c = walk.at(t);
        if (!c.live) continue;
        for (int kc = 0; kc < nk; ++kc, ++q) {
            const int s = q % STAGES;
            mbar_wait(&sm.pfull[s], (q / STAGES) & 1);
            for (int g = warp; g < GROUPS; g += N_UNPACK / 32) {
                uint8_t* grp =
                    g < A_GROUPS
                        ? reinterpret_cast<uint8_t*>(sm.a[s]) + g * GROUP
                        : reinterpret_cast<uint8_t*>(sm.b[s]) +
                              (g - A_GROUPS) * GROUP;
                const uint8_t* src = grp + GROUP - LAND + lane * SRC;
                uint4 x[SRC / 16];
#pragma unroll
                for (int j = 0; j < SRC / 16; ++j)
                    x[j] = *reinterpret_cast<const uint4*>(
                        src + ((j ^ lsw) << 4));
                __syncwarp();
                uint32_t any = 0;
#pragma unroll
                for (int j = 0; j < SRC / 16; ++j)
                    any |= x[j].x | x[j].y | x[j].z | x[j].w;
                const bool bits = (any & 0xFEFEFEFEu) == 0;
#pragma unroll
                for (int j = 0; j < SRC / 16; ++j)
                    widen_chunk<FORM>(x[j], grp + lane * KB, j, lane & 7,
                                      bits);
            }
            fence_proxy_async();  // the generic writes, before wgmma reads
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.full[s]);  // one per warp
        }
    }
}

// Warps 1-7 of the producer warpgroups of a reshaped form: the landed
// bytes into the s8-shaped stages (FORM_S8 has no such warps).
template <int FORM, int TN, class W>
__device__ __forceinline__ void reshape(Ring& sm, const W& walk, int n_tiles,
                                        int nk) {
    if constexpr (FORM == FORM_BITS) {
        unpack<TN>(sm, walk, n_tiles, nk);
    } else if constexpr (widened<FORM>()) {
        widen<FORM, TN>(sm, walk, n_tiles, nk);
    }
}

// A consumer warpgroup's products of one tile: rows [64 wg, 64 wg + 64)
// against columns [0, HALF_N) into acc0 and [HALF_N, 2 HALF_N) into acc1,
// over nk stages of the ring from stage counter q (advanced).  The first
// products overwrite the accumulators (nk >= 1), so no other instruction
// writes one between the wgmmas.  Each warpgroup frees a stage as soon as
// its own products of it are done: the other warpgroup's keep the tensor
// cores busy meanwhile.  Every form steps K by 32 bytes of the swizzle
// row (+2 in the descriptor), KB / 32 wgmmas a stage.
template <int FORM, int HALF_N>
__device__ __forceinline__ void mainloop(Ring& sm, uint32_t& q, int wg,
                                         bool wg_leader,
                                         Acc<FORM> (&acc0)[HALF_N / 2],
                                         Acc<FORM> (&acc1)[HALF_N / 2],
                                         int nk) {
    for (int kc = 0; kc < nk; ++kc, ++q) {
        const int s = q % STAGES;
        mbar_wait(&sm.full[s], (q / STAGES) & 1);
        fence_acc(acc0);
        fence_acc(acc1);
        wgmma_fence();
        const uint64_t da = sw128_desc(sm.a[s] + wg * 64 * KB);
        const uint64_t db0 = sw128_desc(sm.b[s]);
        const uint64_t db1 = sw128_desc(sm.b[s] + HALF_N * KB);
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) {
            const int accumulate = kc > 0 || kk > 0;
            wgmma_half<FORM, HALF_N>(acc0, da + 2 * kk, db0 + 2 * kk,
                                     accumulate);
            wgmma_half<FORM, HALF_N>(acc1, da + 2 * kk, db1 + 2 * kk,
                                     accumulate);
        }
        wgmma_commit();
        fence_acc(acc0);
        fence_acc(acc1);
        wgmma_wait<0>();
        if (wg_leader) mbar_arrive(&sm.empty[s]);
    }
    fence_acc(acc0);
    fence_acc(acc1);
}

// An accumulator as the exact int32 count: s32 as it is; f32 holds an
// integer below 2^24 (sums of products of int8 values), converted exactly.
__device__ __forceinline__ int count_of(int x) { return x; }
__device__ __forceinline__ int count_of(float x) { return __float2int_rn(x); }

// Chunk ch of a warp's 16 x 2 HALF_N accumulators into its 16 x CHUNK
// scratch of int32 counts (row r at r * SCR_ROW).  Accumulator i of a
// thread is row lane / 4 + 8 (i % 4 / 2), col 8 (i / 4) + 2 (lane % 4) +
// i % 2 of its half (the wgmma layout of 32-bit accumulators, s32 and
// f32 alike).  Register indices must be constants, so every chunk's copy
// is unrolled and the one asked for runs.
template <int HALF_N, class T>
__device__ __forceinline__ void stage_chunk(const T (&acc0)[HALF_N / 2],
                                            const T (&acc1)[HALF_N / 2],
                                            int ch, int* scr, int lane) {
    constexpr int HALF_CHUNKS = HALF_N / CHUNK;
#pragma unroll
    for (int i = 0; i < 2 * HALF_CHUNKS; ++i) {
        if (i != ch) continue;
#pragma unroll
        for (int jj = 0; jj < CHUNK / 8; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int j = (i % HALF_CHUNKS) * (CHUNK / 8) + jj;
                    const int a = 4 * j + 2 * h + e;
                    scr[((lane >> 2) + 8 * h) * SCR_ROW + 8 * jj +
                        2 * (lane & 3) + e] =
                        count_of(i < HALF_CHUNKS ? acc0[a] : acc1[a]);
                }
    }
}

// The tile column lane ``lane`` holds in chunk ch.
template <int HALF_N>
__device__ __forceinline__ int chunk_col(int ch, int lane) {
    constexpr int HALF_CHUNKS = HALF_N / CHUNK;
    return (ch / HALF_CHUNKS) * HALF_N + (ch % HALF_CHUNKS) * CHUNK + lane;
}

// The role split, one if / else for the whole kernel (setmaxnreg needs
// the roles apart): the producer thread, the reshaping warps (the
// reshaped forms: unpack or widen), the consumers.
template <int FORM, class P, class U, class C>
__device__ __forceinline__ void run_roles(const P& producer,
                                          const U& reshaper,
                                          const C& consumer) {
    if (threadIdx.x < n_producer<FORM>()) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     ::"n"(PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            producer();
        } else if constexpr (reshaped<FORM>()) {
            if (threadIdx.x >= 32) reshaper();
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     ::"n"(consumer_regs<FORM>()) : "memory");
        consumer();
    }
}

// ---- host side ----------------------------------------------------------------

// cuTensorMapEncodeTiled (a driver entry point: the library links only the
// runtime), fetched once through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The tensor map of an (n_rows, W) byte matrix g in boxes of box_rows(form)
// rows and one stage's source bytes, stage_src_bytes(form): 128 in the
// 128-byte swizzle for FORM_S8 (the stage as wgmma reads it), 16
// unswizzled for FORM_BITS, 64 (FORM_BF16) or 32 (FORM_TF32) in the
// swizzle of their own width (conflict-free reads by widen()).  Returns
// cudaSuccess, cudaErrorSymbolNotFound when the driver has no
// cuTensorMapEncodeTiled, or cudaErrorInvalidValue for a matrix TMA
// cannot describe.
cudaError_t make_tensor_map(CUtensorMap* map, const void* g, int W,
                            int n_rows, int form) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return cudaErrorSymbolNotFound;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(n_rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W)};
    const cuuint32_t box[2] = {
        static_cast<cuuint32_t>(stage_src_bytes(form)),
        static_cast<cuuint32_t>(box_rows(form))};
    const cuuint32_t elem[2] = {1, 1};
    const CUtensorMapSwizzle swizzle =
        form == FORM_BITS   ? CU_TENSOR_MAP_SWIZZLE_NONE
        : form == FORM_BF16 ? CU_TENSOR_MAP_SWIZZLE_64B
        : form == FORM_TF32 ? CU_TENSOR_MAP_SWIZZLE_32B
                            : CU_TENSOR_MAP_SWIZZLE_128B;
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(g),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

}  // namespace
