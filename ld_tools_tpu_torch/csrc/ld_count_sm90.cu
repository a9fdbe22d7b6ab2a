// The fused count pass on Hopper: ld_band_count_kernel (K5, K6).
//
// Replaces ld_tools_tpu/ops/ld_pallas.py _band_count_kernel (:909), dense
// (K5, int8 {0,1} rows) and packed (K6, the branch at :949-974: the
// store's bitpacked bytes, 8 haplotypes a byte).  For every listed block
// (cij[k] = bi * 2^16 + bj, block_m x block_n variants) it counts the
// pairs that pass the threshold (exact_keep on the integer counts, or
// the f32 fallback measure), lie strictly below the diagonal and, with
// use_dist, within max_dist; out[k] += that count.  Only the counts leave
// the chip.  The caller zeroes out.
//
// Bound: the tensor-core operations.  Every kept cell is a dot product of
// two rows over the 5,008 real haplotypes, 2 x 5,008 operations, at the
// H100's 1,979e12 int8 operations a second: chr21's 12,880 blocks of
// 640^2 are 26.5 ms of it, against 0.5 GB read from HBM (0.16 ms).
//
// The design, and what it does about what held the mma.sync kernel it
// replaces at 23-28 % of that peak:
//  1. Tensor cores.  wgmma.mma_async m64n160k32 s8.s8 -> s32, both
//     operands K-major from shared memory (the rows are K-contiguous), in
//     place of mma.sync m16n8k32 (SASS IMMA, the legacy path).
//  2. Operand reads.  wgmma reads its operands from shared memory through
//     a descriptor: no per-thread fragment loads (the old core spent 24
//     LDS.32 per 16 MMAs, more shared-memory clocks than MMA clocks).
//  3. Pipeline.  One producer thread keeps TMA loads (cp.async.bulk.tensor)
//     in flight over a ring of 3 stages of 128 K-bytes in the 128-byte
//     swizzle, signalled through mbarriers; the consumers never meet at a
//     __syncthreads in the main loop, each warpgroup frees a stage as soon
//     as its own products of it are done (the other warpgroup's keep the
//     tensor cores busy meanwhile), and nobody computes copy addresses or
//     masks: TMA zero-fills rows past the matrix and bytes past W.
//     setmaxnreg moves registers from the producer warpgroup(s) (40) to
//     the two consumer warpgroups (232, or 216 for K6, for 160
//     accumulators a thread).
//  4. Tile.  A thread block computes a 128 x 320 tile (two consumer
//     warpgroups of 64 rows, each two m64n160k32 per K step): 183 int8
//     operations per byte it reads through L2, against 128 for a 128 x 128
//     sub-tile, and a 640^2 block is 5 x 2 tiles with no waste.
//  5. Scheduling.  One persistent thread block per SM walks a linear index
//     over blocks x tiles and skips, without loading anything, every tile
//     that holds no cell strictly below the diagonal (or no row of the
//     matrix).  The producer runs ahead into the next tile while the
//     consumers finish this tile's epilogue.  The tiles of one block are
//     neighbours in the walk, so the thread blocks that share a block's
//     rows read them through L2 at about the same time.
//
// K6, the bit-plane form: wgmma reads B from shared memory, so the packed
// bytes cannot be unpacked in registers as the mma.sync core did.  The
// producer thread TMA-loads 16 packed bytes a row per stage (8x fewer
// bytes, a ring of 4), and a second producer warpgroup with the three
// other warps of the first (7 warps, 2 rows a thread) unpack them into
// the same swizzled s8 stage the dense form loads: K offset 16 s + b of a
// stage holds bit s of packed byte b, (byte >> s) & 1.  A and B share
// this (byte, plane) -> K map, so the sum over K is the exact haplotype
// count and K6 equals K5 bit for bit; the consumers run the very same
// wgmma code on both forms.  This was chosen over unpacking A in
// registers (wgmma's RS form) because it keeps one consumer for both
// forms; the RS form, which would unpack 29 % fewer rows, is the
// refinement should the unpack dominate K6's time.
//
// Epilogue: the mask functions of ld_common.cuh (exact_keep,
// fallback_meas), the strict lower triangle and the distance test.  The
// accumulators (accumulator i of a thread is row 16 warp + lane / 4 +
// 8 (i % 4 / 2), col 8 (i / 4) + 2 (lane % 4) + i % 2 of its
// warpgroup's 64 x 160 half) go through a per-warp 16 x 32 shared-memory
// chunk, ten chunks a tile, and lane l masks column l of a chunk down
// the warp's 16 rows in code specialised to the mask mode.  That keeps
// the mask's code small: masking the 160 accumulators in place needs 160
// unrolled copies of it (register indices must be constants), and ran
// slower.  The tile's per-row c1 / ipq / pos sit in shared
// memory, loaded before the main loop.  Each warp reduces its count; the
// thread block adds one atomicAdd per (block, tile) into out[k], one tile
// late, so no extra barrier is needed.
//
// Built with -fmad=false like every source (ld_kernels.cu says why).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ld_common.cuh"

namespace {

constexpr int CT_M = 128;          // tile rows: two consumer warpgroups x 64
constexpr int CT_N = 320;          // tile cols: two m64n160k32 a warpgroup
constexpr int CT_HALF_N = 160;
constexpr int BOX_ROWS = 64;       // rows of one TMA box (at most 256)
constexpr int KB = 128;            // K bytes of an s8 stage (one swizzle row)
constexpr int KB_PACKED = KB / 8;  // packed bytes that unpack into a stage
constexpr int STAGES = 3;          // the s8 ring
constexpr int PSTAGES = 4;         // the packed ring (FORM_BITS)
constexpr int N_CONSUMER = 256;    // the last two warpgroups
constexpr int VEC_ROWS = CT_M + CT_N;
constexpr int N_BOXES = VEC_ROWS / BOX_ROWS;  // 2 for A, 5 for B
constexpr int MAX_COUNT_BLOCK = 2048;  // keeps bi * block (bi < 2^15) in int32
constexpr int CONSUMER_BAR = 1;    // named barrier of the 256 consumers
constexpr int CHUNK = 32;          // epilogue columns a warp masks at once
constexpr int N_CHUNKS = CT_N / CHUNK;
constexpr int SCR_ROW = CHUNK + 1; // padded: conflict-free column reads

// The producer warpgroups: one for FORM_S8 (its thread 0 issues the TMA
// loads); two for FORM_BITS, whose other 7 warps unpack the bit-planes,
// 2 rows a thread.
template <int FORM>
__host__ __device__ constexpr int n_producer() {
    return FORM == FORM_BITS ? 256 : 128;
}
template <int FORM>
__host__ __device__ constexpr int n_threads() {
    return n_producer<FORM>() + N_CONSUMER;
}
constexpr int N_UNPACK = 256 - 32;
constexpr int ROWS_PER_UNPACKER = VEC_ROWS / N_UNPACK;
static_assert(ROWS_PER_UNPACKER * N_UNPACK == VEC_ROWS, "unpack rows");
// setmaxnreg: the registers of a producer and of a consumer thread, 65,536
// in all (40 x 128 + 232 x 256, or 40 x 256 + 216 x 256)
constexpr int PRODUCER_REGS = 40;
template <int FORM>
__host__ __device__ constexpr int consumer_regs() {
    return FORM == FORM_BITS ? 216 : 232;
}

// Per-row vectors of one tile: rows [0, CT_M) are the tile's rows, the
// rest its columns; rows past the matrix read as 0 (monomorphic).
struct CountVecs {
    float c1[VEC_ROWS];
    float ipq[VEC_ROWS];
    int pos[VEC_ROWS];
};

struct CountSmem {
    int8_t a[STAGES][CT_M * KB];   // every stage 1024-byte aligned:
    int8_t b[STAGES][CT_N * KB];   // the 128-byte swizzle's 8-row atom
    uint8_t pa[PSTAGES][CT_M * KB_PACKED];
    uint8_t pb[PSTAGES][CT_N * KB_PACKED];
    CountVecs vec[2];              // by tile parity
    int warp_cnt[2][N_CONSUMER / 32];
    int scratch[N_CONSUMER / 32][16 * SCR_ROW];  // a warp's epilogue chunk
    uint64_t full[STAGES], empty[STAGES];
    uint64_t pfull[PSTAGES], pempty[PSTAGES];
};

constexpr int SMEM_BYTES = sizeof(CountSmem) + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "the count kernel's shared memory");

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// completing on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
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
__device__ __forceinline__ void fence_acc(int (&d)[80]) {
#pragma unroll
    for (int i = 0; i < 80; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d = A (64 x 32 s8, descriptor da) . B (160 x 32 s8, descriptor db)^T
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n160k32(int (&d)[80], uint64_t da,
                                                 uint64_t db, int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
        "%80, %81, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
        : "l"(da), "l"(db), "r"(accumulate));
}

// ---- the tile walk --------------------------------------------------------

struct CountTile {
    int k;      // index into the block list
    int row0;   // first matrix row of the tile
    int col0;   // first matrix column of the tile
    int rows;   // tile rows inside the logical block and the matrix
    int cols;   // tile cols inside the logical block
    bool live;  // holds a cell strictly below the diagonal
};

// Tile t of the linear walk over blocks x (n_tm x n_tn) tiles.  A tile is
// live when its last existing row lies below its first column
// (tests/test_torch_count_kernel.py mirrors this rule on the host).
__device__ __forceinline__ CountTile count_tile_at(int t, const int* cij,
                                                   int n_tm, int n_tn,
                                                   int block_m, int block_n,
                                                   int n_rows) {
    CountTile c;
    const int per = n_tm * n_tn;
    c.k = t / per;
    const int s = t - c.k * per;
    const int tr = s / n_tn;
    const int tc = s - tr * n_tn;
    const int code = __ldg(cij + c.k);  // bi * 2^16 + bj, bi < 2^15
    c.row0 = (code >> 16) * block_m + tr * CT_M;
    c.col0 = (code & 0xffff) * block_n + tc * CT_N;
    c.rows = min(min(CT_M, block_m - tr * CT_M), n_rows - c.row0);
    c.cols = min(CT_N, block_n - tc * CT_N);
    c.live = c.rows > 0 && c.col0 < c.row0 + c.rows - 1;
    return c;
}

// ---- the roles --------------------------------------------------------------

// Thread 0: TMA loads of every stage of every live tile of this thread
// block, then waits until the consumers have released the last stages.
template <int FORM>
__device__ __forceinline__ void produce(CountSmem& sm, const CUtensorMap* map,
                                        const int* cij, int n_tiles, int n_tm,
                                        int n_tn, int block_m, int block_n,
                                        int n_rows, int nk) {
    constexpr bool BITS = FORM == FORM_BITS;
    constexpr int RING = BITS ? PSTAGES : STAGES;
    constexpr int KSTEP = BITS ? KB_PACKED : KB;
    constexpr uint32_t BOX_BYTES = BOX_ROWS * KSTEP;
    uint64_t* full = BITS ? sm.pfull : sm.full;
    uint64_t* empty = BITS ? sm.pempty : sm.empty;
    uint32_t q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const CountTile c = count_tile_at(t, cij, n_tm, n_tn, block_m,
                                          block_n, n_rows);
        if (!c.live) continue;
        for (int kc = 0; kc < nk; ++kc, ++q) {
            const int s = q % RING;
            mbar_wait(&empty[s], ((q / RING) & 1) ^ 1);
            mbar_expect_tx(&full[s], N_BOXES * BOX_BYTES);
            uint8_t* a = BITS ? sm.pa[s] : reinterpret_cast<uint8_t*>(sm.a[s]);
            uint8_t* b = BITS ? sm.pb[s] : reinterpret_cast<uint8_t*>(sm.b[s]);
#pragma unroll
            for (int i = 0; i < CT_M / BOX_ROWS; ++i)
                tma_load(a + i * BOX_BYTES, map, &full[s], kc * KSTEP,
                         c.row0 + i * BOX_ROWS);
#pragma unroll
            for (int i = 0; i < CT_N / BOX_ROWS; ++i)
                tma_load(b + i * BOX_BYTES, map, &full[s], kc * KSTEP,
                         c.col0 + i * BOX_ROWS);
        }
    }
    for (int i = 0; i < RING; ++i, ++q)
        mbar_wait(&empty[q % RING], ((q / RING) & 1) ^ 1);
}

// FORM_BITS, warps 1-7 of the producer warpgroups, 2 rows a thread: each
// packed stage into the s8 stage of the same index, bit s of packed byte
// b at K offset 16 s + b, written in the 128-byte swizzle (16-byte chunk j
// of row r at chunk j ^ (r % 8)) that TMA writes and the wgmma descriptor
// reads.
__device__ __forceinline__ void unpack(CountSmem& sm, const int* cij,
                                       int n_tiles, int n_tm, int n_tn,
                                       int block_m, int block_n, int n_rows,
                                       int nk) {
    const int u = threadIdx.x - 32;
    uint32_t q = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const CountTile c = count_tile_at(t, cij, n_tm, n_tn, block_m,
                                          block_n, n_rows);
        if (!c.live) continue;
        for (int kc = 0; kc < nk; ++kc, ++q) {
            const int p = q % PSTAGES;
            const int s = q % STAGES;
            mbar_wait(&sm.pfull[p], (q / PSTAGES) & 1);
            mbar_wait(&sm.empty[s], ((q / STAGES) & 1) ^ 1);
#pragma unroll
            for (int i = 0; i < ROWS_PER_UNPACKER; ++i) {
                const int r = u + i * N_UNPACK;
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

// The per-row vectors of tile c, entries ct and ct + 256 of CountVecs.
struct VecRegs {
    float c1[2], ipq[2];
    int pos[2];
};

__device__ __forceinline__ VecRegs load_vecs(const CountTile& c, int ct,
                                             const float* c1, const float* ipq,
                                             const int* pos, int n_rows) {
    VecRegs v;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = ct + i * N_CONSUMER;
        const int gr = r < CT_M ? c.row0 + r : c.col0 + (r - CT_M);
        const bool ok = r < VEC_ROWS && gr < n_rows;
        v.c1[i] = ok ? __ldg(c1 + gr) : 0.0f;
        v.ipq[i] = ok ? __ldg(ipq + gr) : 0.0f;
        v.pos[i] = ok ? __ldg(pos + gr) : 0;
    }
    return v;
}

__device__ __forceinline__ void store_vecs(CountVecs& dst, const VecRegs& v,
                                           int ct) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = ct + i * N_CONSUMER;
        if (r < VEC_ROWS) {
            dst.c1[r] = v.c1[i];
            dst.ipq[r] = v.ipq[i];
            dst.pos[r] = v.pos[i];
        }
    }
}

// Lane l's column of a warp's 16 x CHUNK chunk of counts (scr): how many
// of its 16 rows are kept.  One instance per mask mode, so the loop body
// is straight-line code; cells outside the strict lower triangle or the
// block are masked only at the end (their inputs are finite).
template <bool EXACT, int SEL, bool DIST>
__device__ __forceinline__ int mask_column(
    const int* scr, const CountVecs& vec, int lane, int col, int cg,
    int warp_row0, const CountTile& c, int n_hap, float n_f, float inv_n,
    float thres, int max_dist) {
    const float c1c = vec.c1[CT_M + col];
    const float ipqc = vec.ipq[CT_M + col];
    const int posc = vec.pos[CT_M + col];
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        const int rt = warp_row0 + r;
        const int cab = scr[r * SCR_ROW + lane];
        bool keep;
        if (EXACT) {
            keep = exact_keep(cab, vec.c1[rt], c1c, n_hap, thres, SEL);
        } else {
            keep = fallback_meas(cab, vec.c1[rt], c1c, vec.ipq[rt], ipqc,
                                 n_f, inv_n, SEL) >= thres;
        }
        if (DIST) keep = keep & (abs(vec.pos[rt] - posc) <= max_dist);
        // strict lower triangle, inside the logical block
        cnt += keep & (rt < c.rows) & (cg < c.row0 + rt);
    }
    return cnt;
}

// mask_column at the mask mode ``mode`` = 4 (not exact) + 2 sel + dist.
__device__ __forceinline__ int mask_column_of(
    int mode, const int* scr, const CountVecs& vec, int lane, int col,
    int cg, int warp_row0, const CountTile& c, int n_hap, float n_f,
    float inv_n, float thres, int max_dist) {
#define LDK_MASK(E, S, D)                                                   \
    mask_column<E, S, D>(scr, vec, lane, col, cg, warp_row0, c, n_hap, n_f, \
                         inv_n, thres, max_dist)
    switch (mode) {
        case 0: return LDK_MASK(true, 0, false);
        case 1: return LDK_MASK(true, 0, true);
        case 2: return LDK_MASK(true, 1, false);
        case 3: return LDK_MASK(true, 1, true);
        case 4: return LDK_MASK(false, 0, false);
        case 5: return LDK_MASK(false, 0, true);
        case 6: return LDK_MASK(false, 1, false);
        default: return LDK_MASK(false, 1, true);
    }
#undef LDK_MASK
}

__device__ __forceinline__ void flush_count(const int* warp_cnt, int* out,
                                            int k) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < N_CONSUMER / 32; ++w) total += warp_cnt[w];
    if (total) atomicAdd(out + k, total);
}

// Warpgroups 1 and 2: wgmma over every stage of each live tile, then the
// mask and the count.
template <int FORM>
__device__ __forceinline__ void consume(
    CountSmem& sm, const float* c1, const float* ipq, const int* pos,
    const int* cij, int n_tiles, int n_tm, int n_tn, int block_m,
    int block_n, int n_rows, int nk, int n_hap, float n_f, float inv_n,
    float thres, int max_dist, int sel, int exact_mask, int use_dist,
    int* out) {
    const int ct = threadIdx.x - n_producer<FORM>();  // 0..255
    const int wg = ct >> 7;            // rows [64 wg, 64 wg + 64) of a tile
    const int lane = ct & 31;
    const int warp_row0 = 64 * wg + 16 * ((ct & 127) >> 5);  // its 16 rows
    // a warpgroup's wgmmas complete together: one thread frees the stage
    const bool wg_leader = (ct & 127) == 0;
    const int mode = (exact_mask ? 0 : 4) + 2 * sel + (use_dist ? 1 : 0);
    uint32_t q = 0;
    int it = 0;
    int prev_k = -1;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const CountTile c = count_tile_at(t, cij, n_tm, n_tn, block_m,
                                          block_n, n_rows);
        if (!c.live) continue;
        const VecRegs vr = load_vecs(c, ct, c1, ipq, pos, n_rows);
        // columns [0, 160) and [160, 320); the tile's first products
        // overwrite them (W >= 16: at least one stage), so no other
        // instruction writes an accumulator between the wgmmas
        int acc0[80], acc1[80];
        for (int kc = 0; kc < nk; ++kc, ++q) {
            const int s = q % STAGES;
            mbar_wait(&sm.full[s], (q / STAGES) & 1);
            fence_acc(acc0);
            fence_acc(acc1);
            wgmma_fence();
            const uint64_t da = sw128_desc(sm.a[s] + wg * 64 * KB);
            const uint64_t db0 = sw128_desc(sm.b[s]);
            const uint64_t db1 = sw128_desc(sm.b[s] + CT_HALF_N * KB);
#pragma unroll
            for (int kk = 0; kk < KB / 32; ++kk) {
                const int accumulate = kc > 0 || kk > 0;
                wgmma_m64n160k32(acc0, da + 2 * kk, db0 + 2 * kk, accumulate);
                wgmma_m64n160k32(acc1, da + 2 * kk, db1 + 2 * kk, accumulate);
            }
            wgmma_commit();
            fence_acc(acc0);
            fence_acc(acc1);
            // free the stage as soon as its products are done: the other
            // warpgroup's wgmmas keep the tensor cores busy meanwhile
            wgmma_wait<0>();
            if (wg_leader) mbar_arrive(&sm.empty[s]);
        }
        fence_acc(acc0);
        fence_acc(acc1);

        const int buf = it & 1;
        CountVecs& vec = sm.vec[buf];
        store_vecs(vec, vr, ct);
        consumer_bar();
        // the previous tile's warp counts are all in: one atomicAdd
        if (ct == 0 && prev_k >= 0)
            flush_count(sm.warp_cnt[buf ^ 1], out, prev_k);

        // Each warp passes its 16 x 320 counts through shared memory in
        // chunks of 16 x 32; lane l then masks column l of the chunk down
        // the warp's 16 rows (one copy of the mask code per mode).
        int* scr = sm.scratch[ct >> 5];
        int cnt = 0;
        for (int ch = 0; ch < N_CHUNKS; ++ch) {
            __syncwarp();  // the previous chunk has been read
#pragma unroll
            for (int i = 0; i < N_CHUNKS; ++i) {
                if (i != ch) continue;
#pragma unroll
                for (int jj = 0; jj < CHUNK / 8; ++jj)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int j =
                                (i % (N_CHUNKS / 2)) * (CHUNK / 8) + jj;
                            const int a = 4 * j + 2 * h + e;
                            scr[((lane >> 2) + 8 * h) * SCR_ROW + 8 * jj +
                                2 * (lane & 3) + e] =
                                i < N_CHUNKS / 2 ? acc0[a] : acc1[a];
                        }
            }
            __syncwarp();
            const int col = (ch / (N_CHUNKS / 2)) * CT_HALF_N +
                            (ch % (N_CHUNKS / 2)) * CHUNK + lane;
            const int cg = c.col0 + col;
            if (col >= c.cols) continue;
            cnt += mask_column_of(mode, scr, vec, lane, col, cg, warp_row0,
                                  c, n_hap, n_f, inv_n, thres, max_dist);
        }
        cnt = __reduce_add_sync(0xffffffffu, cnt);
        if (lane == 0) sm.warp_cnt[buf][ct >> 5] = cnt;
        prev_k = c.k;
        ++it;
    }
    consumer_bar();
    if (ct == 0 && prev_k >= 0)
        flush_count(sm.warp_cnt[(it - 1) & 1], out, prev_k);
}

template <int FORM>
__global__ void __launch_bounds__(n_threads<FORM>(), 1)
ld_band_count_kernel(const __grid_constant__ CUtensorMap map,
                     const float* __restrict__ c1,
                     const float* __restrict__ ipq,
                     const int* __restrict__ pos,
                     const int* __restrict__ cij, int n_blocks, int n_rows,
                     int W, int block_m, int block_n, int n_hap, float n_f,
                     float inv_n, float thres, int max_dist, int sel,
                     int exact_mask, int use_dist, int* __restrict__ out) {
    extern __shared__ uint8_t smem_raw[];
    CountSmem& sm = *reinterpret_cast<CountSmem*>(
        smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
    const int n_tm = (block_m + CT_M - 1) / CT_M;
    const int n_tn = (block_n + CT_N - 1) / CT_N;
    const int n_tiles = n_blocks * n_tm * n_tn;
    constexpr int KSTEP = FORM == FORM_BITS ? KB_PACKED : KB;
    const int nk = (W + KSTEP - 1) / KSTEP;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&sm.full[s], FORM == FORM_BITS ? N_UNPACK / 32 : 1);
            mbar_init(&sm.empty[s], N_CONSUMER / 128);
        }
        for (int p = 0; p < PSTAGES; ++p) {
            mbar_init(&sm.pfull[p], 1);
            mbar_init(&sm.pempty[p], N_UNPACK / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // one if / else for the whole kernel: setmaxnreg needs the roles apart
    if (threadIdx.x < n_producer<FORM>()) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     ::"n"(PRODUCER_REGS) : "memory");
        if (threadIdx.x == 0) {
            produce<FORM>(sm, &map, cij, n_tiles, n_tm, n_tn, block_m,
                          block_n, n_rows, nk);
        } else if (FORM == FORM_BITS && threadIdx.x >= 32) {
            unpack(sm, cij, n_tiles, n_tm, n_tn, block_m, block_n, n_rows,
                   nk);
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     ::"n"(consumer_regs<FORM>()) : "memory");
        consume<FORM>(sm, c1, ipq, pos, cij, n_tiles, n_tm, n_tn, block_m,
                      block_n, n_rows, nk, n_hap, n_f, inv_n, thres,
                      max_dist, sel, exact_mask, use_dist, out);
    }
}

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

}  // namespace

// ---- plain C interface (loaded with ctypes; see ld_kernels.cu) -------------
// ``grid`` is the number of persistent thread blocks (the wrapper passes
// min(SMs, tiles)).  Returns cudaErrorInvalidValue without a launch for
// an unknown form, a grid below 1, a block side outside [1, 2048], no
// rows, a W that is not a positive multiple of 16 or a matrix that TMA
// cannot describe; cudaErrorSymbolNotFound when the driver has no
// cuTensorMapEncodeTiled.

extern "C" {

int ldk_band_count(const void* g, const void* c1, const void* ipq,
                   const void* pos, const void* cij, int n_blocks,
                   int n_rows, int W, int block_m, int block_n, int n_hap,
                   float n_f, float inv_n, float thres, int max_dist,
                   int sel, int exact_mask, int use_dist, int form, int grid,
                   void* out, void* stream) {
    auto kernel = pick(form, ld_band_count_kernel<FORM_S8>,
                       ld_band_count_kernel<FORM_BITS>);
    if (!kernel || grid < 1 || n_rows < 1 || W < 16 || W % 16 ||
        block_m < 1 || block_m > MAX_COUNT_BLOCK || block_n < 1 ||
        block_n > MAX_COUNT_BLOCK)
        return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled encode = encode_tiled();
    if (!encode) return static_cast<int>(cudaErrorSymbolNotFound);
    CUtensorMap map;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(n_rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W)};
    const cuuint32_t box[2] = {
        static_cast<cuuint32_t>(form == FORM_BITS ? KB_PACKED : KB),
        static_cast<cuuint32_t>(BOX_ROWS)};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(g),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               form == FORM_BITS ? CU_TENSOR_MAP_SWIZZLE_NONE
                                 : CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = form == FORM_BITS ? n_threads<FORM_BITS>()
                                          : n_threads<FORM_S8>();
    kernel<<<grid, threads, SMEM_BYTES,
             static_cast<cudaStream_t>(stream)>>>(
        map, static_cast<const float*>(c1), static_cast<const float*>(ipq),
        static_cast<const int*>(pos), static_cast<const int*>(cij), n_blocks,
        n_rows, W, block_m, block_n, n_hap, n_f, inv_n, thres, max_dist, sel,
        exact_mask, use_dist, static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
