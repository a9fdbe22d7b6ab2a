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
// The design, and what it does about what held the warp-level MMA kernel it
// replaces at 23-28 % of that peak:
//  1. Tensor cores.  wgmma.mma_async m64n160k32 s8.s8 -> s32, both
//     operands K-major from shared memory (the rows are K-contiguous), in
//     place of the warp-level MMA m16n8k32 (SASS IMMA, the legacy path).
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
// bytes cannot be unpacked in registers as the warp-level MMA core did.  The
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
// The machinery of items 1-3 and 5 and K6's unpack (the ring, the
// producer, the unpack warps, the consumers' main loop, the role split,
// the tensor map) is ld_sm90_core.cuh, which ld_block_sm90.cu (K1, K8, K4)
// shares; this file adds the count walk's rule, the mask and the count.
//
// Built with -fmad=false like every source (ld_common.cuh says why).

#include "ld_sm90_core.cuh"

namespace {

constexpr int CT_N = 320;          // tile cols: two m64n160k32 a warpgroup
constexpr int CT_HALF_N = CT_N / 2;
constexpr int VEC_ROWS = CT_M + CT_N;
constexpr int N_CHUNKS = CT_N / CHUNK;
static_assert((VEC_ROWS / N_UNPACK) * N_UNPACK == VEC_ROWS, "unpack rows");

// Per-row vectors of one tile: rows [0, CT_M) are the tile's rows, the
// rest its columns; rows past the matrix read as 0 (monomorphic).
struct CountVecs {
    float c1[VEC_ROWS];
    float ipq[VEC_ROWS];
    int pos[VEC_ROWS];
};

struct CountSmem {
    Ring ring;                     // first: its stages 1024-byte aligned
    CountVecs vec[2];              // by tile parity
    int warp_cnt[2][N_CONSUMER / 32];
    int scratch[N_CONSUMER / 32][16 * SCR_ROW];  // a warp's epilogue chunk
};

constexpr int SMEM_BYTES = sizeof(CountSmem) + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "the count kernel's shared memory");

using CountWalk = Walk<WALK_COUNT, CT_N>;

// ---- the consumers: mask and count ---------------------------------------

// The per-row vectors of tile c, entries ct and ct + 256 of CountVecs.
struct VecRegs {
    float c1[2], ipq[2];
    int pos[2];
};

__device__ __forceinline__ VecRegs load_vecs(const Tile& c, int ct,
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
    int warp_row0, const Tile& c, int n_hap, float n_f, float inv_n,
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
    int cg, int warp_row0, const Tile& c, int n_hap, float n_f,
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
    CountSmem& sm, const CountWalk& walk, const float* c1, const float* ipq,
    const int* pos, int n_tiles, int nk, int n_hap, float n_f, float inv_n,
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
        const Tile c = walk.at(t);
        if (!c.live) continue;
        const VecRegs vr = load_vecs(c, ct, c1, ipq, pos, walk.n_rows);
        int acc0[CT_HALF_N / 2], acc1[CT_HALF_N / 2];
        mainloop<FORM, CT_HALF_N>(sm.ring, q, wg, wg_leader, acc0, acc1, nk);

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
            stage_chunk<CT_HALF_N>(acc0, acc1, ch, scr, lane);
            __syncwarp();
            const int col = chunk_col<CT_HALF_N>(ch, lane);
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
    CountSmem& sm = aligned_smem<CountSmem>(smem_raw);
    const CountWalk walk(cij, block_m, block_n, n_rows);
    const int n_tiles = walk.tiles(n_blocks);
    const int nk = (W + stage_src_bytes(FORM) - 1) / stage_src_bytes(FORM);
    if (threadIdx.x == 0) ring_init<FORM>(sm.ring);
    __syncthreads();
    // the count pass reads one matrix: A and B are the same map
    run_roles<FORM>(
        [&] { produce<FORM, CT_N>(sm.ring, &map, &map, walk, n_tiles, nk); },
        [&] { reshape<FORM, CT_N>(sm.ring, walk, n_tiles, nk); },
        [&] {
            consume<FORM>(sm, walk, c1, ipq, pos, n_tiles, nk, n_hap, n_f,
                          inv_n, thres, max_dist, sel, exact_mask, use_dist,
                          out);
        });
}

}  // namespace

// ---- plain C interface (loaded with ctypes; ops/_cuda_build.py) ------------
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
        block_m < 1 || block_m > MAX_BLOCK_SIDE || block_n < 1 ||
        block_n > MAX_BLOCK_SIDE)
        return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap map;
    const cudaError_t made = make_tensor_map(&map, g, W, n_rows, form);
    if (made != cudaSuccess) return static_cast<int>(made);
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
