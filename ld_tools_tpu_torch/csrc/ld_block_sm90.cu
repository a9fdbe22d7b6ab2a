// Block products with a stored epilogue on Hopper: ld_block_kernel.
//
// One kernel, a template on the operand form of the rows (Form) and on
// what it stores (Store), on the wgmma / TMA core of ld_sm90_core.cuh
// that the count pass (ld_count_sm90.cu) runs on.  Six instances, each
// at tiles 320 and 256 wide:
//
//   <FORM_S8, STORE_TRIANGLE>    replaces ld_tools_tpu/ops/ld_pallas.py
//       _tri_kernel_dense, int8 (K1, :259; pallas_call :467), and
//       scripts/bench_microkernels.py's staged triangle kernel (K8, :76;
//       pallas_call :125): f32 r^2 (and D') of the listed (bi, bj) blocks
//       of the (V, V) matrix at (bi block + r) V + bj block + c, at one
//       epilogue a launch (enum Epilogue: the exact order with or without
//       D', the divide-free r^2, and K8's counts and scale stages).  A
//       block is written whole, the cells above the diagonal of a diagonal
//       block too, as the TPU kernel writes it; cells past the matrix are
//       never written (the caller's buffer holds its zeros there).
//   <FORM_BF16, STORE_TRIANGLE>  replace _tri_kernel_dense's bf16 / f32
//   <FORM_TF32, STORE_TRIANGLE>  branch (K1b, :292-298): the same
//       triangle with the int8 rows cast to bf16 or f32 inside the kernel
//       and multiplied in bf16 or TF32, summed in f32.  The sums are exact
//       integers, so the outputs are K1's bit for bit.
//   <FORM_BITS, STORE_TRIANGLE>  replaces _tri_kernel_packed (K2, :303;
//       pallas_call :467): the same triangle on the store's bitpacked
//       bytes (W bytes a row, padded to 128), unpacked into the s8 stages
//       by K4's reshaping warps: K1's counts, so K1's r^2 / D' bit for bit.
//   <FORM_S8, STORE_SWEEP>       replaces _band_sweep_kernel, dense (K3,
//       :747; pallas_call :846): any subset of cab (int32), r2, dp and
//       meas (the fast r^2 when sel == 0, the exact-order D' when sel ==
//       1) of block k at k bm bn + lr bn + lc, rows of g_rows against
//       rows of g_cols.  EVERY cell of a listed block is written, past the
//       matrix edge too (the epilogue of a zero count there): the caller
//       allocates the outputs uninitialised.
//   <FORM_BITS, STORE_SWEEP>     replaces the packed branch of the same
//       kernel (K4, _band_counts_packed :693) on the store's bitpacked
//       bytes: K3's outputs bit for bit.
//
// Bound: the tensor-core operations.  The headline sweep (bench.py: V =
// 10,240 x 5,120 haplotypes, 136 blocks of 640^2) is 2 x 5,008 x 55.7 M
// cells = 0.28 ms at the H100's 1,979e12 int8 operations a second (0.56
// ms at 989e12 bf16, 1.13 ms at 495e12 TF32); it writes 223 MB of f32
// (0.067 ms at 3.35 TB/s) and reads 52 MB.  So the stores must drain
// under the products, not after them.
//
// The design, and what it does about what held the warp-level MMA kernels it
// replaces (K1 at 0.22 of that peak and 1.31x torch._int_mm's time over
// the same blocks; K3 at 0.22, K4 at 0.29, K2 at 0.29; K1b at 0.17 / 0.26,
// 3.7x and 2.2x torch.matmul in bf16 / TF32):
//  1. The core of the count pass: wgmma m64n160 (or m64n128) from shared
//     memory through descriptors (no per-thread fragment loads), a
//     3-stage TMA + mbarrier ring that no __syncthreads interrupts,
//     persistent thread blocks (grid = min(SMs, tiles), from the wrapper)
//     walking blocks x tiles, setmaxnreg giving the two consumer
//     warpgroups the accumulators' registers.  K2's and K4's bytes are
//     unpacked into the s8 stages by the producer warpgroups' unpack
//     warps, as K6's are.
//  2. K1b's operands.  A ring stage is one 128-byte swizzle row a row in
//     every form: 128 int8, 64 bf16 or 32 f32 haplotypes, and the wgmma
//     k-step is 32 bytes of it (k32 s8, k16 bf16, k8 tf32), so the
//     descriptors and the main loop are K1's; a tile takes 2x (bf16) or
//     4x (tf32) as many stages.  The kernel reads the int8 rows, never a
//     widened copy: TMA lands each stage's 64 or 32 int8 bytes a row in
//     the last quarter or eighth of the stage's own 32-row groups, and
//     the 7 reshaping warps widen them in place to bf16 / f32 (exact for
//     every int8), in the 128-byte swizzle, as K4's unpack warps write
//     bit-planes.  No shared memory is added: the landing is as deep as
//     the 3-stage ring.  The f32 accumulators hold exact integers below
//     2^24 and enter the epilogue as int32 counts.
//  3. Tile width.  A tile is 128 rows x TN columns, TN = 320 where it
//     divides the block side (640, the headline's and the scan's) and 256
//     otherwise (512 and 1,024: 2 and 4 tiles with no waste; 1,000 wastes
//     2.4 % of its columns against 28 % at 320).  block_tile_n is the
//     rule; ops/ld_kernels.py mirrors it, and its test reads it here.
//  4. Epilogue and store.  Each warp passes its 16 rows x TN counts
//     through a 16 x 32 shared-memory chunk (the count pass's), lane l
//     then finishes column l down the 16 rows in code specialised to the
//     epilogue mode, so each row's 32 lanes store 128 contiguous bytes.
//     The stores are plain st.global, fire and forget: they drain while
//     the warpgroup waits on the next tile's first stage and runs its
//     wgmmas (the producer has run ahead into that tile during the
//     epilogue).  No TMA store: the ring and the chunks leave no room for
//     a staged output tile.
//  5. Arithmetic.  ld_epilogue / fast_r2 of ld_common.cuh on the exact
//     int32 counts, built with -fmad=false, so every value equals the
//     plain PyTorch version's bit for bit, K1b's K1's and K4's K3's.
// What this design does not do: overlap the epilogue's arithmetic with the
// products (both consumer warpgroups finish a tile together).

#include "ld_sm90_core.cuh"

namespace {

enum Store : int { STORE_TRIANGLE = 0, STORE_SWEEP = 1 };

// The tile width for a block of block_n columns.  ops/ld_kernels.py
// block_tile_n mirrors this line; tests/test_torch_count_kernel.py reads it.
__host__ __device__ constexpr int block_tile_n(int block_n) {
    return block_n % 320 == 0 ? 320 : 256;
}

struct BlockArgs {
    const float* c1a;   // the tile rows' alt counts and 1 / (p q)
    const float* ipqa;
    const float* c1b;   // the tile columns'
    const float* ipqb;
    const int* cij;     // bi * 2^16 + bj
    int n_blocks, n_rows_a, n_rows_b, W, block_m, block_n;
    float n_f, inv_n;
    int mode;           // triangle: the epilogue mode; sweep: the output mode
    float* r2;
    float* dp;
    float* meas;        // sweep only
    int* cab;           // sweep only
};

// Per-row vectors of one tile: [0, CT_M) its rows, then its columns; rows
// past their matrix read as 0 (monomorphic).
struct BlockVecs {
    float c1[CT_M + MAX_CT_N];
    float ipq[CT_M + MAX_CT_N];
};

struct BlockSmem {
    Ring ring;          // first: its stages 1024-byte aligned
    BlockVecs vec[2];   // by tile parity
    int scratch[N_CONSUMER / 32][16 * SCR_ROW];  // a warp's epilogue chunk
};

constexpr int SMEM_BYTES = sizeof(BlockSmem) + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "the block kernel's shared memory");

// The triangle's epilogue mode: enum Epilogue, and EPI_EXACT with D'.
constexpr int MODE_EXACT_DP = 4;

// The sweep's output mode: 2 need_ld (r2, dp, or meas with sel 1) + (meas
// is the fast r^2).
__host__ __device__ constexpr int sweep_mode(bool need_ld, bool fast_meas) {
    return (need_ld ? 2 : 0) + (fast_meas ? 1 : 0);
}

// The tile's per-row vectors, entries ct and ct + 256 of BlockVecs.
struct VecRegs {
    float c1[2], ipq[2];
};

template <int TN>
__device__ __forceinline__ VecRegs load_vecs(const Tile& c, int ct,
                                             const BlockArgs& a) {
    VecRegs v;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = ct + i * N_CONSUMER;
        const bool is_row = r < CT_M;
        const int gr = is_row ? c.row0 + r : c.col0 + (r - CT_M);
        const bool ok =
            r < CT_M + TN && gr < (is_row ? a.n_rows_a : a.n_rows_b);
        v.c1[i] = ok ? __ldg((is_row ? a.c1a : a.c1b) + gr) : 0.0f;
        v.ipq[i] = ok ? __ldg((is_row ? a.ipqa : a.ipqb) + gr) : 0.0f;
    }
    return v;
}

template <int TN>
__device__ __forceinline__ void store_vecs(BlockVecs& dst, const VecRegs& v,
                                           int ct) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = ct + i * N_CONSUMER;
        if (r < CT_M + TN) {
            dst.c1[r] = v.c1[i];
            dst.ipq[r] = v.ipq[i];
        }
    }
}

// Lane l's column ``col`` of a warp's 16 x CHUNK chunk of counts (scr)
// into the (V, V) matrix: the rows of the tile that lie inside the block
// and the matrix (the caller skips columns outside them).
template <int EPI, bool DP>
__device__ __forceinline__ void triangle_column(
    const int* scr, const BlockVecs& vec, int lane, int col, int warp_row0,
    const Tile& c, const BlockArgs& a) {
    const float c1c = vec.c1[CT_M + col];
    const float ipqc = vec.ipq[CT_M + col];
    const size_t v = static_cast<size_t>(a.n_rows_a);
    // 64-bit offsets: V^2 passes 2^31 at V = 46,341
    const size_t o0 =
        static_cast<size_t>(c.row0 + warp_row0) * v + c.col0 + col;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        const int rt = warp_row0 + r;
        if (rt >= c.rows) continue;
        const size_t o = o0 + r * v;
        const float cf = static_cast<float>(scr[r * SCR_ROW + lane]);
        if (EPI == EPI_FAST) {
            a.r2[o] = fast_r2(cf, vec.c1[rt], c1c, vec.ipq[rt], ipqc, a.inv_n);
        } else if (EPI == EPI_COUNTS) {
            a.r2[o] = cf;
        } else if (EPI == EPI_SCALE) {
            a.r2[o] = cf * vec.c1[rt];
        } else {
            float r2x, dpx = 0.0f;
            ld_epilogue(cf, vec.c1[rt], c1c, a.inv_n, a.n_f, DP, &r2x, &dpx);
            a.r2[o] = r2x;
            if (DP) a.dp[o] = dpx;
        }
    }
}

__device__ __forceinline__ void triangle_column_of(
    const int* scr, const BlockVecs& vec, int lane, int col, int warp_row0,
    const Tile& c, const BlockArgs& a) {
#define LDK_TRI(E, D) \
    triangle_column<E, D>(scr, vec, lane, col, warp_row0, c, a)
    switch (a.mode) {
        case EPI_EXACT: LDK_TRI(EPI_EXACT, false); break;
        case EPI_FAST: LDK_TRI(EPI_FAST, false); break;
        case EPI_COUNTS: LDK_TRI(EPI_COUNTS, false); break;
        case EPI_SCALE: LDK_TRI(EPI_SCALE, false); break;
        default: LDK_TRI(EPI_EXACT, true); break;
    }
#undef LDK_TRI
}

// Lane l's column ``col`` of a chunk into block k's outputs: all 16 rows
// of the tile inside the block, past the matrix too.  The outputs not
// asked for are null (warp-uniform tests).
template <bool NEED_LD, bool FAST_MEAS>
__device__ __forceinline__ void sweep_column(
    const int* scr, const BlockVecs& vec, int lane, int col, int warp_row0,
    const Tile& c, const BlockArgs& a) {
    const float c1c = vec.c1[CT_M + col];
    const float ipqc = vec.ipq[CT_M + col];
    const size_t bn = static_cast<size_t>(a.block_n);
    const size_t o0 = static_cast<size_t>(c.k) * a.block_m * bn +
                      static_cast<size_t>(c.lr0 + warp_row0) * bn + c.lc0 + col;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        const int rt = warp_row0 + r;
        if (rt >= c.rows) continue;
        const size_t o = o0 + r * bn;
        const int cnt = scr[r * SCR_ROW + lane];
        const float cf = static_cast<float>(cnt);
        float r2x = 0.0f, dpx = 0.0f;
        if (NEED_LD)
            ld_epilogue(cf, vec.c1[rt], c1c, a.inv_n, a.n_f, true, &r2x, &dpx);
        if (a.cab) a.cab[o] = cnt;
        if (a.r2) a.r2[o] = r2x;
        if (a.dp) a.dp[o] = dpx;
        if (a.meas)
            a.meas[o] = FAST_MEAS ? fast_r2(cf, vec.c1[rt], c1c, vec.ipq[rt],
                                            ipqc, a.inv_n)
                                  : dpx;
    }
}

__device__ __forceinline__ void sweep_column_of(
    const int* scr, const BlockVecs& vec, int lane, int col, int warp_row0,
    const Tile& c, const BlockArgs& a) {
#define LDK_SWEEP(N, F) \
    sweep_column<N, F>(scr, vec, lane, col, warp_row0, c, a)
    switch (a.mode) {
        case sweep_mode(false, false): LDK_SWEEP(false, false); break;
        case sweep_mode(false, true): LDK_SWEEP(false, true); break;
        case sweep_mode(true, false): LDK_SWEEP(true, false); break;
        default: LDK_SWEEP(true, true); break;
    }
#undef LDK_SWEEP
}

// Warpgroups of the consumers: wgmma over every stage of each live tile,
// then the epilogue and the stores.
template <int FORM, int STORE, int TN, class W>
__device__ __forceinline__ void consume(BlockSmem& sm, const W& walk,
                                        const BlockArgs& a, int n_tiles,
                                        int nk) {
    constexpr int HALF_N = TN / 2;
    constexpr int N_CHUNKS = TN / CHUNK;
    const int ct = threadIdx.x - n_producer<FORM>();  // 0..255
    const int wg = ct >> 7;            // rows [64 wg, 64 wg + 64) of a tile
    const int lane = ct & 31;
    const int warp_row0 = 64 * wg + 16 * ((ct & 127) >> 5);  // its 16 rows
    // a warpgroup's wgmmas complete together: one thread frees the stage
    const bool wg_leader = (ct & 127) == 0;
    uint32_t q = 0;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile c = walk.at(t);
        if (!c.live) continue;
        const VecRegs vr = load_vecs<TN>(c, ct, a);
        Acc<FORM> acc0[HALF_N / 2], acc1[HALF_N / 2];
        mainloop<FORM, HALF_N>(sm.ring, q, wg, wg_leader, acc0, acc1, nk);

        // the vectors of the tile two back are read by now (one barrier)
        BlockVecs& vec = sm.vec[it & 1];
        store_vecs<TN>(vec, vr, ct);
        consumer_bar();
        int* scr = sm.scratch[ct >> 5];
        for (int ch = 0; ch < N_CHUNKS; ++ch) {
            __syncwarp();  // the previous chunk has been read
            stage_chunk<HALF_N>(acc0, acc1, ch, scr, lane);
            __syncwarp();
            const int col = chunk_col<HALF_N>(ch, lane);
            if (col >= c.cols) continue;
            if (STORE == STORE_TRIANGLE) {
                triangle_column_of(scr, vec, lane, col, warp_row0, c, a);
            } else {
                sweep_column_of(scr, vec, lane, col, warp_row0, c, a);
            }
        }
        ++it;
    }
}

template <int FORM, int STORE, int TN>
__global__ void __launch_bounds__(n_threads<FORM>(), 1)
ld_block_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ BlockArgs a) {
    static_assert(STORE == STORE_TRIANGLE || FORM == FORM_S8 ||
                      FORM == FORM_BITS,
                  "the routed instances only");
    extern __shared__ uint8_t smem_raw[];
    BlockSmem& sm = aligned_smem<BlockSmem>(smem_raw);
    using W = Walk<STORE == STORE_TRIANGLE ? WALK_TRIANGLE : WALK_SWEEP, TN>;
    // the triangle's rows and columns are one matrix's
    const W walk(a.cij, a.block_m, a.block_n, a.n_rows_a);
    const int n_tiles = walk.tiles(a.n_blocks);
    const int nk = (a.W + stage_src_bytes(FORM) - 1) / stage_src_bytes(FORM);
    if (threadIdx.x == 0) ring_init<FORM>(sm.ring);
    __syncthreads();
    run_roles<FORM>(
        [&] { produce<FORM, TN>(sm.ring, &map_a, &map_b, walk, n_tiles, nk); },
        [&] { reshape<FORM, TN>(sm.ring, walk, n_tiles, nk); },
        [&] { consume<FORM, STORE, TN>(sm, walk, a, n_tiles, nk); });
}

// Launch ld_block_kernel<FORM, STORE, block_tile_n(block_n)> over the
// blocks of ``a``: rows of ga (a.n_rows_a) against rows of gb.
template <int FORM, int STORE>
int launch_block(const void* ga, const void* gb, const BlockArgs& a,
                 int grid, void* stream) {
    if (grid < 1 || a.n_rows_a < 1 || a.n_rows_b < 1 || a.W < 16 ||
        a.W % 16 || a.block_m < 1 || a.block_m > MAX_BLOCK_SIDE ||
        a.block_n < 1 || a.block_n > MAX_BLOCK_SIDE)
        return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap map_a, map_b;
    cudaError_t err = make_tensor_map(&map_a, ga, a.W, a.n_rows_a, FORM);
    if (err == cudaSuccess)
        err = make_tensor_map(&map_b, gb, a.W, a.n_rows_b, FORM);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kernel = &ld_block_kernel<FORM, STORE, 320>;
    if (block_tile_n(a.block_n) != 320)
        kernel = &ld_block_kernel<FORM, STORE, 256>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, n_threads<FORM>(), SMEM_BYTES,
             static_cast<cudaStream_t>(stream)>>>(map_a, map_b, a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- plain C interface (loaded with ctypes; ops/_cuda_build.py) ------------
// ``grid`` is the number of persistent thread blocks (the wrapper passes
// min(SMs, tiles)).  Returns cudaErrorInvalidValue without a launch for a
// form with no routed instance (the triangle takes every form: FORM_S8,
// FORM_BITS, FORM_BF16 and FORM_TF32; the sweep FORM_S8 and FORM_BITS),
// an unknown epilogue, a
// grid below 1, a block side outside [1, 2048], no rows, a W that is not
// a positive multiple of 16 or a matrix that TMA cannot describe;
// cudaErrorSymbolNotFound when the driver has no cuTensorMapEncodeTiled.

extern "C" {

int ldk_block_triangle(const void* g, const void* c1, const void* ipq,
                       const void* cij, int n_blocks, int n_rows, int W,
                       int block_m, int block_n, float n_f, float inv_n,
                       int epi, int form, int grid, void* r2, void* dp,
                       void* stream) {
    if ((form != FORM_S8 && form != FORM_BITS && form != FORM_BF16 &&
         form != FORM_TF32) ||
        epi < EPI_EXACT || epi > EPI_SCALE || (dp && epi != EPI_EXACT) ||
        !r2)
        return static_cast<int>(cudaErrorInvalidValue);
    BlockArgs a{};
    a.c1a = a.c1b = static_cast<const float*>(c1);
    a.ipqa = a.ipqb = static_cast<const float*>(ipq);
    a.cij = static_cast<const int*>(cij);
    a.n_blocks = n_blocks;
    a.n_rows_a = a.n_rows_b = n_rows;
    a.W = W;
    a.block_m = block_m;
    a.block_n = block_n;
    a.n_f = n_f;
    a.inv_n = inv_n;
    a.mode = dp ? MODE_EXACT_DP : epi;
    a.r2 = static_cast<float*>(r2);
    a.dp = static_cast<float*>(dp);
    if (form == FORM_BITS)
        return launch_block<FORM_BITS, STORE_TRIANGLE>(g, g, a, grid, stream);
    if (form == FORM_BF16)
        return launch_block<FORM_BF16, STORE_TRIANGLE>(g, g, a, grid, stream);
    if (form == FORM_TF32)
        return launch_block<FORM_TF32, STORE_TRIANGLE>(g, g, a, grid, stream);
    return launch_block<FORM_S8, STORE_TRIANGLE>(g, g, a, grid, stream);
}

int ldk_block_sweep(const void* ga, const void* gb, const void* c1a,
                    const void* c1b, const void* ipqa, const void* ipqb,
                    const void* cij, int n_blocks, int n_rows_a,
                    int n_rows_b, int W, int block_m, int block_n, float n_f,
                    float inv_n, int sel, int form, int grid, void* cab,
                    void* r2, void* dp, void* meas, void* stream) {
    if ((form != FORM_S8 && form != FORM_BITS) || sel < 0 || sel > 1)
        return static_cast<int>(cudaErrorInvalidValue);
    BlockArgs a{};
    a.c1a = static_cast<const float*>(c1a);
    a.c1b = static_cast<const float*>(c1b);
    a.ipqa = static_cast<const float*>(ipqa);
    a.ipqb = static_cast<const float*>(ipqb);
    a.cij = static_cast<const int*>(cij);
    a.n_blocks = n_blocks;
    a.n_rows_a = n_rows_a;
    a.n_rows_b = n_rows_b;
    a.W = W;
    a.block_m = block_m;
    a.block_n = block_n;
    a.n_f = n_f;
    a.inv_n = inv_n;
    a.mode = sweep_mode(r2 || dp || (meas && sel == 1), meas && sel == 0);
    a.cab = static_cast<int*>(cab);
    a.r2 = static_cast<float*>(r2);
    a.dp = static_cast<float*>(dp);
    a.meas = static_cast<float*>(meas);
    if (form == FORM_BITS)
        return launch_block<FORM_BITS, STORE_SWEEP>(ga, gb, a, grid, stream);
    return launch_block<FORM_S8, STORE_SWEEP>(ga, gb, a, grid, stream);
}

const char* ldk_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
