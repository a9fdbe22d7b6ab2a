// The last hand-written Hopper (sm_90a) kernel on the mma.sync core: the
// triangle on the store's bitpacked bytes (K2).
//
//   ld_triangle_kernel<FORM_BITS>  replaces ld_tools_tpu/ops/ld_pallas.py
//                                  _tri_kernel_packed (:303; pallas_call
//                                  :467): lower-triangle blocks of
//                                  all-pairs r^2 (and D') from packed rows.
//
// Every other kernel runs on the wgmma / TMA core (ld_sm90_core.cuh): the
// triangle on int8 rows (K1, K8) and its bf16 / tf32 forms (K1b) and the
// band sweeps (K3, K4) as instances of ld_block_kernel (ld_block_sm90.cu),
// the count pass (K5, K6) in ld_count_sm90.cu.  Moving K2 onto
// ld_block_kernel<FORM_BITS, STORE_TRIANGLE> is the next redesign.  It
// finishes its exact int32 counts with the epilogue functions of
// ld_common.cuh, as they do.
//
// What bounds it on an H100: the tensor-core operations.  A block pair
// of 640 x 640 variants over W = 5,120 haplotypes is 2 * 640^2 * 5120 =
// 4.2e9 operations against 0.1 MB of packed input, far above the card's
// ~590 int8 operations per byte of HBM.  Each thread block computes one
// 128 x 128 sub-tile of a logical block with mma.sync over a
// double-buffered cp.async pipeline, and the epilogue runs on the
// accumulators in registers, so only the requested outputs are written.
// What holds it at 0.29 of the peak: mma.sync (SASS IMMA, the legacy
// tensor-core path) fed by per-thread LDS.32 fragment loads, a 2-stage
// ring with __syncthreads in the main loop, and one non-persistent thread
// block per 128 x 128 sub-tile (PERF.md).
//
// The operand form: the store's bitpacked uint8 rows, 8 haplotypes per
// byte.  cp.async copies the packed bytes, 8x fewer per K step than int8
// rows, and the bit-planes are unpacked in registers: for a fragment word
// w of four packed bytes, (w >> s) & 0x01010101 is the int8x4 fragment of
// plane s, and 8 s8 MMAs (one per plane) consume the 32 bytes an int8 row
// spends on one.  This is the (a >> shift) & 1 algebra of
// _tri_kernel_packed; A and B share the (byte, plane) -> K map, so the
// sum over K is the exact haplotype count and r^2 / D' equal K1's bit for
// bit.  A b1 `mma ... .and.popc` is not used: the card has no published
// binary tensor-core rate.
//
// A 640 x 640 logical block does not fit one thread block, so the kernel
// splits it into ceil(block/128)^2 sub-tiles.  Ragged edges are masked
// here: rows past the matrix are zero-filled on load and never kept,
// cells past the logical block are never written.  Padding bytes and
// padding bits are zero, so they add nothing to any count.
//
// Build (ops/_cuda_build.py, every csrc/*.cu the same way):
//        nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -std=c++17 -c -Xcompiler -fPIC, linked with -shared.
// -fmad=false is required: the f32 epilogues must round every product and
// sum on its own, exactly as the plain PyTorch versions do op by op, or
// the f32 fallback mask of the count pass and the fetch pass could differ.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ld_common.cuh"

namespace {

constexpr int TM = 128;            // sub-tile rows
constexpr int TN = 128;            // sub-tile cols
constexpr int TK = 64;             // K step in packed bytes (8x as many haplotypes)
constexpr int SROW = TK + 16;      // padded smem row: conflict-free 32-bit fragment loads
constexpr int NTHREADS = 256;      // 8 warps as 2 (m) x 4 (n); warp tile 64 x 32
constexpr int MI = 4;              // m16 tiles per warp
constexpr int NI = 4;              // n8 tiles per warp

struct SubTile {
    int k;      // index into the block list
    int bi;     // logical block row
    int bj;     // logical block col
    int lr0;    // sub-tile row offset inside the logical block
    int lc0;    // sub-tile col offset inside the logical block
};

__device__ __forceinline__ SubTile decode_subtile(const int* cij, int n_sub_m,
                                                  int n_sub_n) {
    const int n_sub = n_sub_m * n_sub_n;
    SubTile t;
    t.k = blockIdx.x / n_sub;
    const int s = blockIdx.x - t.k * n_sub;
    const int code = cij[t.k];  // bi * 2^16 + bj, bi < 2^15
    t.bi = code >> 16;
    t.bj = code & 0xffff;
    t.lr0 = (s / n_sub_n) * TM;
    t.lc0 = (s % n_sub_n) * TN;
    return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One TM-row (or TN-row) slab of K bytes [k0, k0 + TK) into shared memory.
// Rows past n_rows and 16-byte chunks past W are zero-filled; W is a
// multiple of 16 (checked by the caller), so a chunk is all in or all out.
__device__ __forceinline__ void load_slab(int8_t* s, const int8_t* g,
                                          int row0, int n_rows, int W,
                                          int k0) {
    for (int i = threadIdx.x; i < TM * (TK / 16); i += NTHREADS) {
        const int r = i >> 2;
        const int c = (i & 3) * 16;
        const int gr = row0 + r;
        const int gk = k0 + c;
        const bool ok = gr < n_rows && gk < W;
        const int8_t* src = ok ? g + static_cast<size_t>(gr) * W + gk : g;
        cp_async16(s + r * SROW + c, src, ok);
    }
}

// The MMAs of one 32-byte K slice of packed bytes.  af and bf are the
// m16n8k32 s8 fragment words (PTX ISA): lane = 4 * g + t; af[mi] holds
// rows g / g+8 at bytes 4t (regs 0, 1) and 16+4t (regs 2, 3); bf[ni]
// holds col g at bytes 4t and 16+4t.  Plane s of every word feeds one
// MMA; accumulator e lies at row g + 8 * (e >> 1), col 2t + (e & 1).
__device__ __forceinline__ void mma_slice(int (&acc)[MI][NI][4],
                                          const unsigned (&af)[MI][4],
                                          const unsigned (&bf)[NI][2]) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        unsigned ap[MI][4], bp[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int r = 0; r < 4; ++r) ap[mi][r] = (af[mi][r] >> s) & 0x01010101u;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int r = 0; r < 2; ++r) bp[ni][r] = (bf[ni][r] >> s) & 0x01010101u;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], ap[mi], bp[ni]);
    }
}

// The count core: acc = A[a_row0 : a_row0+TM] . B[b_row0 : b_row0+TN]^T
// over the 8 W haplotypes of the W packed bytes, exact int32.
struct Smem {
    int8_t a[2][TM * SROW];
    int8_t b[2][TN * SROW];
};

__device__ __forceinline__ void count_tile(Smem& sm, const int8_t* g,
                                           int a_row0, int b_row0,
                                           int n_rows, int W,
                                           int (&acc)[MI][NI][4]) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp >> 2;  // 0..1
    const int wn = warp & 3;   // 0..3
    const int g8 = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    const int nk = (W + TK - 1) / TK;
    load_slab(sm.a[0], g, a_row0, n_rows, W, 0);
    load_slab(sm.b[0], g, b_row0, n_rows, W, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        const int cur = kt & 1;
        if (kt + 1 < nk) {
            load_slab(sm.a[cur ^ 1], g, a_row0, n_rows, W, (kt + 1) * TK);
            load_slab(sm.b[cur ^ 1], g, b_row0, n_rows, W, (kt + 1) * TK);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int8_t* sa = sm.a[cur];
        const int8_t* sb = sm.b[cur];
#pragma unroll
        for (int kk = 0; kk < TK; kk += 32) {
            unsigned af[MI][4];
            unsigned bf[NI][2];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                const int r = wm * 64 + mi * 16 + g8;
                af[mi][0] = *reinterpret_cast<const unsigned*>(
                    sa + r * SROW + kk + 4 * t);
                af[mi][1] = *reinterpret_cast<const unsigned*>(
                    sa + (r + 8) * SROW + kk + 4 * t);
                af[mi][2] = *reinterpret_cast<const unsigned*>(
                    sa + r * SROW + kk + 16 + 4 * t);
                af[mi][3] = *reinterpret_cast<const unsigned*>(
                    sa + (r + 8) * SROW + kk + 16 + 4 * t);
            }
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
                const int c = wn * 32 + ni * 8 + g8;
                bf[ni][0] = *reinterpret_cast<const unsigned*>(
                    sb + c * SROW + kk + 4 * t);
                bf[ni][1] = *reinterpret_cast<const unsigned*>(
                    sb + c * SROW + kk + 16 + 4 * t);
            }
            mma_slice(acc, af, bf);
        }
        __syncthreads();  // the next iteration overwrites the other stage
    }
}

// Row / col of accumulator element (mi, ni, e) inside the sub-tile.
__device__ __forceinline__ int acc_row(int mi, int e) {
    const int warp = threadIdx.x >> 5;
    return (warp >> 2) * 64 + mi * 16 + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}

__device__ __forceinline__ int acc_col(int ni, int e) {
    const int warp = threadIdx.x >> 5;
    return (warp & 3) * 32 + ni * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// Per-row vectors of one sub-tile, staged in shared memory; rows past the
// matrix read as 0 (monomorphic: every measure finishes as 0).
struct RowVecs {
    float c1r[TM], c1c[TN], ipqr[TM], ipqc[TN];
};

__device__ __forceinline__ void stage_vecs(RowVecs& v, const float* c1,
                                           const float* ipq, int row0,
                                           int col0, int n_rows) {
    for (int i = threadIdx.x; i < TM; i += NTHREADS) {
        const int r = row0 + i;
        const bool ok = r < n_rows;
        v.c1r[i] = ok ? c1[r] : 0.0f;
        v.ipqr[i] = ok ? ipq[r] : 0.0f;
    }
    for (int i = threadIdx.x; i < TN; i += NTHREADS) {
        const int c = col0 + i;
        const bool ok = c < n_rows;
        v.c1c[i] = ok ? c1[c] : 0.0f;
        v.ipqc[i] = ok ? ipq[c] : 0.0f;
    }
}

// ---- K2: lower-triangle all-pairs matrix ----------------------------------
//
// The epilogue (enum Epilogue, ld_common.cuh) is a runtime argument, one
// value for the whole launch.  Every epilogue writes whole listed (bi, bj)
// blocks, the cells above the diagonal of a diagonal block too, as the TPU
// kernel does.

template <int FORM>
__global__ void __launch_bounds__(NTHREADS)
ld_triangle_kernel(const int8_t* __restrict__ g, const float* __restrict__ c1,
                   const float* __restrict__ ipq, const int* __restrict__ cij,
                   int n_rows, int W, int block_m, int block_n, int n_sub_m,
                   int n_sub_n, float n_f, float inv_n, int epi,
                   float* __restrict__ r2, float* __restrict__ dp) {
    static_assert(FORM == FORM_BITS, "the packed rows only");
    __shared__ __align__(16) Smem sm;
    __shared__ RowVecs vec;
    const SubTile st = decode_subtile(cij, n_sub_m, n_sub_n);
    const int row0 = st.bi * block_m + st.lr0;
    const int col0 = st.bj * block_n + st.lc0;

    int acc[MI][NI][4];
    count_tile(sm, g, row0, col0, n_rows, W, acc);
    stage_vecs(vec, c1, ipq, row0, col0, n_rows);
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = acc_row(mi, e);
                const int c = acc_col(ni, e);
                const int rg = row0 + r;
                const int cg = col0 + c;
                if (st.lr0 + r >= block_m || st.lc0 + c >= block_n) continue;
                if (rg >= n_rows || cg >= n_rows) continue;
                const size_t o = static_cast<size_t>(rg) * n_rows + cg;
                const float cf = static_cast<float>(acc[mi][ni][e]);
                if (epi == EPI_FAST) {
                    r2[o] = fast_r2(cf, vec.c1r[r], vec.c1c[c], vec.ipqr[r],
                                    vec.ipqc[c], inv_n);
                } else if (epi == EPI_COUNTS) {
                    r2[o] = cf;
                } else if (epi == EPI_SCALE) {
                    r2[o] = cf * vec.c1r[r];
                } else {
                    float r2x, dpx = 0.0f;
                    ld_epilogue(cf, vec.c1r[r], vec.c1c[c], inv_n, n_f,
                                dp != nullptr, &r2x, &dpx);
                    r2[o] = r2x;
                    if (dp) dp[o] = dpx;
                }
            }
}

inline int n_sub(int block) { return (block + TM - 1) / TM; }

}  // namespace

// ---- plain C interface (loaded with ctypes) ------------------------------
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() right after the
// launch (a refused launch never runs, and a later synchronise would not
// report it).  ``form`` is the operand form of the rows (enum Form): this
// triangle takes FORM_BITS (the store's bitpacked bytes) only; any other
// value returns cudaErrorInvalidValue without a launch (the other forms
// run on ld_block_sm90.cu's ldk_block_triangle).  ``epi`` (enum
// Epilogue: 0 exact, 1 fast, 2 counts, 3 scale) is checked the same way.

extern "C" {

int ldk_triangle(const void* g, const void* c1, const void* ipq,
                 const void* cij, int n_blocks, int n_rows, int W,
                 int block_m, int block_n, float n_f, float inv_n, int epi,
                 int form, void* r2, void* dp, void* stream) {
    if (form != FORM_BITS || epi < EPI_EXACT || epi > EPI_SCALE)
        return static_cast<int>(cudaErrorInvalidValue);
    const int sm_ = n_sub(block_m), sn_ = n_sub(block_n);
    ld_triangle_kernel<FORM_BITS><<<n_blocks * sm_ * sn_, NTHREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(g), static_cast<const float*>(c1),
        static_cast<const float*>(ipq), static_cast<const int*>(cij), n_rows,
        W, block_m, block_n, sm_, sn_, n_f, inv_n, epi,
        static_cast<float*>(r2), static_cast<float*>(dp));
    return static_cast<int>(cudaGetLastError());
}

const char* ldk_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
