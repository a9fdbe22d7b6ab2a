// Hand-written Hopper (sm_90a) kernels on the mma.sync core: the triangle
// and the band sweep in the forms not yet moved onto the wgmma / TMA core.
//
// Both share one mma.sync count-tile core here and the epilogue and mask
// functions of ld_common.cuh, so every pass of a scan derives its numbers
// from the same compiled arithmetic.  Each is a template on the operand
// form of its rows (Form, ld_common.cuh), and every instance runs the same
// epilogue code on the same exact int32 counts:
//
//   ld_triangle_kernel    replaces ld_tools_tpu/ops/ld_pallas.py
//                         _tri_kernel_dense's bf16 / f32 branch (K1b) and
//                         _tri_kernel_packed (K2): lower-triangle blocks
//                         of all-pairs r^2 (and D').
//   ld_band_sweep_kernel  replaces ld_pallas.py _band_sweep_kernel, dense
//                         (K3): per-block output menu cab / r2 / dp /
//                         meas, over a LIST of blocks so that one launch
//                         covers a whole batch of a scan's hit blocks.
//
// The int8 triangle (K1) with K8 and the packed sweep (K4) run on the
// wgmma / TMA core (ld_block_sm90.cu), and the count pass (K5, K6) too
// (ld_count_sm90.cu); ld_sm90_core.cuh is their shared core.  The entry
// points here refuse those forms.  Moving K2 and K3 onto ld_block_sm90.cu,
// then K1b onto bf16 / tf32 wgmma, is the next redesign.
//
// What bounds them on an H100: the tensor-core operations.  A block pair
// of 640 x 640 variants over W = 5,120 haplotypes is 2 * 640^2 * 5120 =
// 4.2e9 operations against 0.8 MB of int8 input (0.1 MB packed), some
// 5,000 operations per byte, far above the card's ~590 int8 operations
// per byte of HBM.  The design keeps the tensor cores fed from shared
// memory: each thread block computes one 128 x 128 sub-tile of a logical
// block with mma.sync over a double-buffered cp.async pipeline, and the
// epilogue runs on the accumulators in registers, so only the requested
// outputs are written.  What holds it at 0.17-0.29 of the peak: mma.sync
// (SASS IMMA, the legacy tensor-core path) fed by per-thread LDS.32
// fragment loads, a 2-stage ring with __syncthreads in the main loop, and
// one non-persistent thread block per 128 x 128 sub-tile (PERF.md).
//
// Operand forms (the count core is the only code that differs):
//   FORM_S8    int8 {0,1} rows, mma m16n8k32 s8 -> s32 (K3).
//   FORM_BITS  the store's bitpacked uint8 rows, 8 haplotypes per byte
//              (K2).  cp.async copies the packed bytes, 8x fewer
//              per K step, and the bit-planes are unpacked in registers:
//              for a fragment word w of four packed bytes, (w >> s) &
//              0x01010101 is the int8x4 fragment of plane s, and 8 s8
//              MMAs (one per plane) consume the 32 bytes the dense form
//              spends on one.  This is the (a >> shift) & 1 algebra of
//              _tri_kernel_packed; A and B share the (byte, plane) -> K
//              map, so the sum over K is the exact haplotype count.
//              Unpacking in registers rather than caching the stationary
//              A block's planes in shared memory (as the TPU kernel
//              caches a_planes) was chosen because the shift-and-mask
//              costs 2 integer ops per fragment register per plane, while
//              the 8 MMAs it feeds re-use each loaded word 8 times: the
//              shared-memory traffic per MMA drops 8x against the dense
//              form and no extra shared memory or synchronisation is
//              needed.  A b1 `mma ... .and.popc` is not used: the card
//              has no published binary tensor-core rate.  On an H100 at
//              700 W each bit-plane kernel took 0.75-0.82x the time of
//              its int8 twin on this core at the scan's and the sweep's
//              shapes (chip_smoke.py; PERF.md).
//   FORM_BF16  int8 rows converted to bf16 in registers, mma m16n8k16
//              bf16 -> f32 (K1b, mxu_dtype "bfloat16").
//   FORM_TF32  int8 rows converted to f32 (TF32 operands), mma m16n8k8
//              tf32 -> f32 (K1b, mxu_dtype "float32").
// The float forms accumulate in f32, exact for counts below 2^24, and
// hand the epilogue the same int32 counts as FORM_S8, so K1b's r^2 / D'
// are bit-identical to K1's.  Their conversion (one int-to-float per
// operand byte per fragment) makes them slower than K1 (2.6x in bf16,
// 3.3x in tf32 on an H100, chip_smoke.py); they exist for parity with the
// TPU kernel's bf16/f32 branch, not for speed.
//
// A 640 x 640 logical block does not fit one thread block, so each kernel
// splits it into ceil(block/128)^2 sub-tiles.  Ragged edges
// are masked here: rows past the matrix are zero-filled on load and never
// kept, cells past the logical block are never written.  Padding bytes
// and padding bits are zero, so they add nothing to any count.
//
// Build (ops/_cuda_build.py, every csrc/*.cu the same way):
//        nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -std=c++17 -c -Xcompiler -fPIC, linked with -shared.
// -fmad=false is required: the f32 epilogues must round every product and
// sum on its own, exactly as the plain PyTorch versions do op by op, or
// the f32 fallback mask of the count pass and the fetch pass could differ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ld_common.cuh"

namespace {

constexpr int TM = 128;            // sub-tile rows
constexpr int TN = 128;            // sub-tile cols
constexpr int TK = 64;             // K step in bytes (int8 haplotypes, or 8x as many packed)
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

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Signed byte i of a fragment word, as f32 (exact: |x| <= 128).
__device__ __forceinline__ float s8_at(unsigned w, int i) {
    return static_cast<float>(static_cast<int>(
        static_cast<signed char>(w >> (8 * i))));
}

// Bytes i and i+1 of w as a bf16x2 register (byte i in the low half,
// the lower K index); exact for int8 values.
__device__ __forceinline__ unsigned bf16x2_at(unsigned w, int i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(s8_at(w, i), s8_at(w, i + 1));
    return *reinterpret_cast<unsigned*>(&v);
}

// Byte i of w as a TF32 operand: the f32 bits (an integer below 2^11 has
// no bits in the 13 mantissa bits TF32 drops).
__device__ __forceinline__ unsigned tf32_at(unsigned w, int i) {
    return __float_as_uint(s8_at(w, i));
}

// One TM-row (or TN-row) slab of K bytes [k0, k0 + TK) into shared memory.
// Rows past n_rows and 16-byte chunks past W are zero-filled; W is a
// multiple of 16 (checked by the caller), so a chunk is all in or all out.
// The copy is the same for every operand form: a packed byte and an int8
// haplotype are both one byte here, and only count_tile reads them
// differently.
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

// The fragments of one 32-byte K slice feed the MMAs of one form.  af and
// bf are the m16n8k32 s8 fragment words (PTX ISA): lane = 4 * g + t;
// af[mi] holds rows g / g+8 at bytes 4t (regs 0, 1) and 16+4t (regs 2,
// 3); bf[ni] holds col g at bytes 4t and 16+4t.  The float forms map
// their K positions onto these same bytes (any K order is right when A
// and B share it): bf16 MMA q in {0, 1} takes the words at 16q+4t, bytes
// (0,1) as K 2t..2t+1 and (2,3) as K 2t+8..2t+9; tf32 MMA q in {0..3}
// takes byte 2(q&1) of the words at 16(q>>1)+4t as K t and the next byte
// as K t+4.  All forms leave accumulator e at row g + 8 * (e >> 1), col
// 2t + (e & 1).
template <int FORM>
__device__ __forceinline__ void mma_slice(int (&acc)[MI][NI][4],
                                          float (&facc)[MI][NI][4],
                                          const unsigned (&af)[MI][4],
                                          const unsigned (&bf)[NI][2]) {
    if constexpr (FORM == FORM_S8) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    } else if constexpr (FORM == FORM_BITS) {
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
    } else if constexpr (FORM == FORM_BF16) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            unsigned ah[MI][4], bh[NI][2];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                ah[mi][0] = bf16x2_at(af[mi][2 * q], 0);
                ah[mi][1] = bf16x2_at(af[mi][2 * q + 1], 0);
                ah[mi][2] = bf16x2_at(af[mi][2 * q], 2);
                ah[mi][3] = bf16x2_at(af[mi][2 * q + 1], 2);
            }
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
                bh[ni][0] = bf16x2_at(bf[ni][q], 0);
                bh[ni][1] = bf16x2_at(bf[ni][q], 2);
            }
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) mma_bf16(facc[mi][ni], ah[mi], bh[ni]);
        }
    } else {
        static_assert(FORM == FORM_TF32, "unknown operand form");
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int h = q >> 1;
            const int p = 2 * (q & 1);
            unsigned at[MI][4], bt[NI][2];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                at[mi][0] = tf32_at(af[mi][2 * h], p);
                at[mi][1] = tf32_at(af[mi][2 * h + 1], p);
                at[mi][2] = tf32_at(af[mi][2 * h], p + 1);
                at[mi][3] = tf32_at(af[mi][2 * h + 1], p + 1);
            }
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
                bt[ni][0] = tf32_at(bf[ni][h], p);
                bt[ni][1] = tf32_at(bf[ni][h], p + 1);
            }
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) mma_tf32(facc[mi][ni], at[mi], bt[ni]);
        }
    }
}

// The shared count core: acc = A[a_row0 : a_row0+TM] . B[b_row0 :
// b_row0+TN]^T over the full K = W bytes, exact int32 for every form
// (W bytes are W haplotypes, or 8 W for FORM_BITS).
struct Smem {
    int8_t a[2][TM * SROW];
    int8_t b[2][TN * SROW];
};

template <int FORM>
__device__ __forceinline__ void count_tile(Smem& sm, const int8_t* ga,
                                           int a_row0, int n_rows_a,
                                           const int8_t* gb, int b_row0,
                                           int n_rows_b, int W,
                                           int (&acc)[MI][NI][4]) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp >> 2;  // 0..1
    const int wn = warp & 3;   // 0..3
    const int g = lane >> 2;
    const int t = lane & 3;
    float facc[MI][NI][4];  // the float forms' accumulators
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc[mi][ni][e] = 0;
                facc[mi][ni][e] = 0.0f;
            }

    const int nk = (W + TK - 1) / TK;
    load_slab(sm.a[0], ga, a_row0, n_rows_a, W, 0);
    load_slab(sm.b[0], gb, b_row0, n_rows_b, W, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        const int cur = kt & 1;
        if (kt + 1 < nk) {
            load_slab(sm.a[cur ^ 1], ga, a_row0, n_rows_a, W, (kt + 1) * TK);
            load_slab(sm.b[cur ^ 1], gb, b_row0, n_rows_b, W, (kt + 1) * TK);
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
                const int r = wm * 64 + mi * 16 + g;
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
                const int c = wn * 32 + ni * 8 + g;
                bf[ni][0] = *reinterpret_cast<const unsigned*>(
                    sb + c * SROW + kk + 4 * t);
                bf[ni][1] = *reinterpret_cast<const unsigned*>(
                    sb + c * SROW + kk + 16 + 4 * t);
            }
            mma_slice<FORM>(acc, facc, af, bf);
        }
        __syncthreads();  // the next iteration overwrites the other stage
    }
    if constexpr (FORM == FORM_BF16 || FORM == FORM_TF32) {
        // f32 sums of 0/1 products are exact integers below 2^24
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    acc[mi][ni][e] = __float2int_rn(facc[mi][ni][e]);
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

__device__ __forceinline__ void stage_vecs(RowVecs& v, const float* c1a,
                                           const float* c1b,
                                           const float* ipqa,
                                           const float* ipqb,
                                           int row0, int n_rows_a, int col0,
                                           int n_rows_b) {
    for (int i = threadIdx.x; i < TM; i += NTHREADS) {
        const int r = row0 + i;
        const bool ok = r < n_rows_a;
        v.c1r[i] = ok ? c1a[r] : 0.0f;
        v.ipqr[i] = ok && ipqa ? ipqa[r] : 0.0f;
    }
    for (int i = threadIdx.x; i < TN; i += NTHREADS) {
        const int c = col0 + i;
        const bool ok = c < n_rows_b;
        v.c1c[i] = ok ? c1b[c] : 0.0f;
        v.ipqc[i] = ok && ipqb ? ipqb[c] : 0.0f;
    }
}

// ---- K3 / K4: band sweep over a block list ------------------------------

template <int FORM>
__global__ void __launch_bounds__(NTHREADS)
ld_band_sweep_kernel(const int8_t* __restrict__ ga,
                     const int8_t* __restrict__ gb,
                     const float* __restrict__ c1a,
                     const float* __restrict__ c1b,
                     const float* __restrict__ ipqa,
                     const float* __restrict__ ipqb,
                     const int* __restrict__ cij, int n_rows_a, int n_rows_b,
                     int W, int block_m, int block_n, int n_sub_m,
                     int n_sub_n, float n_f, float inv_n, int sel,
                     int* __restrict__ cab, float* __restrict__ r2,
                     float* __restrict__ dp, float* __restrict__ meas) {
    __shared__ __align__(16) Smem sm;
    __shared__ RowVecs vec;
    const SubTile st = decode_subtile(cij, n_sub_m, n_sub_n);
    const int row0 = st.bi * block_m + st.lr0;
    const int col0 = st.bj * block_n + st.lc0;

    int acc[MI][NI][4];
    count_tile<FORM>(sm, ga, row0, n_rows_a, gb, col0, n_rows_b, W, acc);
    stage_vecs(vec, c1a, c1b, ipqa, ipqb, row0, n_rows_a, col0, n_rows_b);
    __syncthreads();

    const bool need_ld = r2 || dp || (meas && sel == 1);
    const size_t base = static_cast<size_t>(st.k) * block_m * block_n;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = acc_row(mi, e);
                const int c = acc_col(ni, e);
                const int lr = st.lr0 + r;
                const int lc = st.lc0 + c;
                if (lr >= block_m || lc >= block_n) continue;
                const size_t o = base + static_cast<size_t>(lr) * block_n + lc;
                const int cnt = acc[mi][ni][e];
                const float cf = static_cast<float>(cnt);
                float r2x = 0.0f, dpx = 0.0f;
                if (need_ld)
                    ld_epilogue(cf, vec.c1r[r], vec.c1c[c], inv_n, n_f, true,
                                &r2x, &dpx);
                if (cab) cab[o] = cnt;
                if (r2) r2[o] = r2x;
                if (dp) dp[o] = dpx;
                if (meas)
                    meas[o] = sel == 0 ? fast_r2(cf, vec.c1r[r], vec.c1c[c],
                                                 vec.ipqr[r], vec.ipqc[c],
                                                 inv_n)
                                       : dpx;
            }
}

// ---- K1b / K2: lower-triangle all-pairs matrix ----------------------------
//
// The epilogue (enum Epilogue, ld_common.cuh) is a runtime argument, one
// value for the whole launch.  Every epilogue writes whole listed (bi, bj)
// blocks, the cells above the diagonal of a diagonal block too, as the TPU
// kernels do.

template <int FORM>
__global__ void __launch_bounds__(NTHREADS)
ld_triangle_kernel(const int8_t* __restrict__ g, const float* __restrict__ c1,
                   const float* __restrict__ ipq, const int* __restrict__ cij,
                   int n_rows, int W, int block_m, int block_n, int n_sub_m,
                   int n_sub_n, float n_f, float inv_n, int epi,
                   float* __restrict__ r2, float* __restrict__ dp) {
    __shared__ __align__(16) Smem sm;
    __shared__ RowVecs vec;
    const SubTile st = decode_subtile(cij, n_sub_m, n_sub_n);
    const int row0 = st.bi * block_m + st.lr0;
    const int col0 = st.bj * block_n + st.lc0;

    int acc[MI][NI][4];
    count_tile<FORM>(sm, g, row0, n_rows, g, col0, n_rows, W, acc);
    stage_vecs(vec, c1, c1, ipq, ipq, row0, n_rows, col0, n_rows);
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
// report it).  ``form`` is the operand form of the rows (enum Form):
// 0 int8, 1 bitpacked bytes, and for the triangle also 2 bf16, 3 tf32;
// any other value returns cudaErrorInvalidValue without a launch.  The
// triangle's ``epi`` (enum Epilogue: 0 exact, 1 fast, 2 counts, 3 scale)
// is checked the same way.

extern "C" {

int ldk_band_sweep(const void* ga, const void* gb, const void* c1a,
                   const void* c1b, const void* ipqa, const void* ipqb,
                   const void* cij, int n_blocks, int n_rows_a, int n_rows_b,
                   int W, int block_m, int block_n, float n_f, float inv_n,
                   int sel, int form, void* cab, void* r2, void* dp,
                   void* meas, void* stream) {
    // K4 (FORM_BITS) runs on ld_block_sm90.cu's wgmma core
    auto kernel = pick(form, ld_band_sweep_kernel<FORM_S8>,
                       decltype(&ld_band_sweep_kernel<FORM_S8>){nullptr});
    if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
    const int sm_ = n_sub(block_m), sn_ = n_sub(block_n);
    kernel<<<n_blocks * sm_ * sn_, NTHREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(ga), static_cast<const int8_t*>(gb),
        static_cast<const float*>(c1a), static_cast<const float*>(c1b),
        static_cast<const float*>(ipqa), static_cast<const float*>(ipqb),
        static_cast<const int*>(cij), n_rows_a, n_rows_b, W, block_m,
        block_n, sm_, sn_, n_f, inv_n, sel, static_cast<int*>(cab),
        static_cast<float*>(r2), static_cast<float*>(dp),
        static_cast<float*>(meas));
    return static_cast<int>(cudaGetLastError());
}

int ldk_triangle(const void* g, const void* c1, const void* ipq,
                 const void* cij, int n_blocks, int n_rows, int W,
                 int block_m, int block_n, float n_f, float inv_n, int epi,
                 int form, void* r2, void* dp, void* stream) {
    // K1 and K8 (FORM_S8) run on ld_block_sm90.cu's wgmma core
    auto kernel = pick(form, decltype(&ld_triangle_kernel<FORM_BITS>){nullptr},
                       ld_triangle_kernel<FORM_BITS>,
                       ld_triangle_kernel<FORM_BF16>,
                       ld_triangle_kernel<FORM_TF32>);
    if (!kernel || epi < EPI_EXACT || epi > EPI_SCALE)
        return static_cast<int>(cudaErrorInvalidValue);
    const int sm_ = n_sub(block_m), sn_ = n_sub(block_n);
    kernel<<<n_blocks * sm_ * sn_, NTHREADS, 0,
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
