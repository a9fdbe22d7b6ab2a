// Hand-written Hopper (sm_90a) kernels for the LD engine's int8 count
// products and their fused epilogues.
//
// Three kernels share one int8 count-tile core and one set of epilogue
// and mask functions, so every pass of a scan derives its numbers from
// the same compiled arithmetic:
//
//   ld_triangle_kernel    replaces ld_tools_tpu/ops/ld_pallas.py
//                         _tri_kernel_dense (int8 branch): lower-triangle
//                         blocks of all-pairs r^2 (and D').
//   ld_band_sweep_kernel  replaces ld_pallas.py _band_sweep_kernel (dense
//                         branch): per-block output menu cab / r2 / dp /
//                         meas, over a LIST of blocks so that one launch
//                         covers a whole batch of a scan's hit blocks.
//   ld_band_count_kernel  replaces ld_pallas.py _band_count_kernel (dense
//                         branch): counts -> keep mask -> one int32 hit
//                         count per block, nothing else leaves the chip.
//
// What bounds them on an H100: the int8 tensor-core operations.  A block
// pair of 640 x 640 variants over W = 5,120 haplotypes is 2 * 640^2 * 5120
// = 4.2e9 operations against 0.8 MB of int8 input, some 5,000 operations
// per byte, far above the card's ~590 int8 operations per byte of HBM.
// The design keeps the tensor cores fed from shared memory: each thread
// block computes one 128 x 128 sub-tile of a logical block with
// mma.sync m16n8k32 (s8 x s8 -> s32) over a double-buffered cp.async
// pipeline, and the epilogue runs on the accumulators in registers, so
// only the requested outputs (or, for the count kernel, one atomicAdd per
// thread block) are written.  wgmma and TMA are later work.
//
// A 640 x 640 logical block does not fit one thread block, so each kernel
// splits it into ceil(block/128)^2 sub-tiles; the count kernel adds each
// sub-tile's integer count into its block's slot with atomicAdd (integers
// make the order irrelevant; the caller zeroes the slots).  Ragged edges
// are masked here: rows past the matrix are zero-filled on load and never
// kept, cells past the logical block are never written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -std=c++17 -shared -Xcompiler -fPIC.
// -fmad=false is required: the f32 epilogues must round every product and
// sum on its own, exactly as the plain PyTorch versions do op by op, or
// the f32 fallback mask of the count pass and the fetch pass could differ.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;            // sub-tile rows
constexpr int TN = 128;            // sub-tile cols
constexpr int TK = 64;             // K step in bytes (= int8 haplotypes)
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

// The shared int8 count core: acc = A[a_row0 : a_row0+TM] . B[b_row0 :
// b_row0+TN]^T over the full K = W, exact int32.  Fragment layout of
// mma.m16n8k32 (PTX ISA): lane = 4 * g + t; A regs hold rows g / g+8 at
// byte cols 4t and 16+4t; B regs hold col g at K bytes 4t and 16+4t;
// accumulator e holds row g + 8 * (e >> 1), col 2t + (e & 1).
struct Smem {
    int8_t a[2][TM * SROW];
    int8_t b[2][TN * SROW];
};

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
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

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
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
                for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
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

// ---- shared epilogue and mask functions (mirror ld_pallas.py) ----------

// _fast_r2 (ld_pallas.py:722): divide-free r^2 from f32 counts.
__device__ __forceinline__ float fast_r2(float c, float c1a, float c1b,
                                         float ipqa, float ipqb,
                                         float inv_n) {
    const float p1 = c1a * inv_n;
    const float p2 = c1b * inv_n;
    const float d = c * inv_n - p1 * p2;
    return (d * d) * (ipqa * ipqb);
}

// _ld_epilogue (ld_pallas.py:55): exact-order r^2 and D' with the
// monomorphic-to-0 sentinels.  want_dp = false skips the D' denominator.
__device__ __forceinline__ void ld_epilogue(float c, float c1a, float c1b,
                                            float inv_n, float n,
                                            bool want_dp, float* r2,
                                            float* dp) {
    const float p_ab = c * inv_n;
    const float p1 = c1a * inv_n;
    const float q1 = (n - c1a) * inv_n;
    const float p2 = c1b * inv_n;
    const float q2 = (n - c1b) * inv_n;
    const float d = p_ab - p1 * p2;
    const float r2_den = (p1 * q1) * (p2 * q2);
    bool dp_zero;
    if (want_dp) {
        const float den_pos = fminf(p1 * q2, q1 * p2);
        const float den_neg = fmaxf(-(p1 * p2), -(q1 * q2));
        const float den = d >= 0.0f ? den_pos : den_neg;
        const float dpv = den == 0.0f ? 0.0f : d / den;
        *dp = dpv;
        dp_zero = dpv == 0.0f;
    } else {
        dp_zero = r2_den == 0.0f || d == 0.0f;
    }
    *r2 = dp_zero ? 0.0f : (d * d) / r2_den;
}

// exact_keep_mask (ld_pallas.py:870): the threshold test from exact
// integer counts, int32-exact for n <= 46,340.
__device__ __forceinline__ bool exact_keep(int cab, float c1a, float c1b,
                                           int n, float thres, int sel) {
    const int c1i = static_cast<int>(c1a);  // counts are exact in f32
    const int c2i = static_cast<int>(c1b);
    const int nd = n * cab - c1i * c2i;
    const float nd_f = static_cast<float>(nd);
    if (sel == 0) {
        const float ab = static_cast<float>(c1i * (n - c1i)) *
                         static_cast<float>(c2i * (n - c2i));
        return nd_f * nd_f >= thres * ab && (ab > 0.0f || thres <= 0.0f);
    }
    const int m_pos = min(c1i * (n - c2i), (n - c1i) * c2i);
    const int m_neg = min(c1i * c2i, (n - c1i) * (n - c2i));
    const float m = static_cast<float>(nd >= 0 ? m_pos : m_neg);
    return fabsf(nd_f) >= thres * m && (m > 0.0f || thres <= 0.0f);
}

// The f32 fallback measure (cohorts past the int32-exact bound): fast r^2
// for sel 0, exact-order D' for sel 1.
__device__ __forceinline__ float fallback_meas(int cab, float c1a, float c1b,
                                               float ipqa, float ipqb,
                                               float n, float inv_n,
                                               int sel) {
    const float c = static_cast<float>(cab);
    if (sel == 0) return fast_r2(c, c1a, c1b, ipqa, ipqb, inv_n);
    float r2, dp;
    ld_epilogue(c, c1a, c1b, inv_n, n, true, &r2, &dp);
    return dp;
}

// Per-row vectors of one sub-tile, staged in shared memory; rows past the
// matrix read as 0 (monomorphic: every measure finishes as 0).
struct RowVecs {
    float c1r[TM], c1c[TN], ipqr[TM], ipqc[TN];
    int posr[TM], posc[TN];
};

__device__ __forceinline__ void stage_vecs(RowVecs& v, const float* c1a,
                                           const float* c1b,
                                           const float* ipqa,
                                           const float* ipqb,
                                           const int* posa, const int* posb,
                                           int row0, int n_rows_a, int col0,
                                           int n_rows_b) {
    for (int i = threadIdx.x; i < TM; i += NTHREADS) {
        const int r = row0 + i;
        const bool ok = r < n_rows_a;
        v.c1r[i] = ok ? c1a[r] : 0.0f;
        v.ipqr[i] = ok && ipqa ? ipqa[r] : 0.0f;
        v.posr[i] = ok && posa ? posa[r] : 0;
    }
    for (int i = threadIdx.x; i < TN; i += NTHREADS) {
        const int c = col0 + i;
        const bool ok = c < n_rows_b;
        v.c1c[i] = ok ? c1b[c] : 0.0f;
        v.ipqc[i] = ok && ipqb ? ipqb[c] : 0.0f;
        v.posc[i] = ok && posb ? posb[c] : 0;
    }
}

// ---- K5: fused count pass ---------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
ld_band_count_kernel(const int8_t* __restrict__ g, const float* __restrict__ c1,
                     const float* __restrict__ ipq, const int* __restrict__ pos,
                     const int* __restrict__ cij, int n_rows, int W,
                     int block_m, int block_n, int n_sub_m, int n_sub_n,
                     int n_hap, float n_f, float inv_n, float thres,
                     int max_dist, int sel, int exact_mask, int use_dist,
                     int* __restrict__ out) {
    __shared__ __align__(16) Smem sm;
    __shared__ RowVecs vec;
    __shared__ int warp_cnt[NTHREADS / 32];
    const SubTile st = decode_subtile(cij, n_sub_m, n_sub_n);
    const int row0 = st.bi * block_m + st.lr0;
    const int col0 = st.bj * block_n + st.lc0;
    // a sub-tile wholly on or above the diagonal keeps nothing
    // (strict lower triangle: col < row); the whole block returns together
    if (col0 >= row0 + min(TM, block_m - st.lr0)) return;

    int acc[MI][NI][4];
    count_tile(sm, g, row0, n_rows, g, col0, n_rows, W, acc);
    stage_vecs(vec, c1, c1, ipq, ipq, pos, pos, row0, n_rows, col0, n_rows);
    __syncthreads();

    int cnt = 0;
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
                if (rg >= n_rows || cg >= n_rows || cg >= rg) continue;
                bool keep;
                if (exact_mask) {
                    keep = exact_keep(acc[mi][ni][e], vec.c1r[r], vec.c1c[c],
                                      n_hap, thres, sel);
                } else {
                    keep = fallback_meas(acc[mi][ni][e], vec.c1r[r],
                                         vec.c1c[c], vec.ipqr[r],
                                         vec.ipqc[c], n_f, inv_n,
                                         sel) >= thres;
                }
                if (use_dist) keep = keep && abs(vec.posr[r] - vec.posc[c]) <= max_dist;
                cnt += keep ? 1 : 0;
            }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
#pragma unroll
        for (int w = 0; w < NTHREADS / 32; ++w) total += warp_cnt[w];
        if (total) atomicAdd(out + st.k, total);
    }
}

// ---- K3: band sweep over a block list ----------------------------------

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
    count_tile(sm, ga, row0, n_rows_a, gb, col0, n_rows_b, W, acc);
    stage_vecs(vec, c1a, c1b, ipqa, ipqb, nullptr, nullptr, row0, n_rows_a,
               col0, n_rows_b);
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

// ---- K1: lower-triangle all-pairs matrix -------------------------------

__global__ void __launch_bounds__(NTHREADS)
ld_triangle_kernel(const int8_t* __restrict__ g, const float* __restrict__ c1,
                   const float* __restrict__ ipq, const int* __restrict__ cij,
                   int n_rows, int W, int block_m, int block_n, int n_sub_m,
                   int n_sub_n, float n_f, float inv_n, int fast,
                   float* __restrict__ r2, float* __restrict__ dp) {
    __shared__ __align__(16) Smem sm;
    __shared__ RowVecs vec;
    const SubTile st = decode_subtile(cij, n_sub_m, n_sub_n);
    const int row0 = st.bi * block_m + st.lr0;
    const int col0 = st.bj * block_n + st.lc0;

    int acc[MI][NI][4];
    count_tile(sm, g, row0, n_rows, g, col0, n_rows, W, acc);
    stage_vecs(vec, c1, c1, ipq, ipq, nullptr, nullptr, row0, n_rows, col0,
               n_rows);
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
                if (fast) {
                    r2[o] = fast_r2(cf, vec.c1r[r], vec.c1c[c], vec.ipqr[r],
                                    vec.ipqc[c], inv_n);
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
// report it).

extern "C" {

int ldk_band_count(const void* g, const void* c1, const void* ipq,
                   const void* pos, const void* cij, int n_blocks,
                   int n_rows, int W, int block_m, int block_n, int n_hap,
                   float n_f, float inv_n, float thres, int max_dist,
                   int sel, int exact_mask, int use_dist, void* out,
                   void* stream) {
    const int sm_ = n_sub(block_m), sn_ = n_sub(block_n);
    ld_band_count_kernel<<<n_blocks * sm_ * sn_, NTHREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(g), static_cast<const float*>(c1),
        static_cast<const float*>(ipq), static_cast<const int*>(pos),
        static_cast<const int*>(cij), n_rows, W, block_m, block_n, sm_, sn_,
        n_hap, n_f, inv_n, thres, max_dist, sel, exact_mask, use_dist,
        static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}

int ldk_band_sweep(const void* ga, const void* gb, const void* c1a,
                   const void* c1b, const void* ipqa, const void* ipqb,
                   const void* cij, int n_blocks, int n_rows_a, int n_rows_b,
                   int W, int block_m, int block_n, float n_f, float inv_n,
                   int sel, void* cab, void* r2, void* dp, void* meas,
                   void* stream) {
    const int sm_ = n_sub(block_m), sn_ = n_sub(block_n);
    ld_band_sweep_kernel<<<n_blocks * sm_ * sn_, NTHREADS, 0,
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
                 int block_m, int block_n, float n_f, float inv_n, int fast,
                 void* r2, void* dp, void* stream) {
    const int sm_ = n_sub(block_m), sn_ = n_sub(block_n);
    ld_triangle_kernel<<<n_blocks * sm_ * sn_, NTHREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(g), static_cast<const float*>(c1),
        static_cast<const float*>(ipq), static_cast<const int*>(cij), n_rows,
        W, block_m, block_n, sm_, sn_, n_f, inv_n, fast,
        static_cast<float*>(r2), static_cast<float*>(dp));
    return static_cast<int>(cudaGetLastError());
}

const char* ldk_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
