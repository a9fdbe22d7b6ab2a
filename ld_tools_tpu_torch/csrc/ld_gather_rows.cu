// The scan's resident built on the card from the store's packed rows:
// ld_gather_rows_kernel.
//
// It replaces no kernel of the JAX package.  There the resident is made on
// the host (ingest/pack.py: pack_columns repacks a cohort's bit columns and
// popcounts takes the alt counts, both NumPy), then inflated to int8 on the
// device by an XLA op (ld_pallas.unpack_rows_device).  This kernel does the
// three in one pass over the store's bytes on the card, so that the host
// only copies them.
//
// For each row of a chunk of the store's raw packed rows (src_bytes bytes a
// row, 8 haplotypes a byte, MSB first as np.packbits writes them) it writes
// that row of the scan's resident, out_width bytes:
//   - dense: int8 {0, 1}, one byte a haplotype;
//   - packed: bytes, MSB first;
// over the column list ``cols`` (a cohort's haplotypes, in its order), or,
// with cols == nullptr, over every bit of the row in order (the full panel:
// a padded copy).  Columns past the list and bytes past the row come out 0,
// as the host's np.zeros plus a copy left them.  counts[r] is the row's alt
// count over the list: the popcount of what it wrote.
//
// Bound: bytes.  Each source byte is read once and each resident byte
// written once: chr21 (1,105,920 rows of 626 bytes in, 640 packed bytes out)
// is 1.40 GB, 0.42 ms at 3.35 TB/s; chr21 in the EUR cohort (1,024 int8 out)
// 1.82 GB, 0.54 ms.  The design:
//   1. One warp a row.  Its lanes copy the row into the warp's slice of
//      shared memory in 16-byte loads of the aligned words that cover it
//      (a row of 626 bytes starts anywhere), so that the column gather
//      reads shared memory and not single bytes of device memory.
//   2. The column list sits in shared memory, loaded once a block (where it
//      fits beside the rows; else it is read through the cache), each 16
//      columns padded to 17 words: lane u reads column 16u + k, and the
//      padding puts the 32 lanes' words in 32 distinct banks.
//   3. A lane makes 16 output bytes at a time (16 int8 haplotypes, or 16
//      packed bytes of 128) and writes them in one 16-byte store: a warp
//      writes 512 contiguous bytes.
//   4. A lane's __popc of what it made, summed over the warp by shuffles,
//      is the row's count; lane 0 writes it.
//   5. A grid-stride loop over the rows, several blocks an SM.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int GATHER_WARPS = 8;                 // rows in flight a block
constexpr int GATHER_SMEM_MAX = 200 * 1024;     // of the 227 KB a block has
constexpr int COL_STRIDE = 17;                  // words a staged 16 columns

// where column c of the list lies: the staged (padded) or the plain list
__device__ __forceinline__ int col_at(const int* cols, int c, bool staged) {
    return staged ? cols[(c >> 4) * COL_STRIDE + (c & 15)] : cols[c];
}

__device__ __forceinline__ unsigned bit_at(const uint8_t* row, unsigned c,
                                           unsigned n_bits) {
    // a column past the row reads 0 (the wrapper's caller checks the list)
    return c < n_bits ? (row[c >> 3] >> (7 - (c & 7))) & 1u : 0u;
}

// byte x's 8 bits, MSB first, as 8 int8 {0, 1} bytes (little-endian words)
__device__ __forceinline__ uint2 spread_byte(unsigned x) {
    const unsigned lo = ((x >> 7) & 1u) | ((x >> 6) & 1u) << 8 |
                        ((x >> 5) & 1u) << 16 | ((x >> 4) & 1u) << 24;
    const unsigned hi = ((x >> 3) & 1u) | ((x >> 2) & 1u) << 8 |
                        ((x >> 1) & 1u) << 16 | (x & 1u) << 24;
    return make_uint2(lo, hi);
}

// Output unit u of a row (16 bytes) into w[4]; returns its set bits.
template <bool DENSE, bool IDENTITY>
__device__ __forceinline__ int make_unit(const uint8_t* row, int src_bytes,
                                         const int* cols, bool staged,
                                         int n_cols, int u, unsigned w[4]) {
    const unsigned n_bits = 8u * static_cast<unsigned>(src_bytes);
    int count = 0;
    if (IDENTITY && DENSE) {
        // columns 16u .. 16u + 15: source bytes 2u and 2u + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int b = 2 * u + h;
            const unsigned x = b < src_bytes ? row[b] : 0u;
            const uint2 s = spread_byte(x);
            w[2 * h] = s.x;
            w[2 * h + 1] = s.y;
            count += __popc(x);
        }
    } else if (IDENTITY) {
        // bytes 16u .. 16u + 15 of the row
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const int b = 16 * u + k;
            const unsigned x = b < src_bytes ? row[b] : 0u;
            w[k >> 2] |= x << (8 * (k & 3));
            count += __popc(x);
        }
    } else if (DENSE) {
        // columns 16u .. 16u + 15 of the list
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const int c = 16 * u + k;
            const unsigned x =
                c < n_cols ? bit_at(row, static_cast<unsigned>(
                                             col_at(cols, c, staged)),
                                    n_bits)
                           : 0u;
            w[k >> 2] |= x << (8 * (k & 3));
            count += x;
        }
    } else {
        // packed bytes 16u .. 16u + 15: columns 128u .. 128u + 127
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            unsigned x = 0;
            const int c0 = 8 * (16 * u + k);
#pragma unroll
            for (int t = 0; t < 8; ++t) {
                const int c = c0 + t;
                if (c < n_cols)
                    x |= bit_at(row,
                                static_cast<unsigned>(col_at(cols, c, staged)),
                                n_bits)
                         << (7 - t);
            }
            w[k >> 2] |= x << (8 * (k & 3));
            count += __popc(x);
        }
    }
    return count;
}

template <bool DENSE, bool IDENTITY>
__global__ void __launch_bounds__(GATHER_WARPS * 32)
ld_gather_rows_kernel(const uint8_t* __restrict__ src, int n_rows,
                      int src_bytes, const int* __restrict__ cols,
                      int n_cols, int cols_smem, int row_smem, int out_width,
                      uint8_t* __restrict__ out, int* __restrict__ counts) {
    extern __shared__ uint4 smem_words[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const int* col = cols;
    const bool staged = !IDENTITY && cols_smem > 0;
    if (staged) {
        int* list = reinterpret_cast<int*>(smem);
        for (int i = threadIdx.x; i < n_cols; i += blockDim.x)
            list[(i >> 4) * COL_STRIDE + (i & 15)] = cols[i];
        col = list;
    }
    __syncthreads();
    uint8_t* slice = smem + cols_smem + warp * row_smem;
    const size_t total = static_cast<size_t>(n_rows) * src_bytes;
    const int n_units = out_width >> 4;
    for (int r = blockIdx.x * warps + warp; r < n_rows;
         r += gridDim.x * warps) {
        // the aligned 16-byte words that cover the row; the last word of
        // the chunk is read byte by byte where it runs past the chunk
        const size_t start = static_cast<size_t>(r) * src_bytes;
        const size_t a0 = start & ~static_cast<size_t>(15);
        const int n_words = static_cast<int>((start + src_bytes - a0 + 15) >> 4);
        for (int i = lane; i < n_words; i += 32) {
            const size_t o = a0 + 16 * static_cast<size_t>(i);
            uint4 v;
            if (o + 16 <= total) {
                v = *reinterpret_cast<const uint4*>(src + o);
            } else {
                unsigned b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                for (int k = 0; k < 16; ++k)
                    if (o + k < total)
                        b[k >> 2] |= static_cast<unsigned>(src[o + k])
                                     << (8 * (k & 3));
                v = make_uint4(b[0], b[1], b[2], b[3]);
            }
            reinterpret_cast<uint4*>(slice)[i] = v;
        }
        __syncwarp();
        const uint8_t* row = slice + (start - a0);
        uint4* dst = reinterpret_cast<uint4*>(
            out + static_cast<size_t>(r) * out_width);
        int count = 0;
        for (int u = lane; u < n_units; u += 32) {
            unsigned w[4] = {0u, 0u, 0u, 0u};
            count += make_unit<DENSE, IDENTITY>(row, src_bytes, col, staged,
                                                n_cols, u, w);
            dst[u] = make_uint4(w[0], w[1], w[2], w[3]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            count += __shfl_xor_sync(0xffffffffu, count, off);
        if (lane == 0) counts[r] = count;
        __syncwarp();  // the slice is read before the next row overwrites it
    }
}

template <bool DENSE, bool IDENTITY>
cudaError_t launch_gather(const uint8_t* src, int n_rows, int src_bytes,
                          const int* cols, int n_cols, int cols_smem,
                          int row_smem, int warps, int out_width, int grid,
                          uint8_t* out, int* counts, cudaStream_t stream) {
    auto kernel = ld_gather_rows_kernel<DENSE, IDENTITY>;
    const int smem = cols_smem + warps * row_smem;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, warps * 32, smem, stream>>>(src, n_rows, src_bytes, cols,
                                               n_cols, cols_smem, row_smem,
                                               out_width, out, counts);
    return cudaGetLastError();
}

}  // namespace

// ---- plain C interface (loaded with ctypes; ops/_cuda_build.py) ------------
// ``src`` holds n_rows rows of src_bytes bytes back to back from a 16-byte
// aligned start; ``cols`` (int32, n_cols of them, each below 8 * src_bytes)
// or null for every bit of the row; ``dense`` 1 writes int8 {0, 1}, 0 packed
// bytes; each of ``out``'s n_rows rows is out_width bytes (a multiple of 16,
// from a 16-byte aligned start) and must hold the list; ``counts`` gets
// n_rows int32.  ``grid`` is the number of thread blocks (the wrapper passes
// a few per SM; the rows are walked grid-stride).  Returns
// cudaErrorInvalidValue without a launch for arguments outside these, or a
// row too long for shared memory.

extern "C" {

int ldk_gather_rows(const void* src, int n_rows, int src_bytes,
                    const void* cols, int n_cols, int dense, int out_width,
                    int grid, void* out, void* counts, void* stream) {
    const bool identity = cols == nullptr;
    const long long bits = identity ? 8LL * src_bytes : n_cols;
    const long long room = dense ? out_width : 8LL * out_width;
    if (n_rows < 0 || src_bytes < 1 || out_width < 16 || out_width % 16 ||
        (dense != 0 && dense != 1) || grid < 1 || !src || !out || !counts ||
        reinterpret_cast<uintptr_t>(src) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16 || (!identity && n_cols < 1) ||
        bits > room)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_rows == 0) return static_cast<int>(cudaSuccess);
    const int row_smem = (src_bytes + 15) / 16 * 16 + 16;
    int cols_smem =
        identity ? 0 : ((n_cols + 15) / 16 * COL_STRIDE * 4 + 15) / 16 * 16;
    if (cols_smem + row_smem > GATHER_SMEM_MAX) cols_smem = 0;
    int warps = (GATHER_SMEM_MAX - cols_smem) / row_smem;
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (warps > GATHER_WARPS) warps = GATHER_WARPS;
    const auto* s = static_cast<const uint8_t*>(src);
    const auto* c = static_cast<const int*>(cols);
    auto* o = static_cast<uint8_t*>(out);
    auto* n = static_cast<int*>(counts);
    const auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (dense && identity)
        err = launch_gather<true, true>(s, n_rows, src_bytes, c, n_cols,
                                        cols_smem, row_smem, warps,
                                        out_width, grid, o, n, st);
    else if (dense)
        err = launch_gather<true, false>(s, n_rows, src_bytes, c, n_cols,
                                         cols_smem, row_smem, warps,
                                         out_width, grid, o, n, st);
    else if (identity)
        err = launch_gather<false, true>(s, n_rows, src_bytes, c, n_cols,
                                         cols_smem, row_smem, warps,
                                         out_width, grid, o, n, st);
    else
        err = launch_gather<false, false>(s, n_rows, src_bytes, c, n_cols,
                                          cols_smem, row_smem, warps,
                                          out_width, grid, o, n, st);
    return static_cast<int>(err);
}

}  // extern "C"
