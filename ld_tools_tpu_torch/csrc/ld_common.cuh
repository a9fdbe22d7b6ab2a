// Device code shared by every kernel source: the operand forms of the
// rows and the epilogue and mask functions.  Each count, sweep and
// triangle kernel finishes its exact int32 counts with these functions, so
// every pass of a scan derives its numbers from the same arithmetic.
//
// Build (ops/_cuda_build.py, every csrc/*.cu the same way):
//        nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -std=c++17 -c -Xcompiler -fPIC, linked with -shared.
// -fmad=false is required: the f32 epilogues must round every product and
// sum on its own, exactly as the plain PyTorch versions do op by op, or
// the f32 fallback mask of the count pass and the fetch pass could differ.

#pragma once

namespace {

enum Form : int { FORM_S8 = 0, FORM_BITS = 1, FORM_BF16 = 2, FORM_TF32 = 3 };

// The triangle's epilogues, one a launch.  The r^2 sites use EPI_EXACT and
// EPI_FAST; K8 (scripts/bench_microkernels.py's staged triangle kernel)
// runs all four on int8 rows: the differences between their times split
// the kernel's time into the count and store, one multiply, the
// divide-free r^2 and the exact-order r^2.
enum Epilogue : int {
    EPI_EXACT = 0,   // r^2 (and D' when asked) in the exact order (ld_epilogue)
    EPI_FAST = 1,    // the divide-free r^2 (fast_r2)
    EPI_COUNTS = 2,  // K8's first stage: float(c_ab)
    EPI_SCALE = 3,   // K8's second stage: c_ab * c1[row]
};

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

// The kernel instance for operand form ``form`` (a runtime int), or
// nullptr for a form with no instance.
template <typename Kernel>
Kernel pick(int form, Kernel s8, Kernel bits) {
    switch (form) {
        case FORM_S8: return s8;
        case FORM_BITS: return bits;
        default: return nullptr;
    }
}

}  // namespace
