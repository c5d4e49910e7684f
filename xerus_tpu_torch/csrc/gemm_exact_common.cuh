// Helpers shared by the two routes of K2 (gemm_exact.cu): working-type
// traits, NaN-propagating max / min, reduction operators, the start
// basis's hash, and the flags layout.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace gemm_exact {

template <typename T> struct Num;
template <> struct Num<float> {
    static __device__ __forceinline__ float mad(float a, float b, float c) {
        return __fmaf_rn(a, b, c);
    }
    static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
    static __device__ __forceinline__ float abs(float x) { return fabsf(x); }
    static __device__ __forceinline__ float inf() {
        return __int_as_float(0x7f800000);
    }
    static constexpr double eps = FLT_EPSILON;
    static constexpr double big = FLT_MAX / 4.0;
};
template <> struct Num<double> {
    static __device__ __forceinline__ double mad(double a, double b, double c) {
        return __fma_rn(a, b, c);
    }
    static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
    static __device__ __forceinline__ double abs(double x) { return fabs(x); }
    static __device__ __forceinline__ double inf() {
        return __longlong_as_double(0x7ff0000000000000LL);
    }
    static constexpr double eps = DBL_EPSILON;
    static constexpr double big = DBL_MAX / 4.0;
};

// NaN-propagating max / min, as jnp.maximum / jnp.minimum / jnp.max
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
    return (a != a || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T nmin(T a, T b) {
    return (a != a || a < b) ? a : b;
}

struct SumOp {
    template <typename T> __device__ T operator()(T a, T b) const { return a + b; }
};
struct MaxOp {
    template <typename T> __device__ T operator()(T a, T b) const { return nmax(a, b); }
};
struct MinOp {
    template <typename T> __device__ T operator()(T a, T b) const { return nmin(a, b); }
};

template <typename T>
__device__ __forceinline__ T mask_of(int j, int keep) {
    return j < keep ? T(1) : T(0);
}

// the start basis's fixed perturbation: int32 hash with wrap-around,
// Python-style modulo, mapped to [-0.5, 0.5)
template <typename T>
__device__ __forceinline__ T start_hash(int i, int j) {
    const uint32_t hu = (uint32_t)i * 40503u + (uint32_t)j * 9973u + 12345u;
    int r = (int)(int32_t)hu % 65536;
    if (r < 0) r += 65536;
    return T(r) / T(65536.0) - T(0.5);
}

// flags[kFlags]: okp, converged, outer iterations, Newton-Schulz
// iterations in all, barriers, CTAs per cluster (0: the grid route),
// Newton-Schulz iterations of the row polar (a part of the total), power
// steps taken again in two stages (float32; two_stage below) and those of
// them that stopped after their first stage
enum Flag { kOkp, kConverged, kOuter, kNs, kBarriers, kClusterCtas, kNsRows,
            kRetries, kRetryStops, kFlags };

// A power step's orthonormalization that ends at max_ns without reaching
// 64 eps is taken again from the same V in two stages, Q1 = orth(Gn V),
// then orth(Gn Q1) (ops/gemm_exact.py _power_orth): the same subspace,
// each stage the conditioning of one product of Gn.  A first stage that
// ends at the cap too stops it, the step keeps its one-stage Q, and no
// later step of the launch retries.  float32 only.
template <typename T>
constexpr bool two_stage = std::is_same<T, float>::value;

template <typename T> struct Args {
    const T* cur;
    int B, M, K, keep;
    int max_outer, max_ns, polish, stall_need;
    T *vt0, *vt_bal;
    int* flags;
};

}  // namespace gemm_exact
