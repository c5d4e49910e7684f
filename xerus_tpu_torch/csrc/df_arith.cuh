// Double-word float32 ("df") device arithmetic shared by K1 (df_matvec.cu)
// and the column-loop kernels K1q (df_qr.cu) and K1c (df_chol.cu).
//
// A df number is an unevaluated sum h + l of two floats, |l| <= ulp(h)/2.
// Every add, multiply, divide and square root is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn,
// __fsqrt_rn, __fmaf_rn), which the compiler never contracts or
// reassociates; the build passes -fmad=false besides.  TwoProd is the FMA
// form p = a*b, e = fma(a, b, -p), exact on hardware with a fused
// multiply-add.  df_div and df_sqrt follow xerus_tpu_torch/ops/
// mixed_precision.py's df_div and df_sqrt operation for operation.

#pragma once

namespace {

struct df {
    float h, l;
};

__device__ __forceinline__ df two_sum(float a, float b) {
    float s = __fadd_rn(a, b);
    float bb = __fsub_rn(s, a);
    float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
    return {s, e};
}

__device__ __forceinline__ df fast_two_sum(float a, float b) {
    float s = __fadd_rn(a, b);
    return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

__device__ __forceinline__ df two_prod(float a, float b) {
    float p = __fmul_rn(a, b);
    return {p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ df df_add(df x, df y) {
    df s = two_sum(x.h, y.h);
    return fast_two_sum(s.h, __fadd_rn(s.l, __fadd_rn(x.l, y.l)));
}

__device__ __forceinline__ df df_sub(df x, df y) {
    return df_add(x, {-y.h, -y.l});
}

// (ah + al) * (xh + xl), renormalized; the al*xl term is below df precision
__device__ __forceinline__ df df_mul(float ah, float al, float xh, float xl) {
    df p = two_prod(ah, xh);
    float cross = __fadd_rn(__fmul_rn(ah, xl), __fmul_rn(al, xh));
    return fast_two_sum(p.h, __fadd_rn(p.l, cross));
}

// x / y: q1 = xh / yh, the df remainder x - q1 y, one correction
__device__ __forceinline__ df df_div(df x, df y) {
    float q1 = __fdiv_rn(x.h, y.h);
    df p = two_prod(q1, y.h);
    df t = fast_two_sum(p.h, __fadd_rn(p.l, __fmul_rn(q1, y.l)));
    df r = df_sub(x, t);
    return fast_two_sum(q1, __fdiv_rn(r.h, y.h));
}

// sqrt(x) for x.h >= 0: s = sqrt(xh), one Newton correction from x - s^2
__device__ __forceinline__ df df_sqrt(df x) {
    float s = __fsqrt_rn(fmaxf(x.h, 0.0f));
    df r = df_sub(x, two_prod(s, s));
    float e = s > 0.0f ? __fdiv_rn(r.h, fmaxf(__fmul_rn(2.0f, s), 1e-38f))
                       : 0.0f;
    return fast_two_sum(s, e);
}

// df sum over the 32 lanes of a warp, the result in lane 0: a shuffle-down
// tree, lane l adding lane l + off for off = 16, 8, 4, 2, 1
__device__ __forceinline__ df warp_fold(df v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        df o;
        o.h = __shfl_down_sync(0xffffffffu, v.h, off);
        o.l = __shfl_down_sync(0xffffffffu, v.l, off);
        v = df_add(v, o);
    }
    return v;
}

}  // namespace
