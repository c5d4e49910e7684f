// K1: double-word float32 ("df") matrix-vector product y = A x on Hopper.
//
// Replaces the Pallas TPU kernel xerus_tpu/ops/pallas_df.py
// (_df_matvec_kernel, entry pallas_df_matvec).  A = (Ah, Al) is an (m, k)
// row-major pair of f32 matrices, x = (xh, xl) a (k,) pair; the result is
// the (m,) pair (yh, yl) with yh + yl = sum_j A[i,j] x[j] to df accuracy
// (about 2^-44 relative).  The caller is the refinement residual of
// xerus_tpu_torch/ops/df32.py df_solve_spd_refined: on the d=32 rank-30
// north-star solve, 132 calls at (1800, 1800) per solve.
//
// What bounds it: memory.  A call reads 2*m*k*4 bytes of A (26 MB at
// 1800 x 1800) once and does about 30 flops per element, under 4 flops per
// byte; the card needs hundreds per byte before arithmetic is the limit.
// The TPU kernel kept a df accumulator in VMEM over k-chunks of a 128-row
// block, walking the chunks in grid order.  Here blocks run in parallel
// and in no order, so the design is one thread block per row: the 256
// threads stride over k with coalesced loads (neighbouring threads read
// neighbouring columns) and keep one df accumulator each, a warp-shuffle
// df_add tree folds each warp, and warp 0 folds the 8 warp sums from
// shared memory.  A is read exactly once and nothing but the (m,) result
// is written; x (14 KB) stays in L1/L2.  No padding: the loop bound masks
// the ragged edge.
//
// Exactness: the df arithmetic is df_arith.cuh's (shared with the column-loop
// kernels df_qr.cu and df_chol.cu): every add and multiply is an explicit
// round-to-nearest intrinsic, and the build passes -fmad=false besides.
// TwoProd is the FMA form p = a*b, e = fma(a, b, -p), exact on hardware
// with a fused multiply-add.

#include <cuda_runtime.h>

#include "df_arith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
df_matvec_kernel(const float* __restrict__ ah, const float* __restrict__ al,
                 const float* __restrict__ xh, const float* __restrict__ xl,
                 float* __restrict__ yh, float* __restrict__ yl, int k) {
    const size_t row = static_cast<size_t>(blockIdx.x) * k;
    const float* arow_h = ah + row;
    const float* arow_l = al + row;
    df acc = {0.0f, 0.0f};
    for (int j = threadIdx.x; j < k; j += kThreads) {
        acc = df_add(acc, df_mul(__ldg(arow_h + j), __ldg(arow_l + j),
                                 __ldg(xh + j), __ldg(xl + j)));
    }
    acc = warp_fold(acc);

    __shared__ float part_h[kWarps];
    __shared__ float part_l[kWarps];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
        part_h[warp] = acc.h;
        part_l[warp] = acc.l;
    }
    __syncthreads();
    if (warp == 0) {
        df v = {0.0f, 0.0f};
        if (lane < kWarps) {
            v.h = part_h[lane];
            v.l = part_l[lane];
        }
        v = warp_fold(v);
        if (lane == 0) {
            yh[blockIdx.x] = v.h;
            yl[blockIdx.x] = v.l;
        }
    }
}

}  // namespace

// y = A x for contiguous f32 buffers on the current device, launched on
// `stream`.  Allocates nothing, does not synchronize; returns the launch's
// cudaGetLastError() code (0 on success).
extern "C" int xerus_df_matvec_f32(const float* ah, const float* al,
                                   const float* xh, const float* xl,
                                   float* yh, float* yl, int m, int k,
                                   void* stream) {
    if (m > 0) {
        df_matvec_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            ah, al, xh, xl, yh, yl, k);
    }
    return static_cast<int>(cudaGetLastError());
}
