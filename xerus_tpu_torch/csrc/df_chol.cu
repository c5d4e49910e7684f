// K1c: the column loops of the blocked double-word float32 ("df") Cholesky
// in one launch each on Hopper, two entries:
//
// - df_chol_block: the unblocked df Cholesky of one (B, B) diagonal block,
//   xerus_tpu_torch/ops/df_cholesky.py _df_chol_unblocked_reference;
// - df_trsm_rlt: the panel substitution X L^T = A for an (m, B) df A and a
//   (B, B) lower-triangular df L, _df_trsm_rlt_reference.
//
// The JAX package runs both as lax.fori_loops of jnp df operations
// (xerus_tpu/ops/df_cholesky.py), one compiled program each; their row
// products are K1's df matvec (xerus_tpu/ops/pallas_df.py,
// _df_matvec_kernel).  Run eagerly, each column step is one K1 launch and
// about 25 small torch operations: 13,112 launches per d=32 df rounding
// at 5.4-6.3 us each on an H100 80GB HBM3, against a 0.15 us bound.  Here each loop is one kernel
// whose operands stay in shared memory, and each step's row product is
// K1's arithmetic (df_arith.cuh): explicit round-to-nearest intrinsics,
// FMA TwoProd, built with -fmad=false.
//
// What bounds them: latency.  Step j of either loop depends on step j - 1,
// and each step is a short df dot product (at most B terms), a shuffle fold
// and a df division; the operations (21 FP32 a df multiply-add term:
// 3.5 B^3 for a block, 10.5 m B^2 for a panel) are far below the card's
// rate for the time a chain of B dependent steps takes.  The design pays
// one barrier per step and no device memory traffic inside the loop:
//
// - df_chol_block: one CTA holds the block in shared memory (row-major, odd
//   row stride), A's entries in the places L's are written: step j reads
//   only L's columns before j.  Every warp computes s_j = A_jj - L_j. L_j.
//   and d = df_sqrt(max(s_j, 1e-30)) itself (the same order in every warp,
//   so the same d), then the rows i > j it owns:
//   L_ij = df_div(A_ij - L_i. L_j., d).  One __syncthreads per column.
//   Route gmem, for a block past shared memory (B > 169): the same steps
//   on the block held in place in the output L (global memory, cached in
//   L1 and L2); only the diagonal stays in shared memory.
// - df_trsm_rlt: rows of X are independent, so one warp per row, the row
//   kept in shared memory (A's entries where X's are written).  L is
//   staged in shared memory whole where it fits and otherwise in row tiles,
//   double-buffered with cp.async (tile t + 1 loads while the warps walk
//   tile t).  Step j: the warp's dot of X_i.[:j] with L_j.[:j], df_sub,
//   df_div by L_jj; __syncwarp between steps.  Route gmem, for a B whose
//   tiles of 8 rows no longer fit (B > 1210): the same steps with the row
//   held in place in the output X and L read from global memory.
//
// Every reduction runs in a fixed order, so two launches on the same input
// are bitwise equal.  The order differs from the plain version's pairwise
// trees, so the results agree to df accuracy, not bitwise.

#include <cuda_runtime.h>

#include "df_arith.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB, the largest a block can use
constexpr int kBlockThreads = 512;
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kTrsmWarps = 8;      // rows of X per CTA
constexpr int kTrsmThreads = 32 * kTrsmWarps;

// Shared-memory sizes in floats.  xerus_tpu_torch/ops/df_loops.py sizes
// the launches; each launch checks that its size covers these.
__host__ __device__ inline int block_ld(int B) { return B | 1; }
__host__ __device__ inline int block_floats(int B, bool gmem) {
    return (gmem ? 0 : 2 * B * block_ld(B)) + 2 * B;
}
__host__ __device__ inline int trsm_floats(int B, int tile) {
    if (tile == 0) return 0;   // route gmem
    const int tiles = (B + tile - 1) / tile;
    return 2 * kTrsmWarps * B + 2 * (tiles > 1 ? 2 : 1) * tile * B;
}

struct BlockArgs {
    const float* ah;
    const float* al;
    int lda;
    float* lh;        // (B, B) row-major
    float* ll;
    int B;
    int gmem;         // the block in place in lh / ll, not in shared memory
};

__global__ void __launch_bounds__(kBlockThreads)
df_chol_block_kernel(BlockArgs a) {
    extern __shared__ float sm[];
    const int B = a.B, ld = a.gmem ? B : block_ld(B);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* wh = a.gmem ? a.lh : sm;
    float* wl = a.gmem ? a.ll : wh + B * ld;
    float* dh = a.gmem ? sm : wl + B * ld;   // the diagonal, (B,)
    float* dl = dh + B;
    for (int e = threadIdx.x; e < B * B; e += kBlockThreads) {
        const int i = e / B, k = e - i * B;
        wh[i * ld + k] = a.ah[(size_t)i * a.lda + k];
        wl[i * ld + k] = a.al[(size_t)i * a.lda + k];
    }
    __syncthreads();
    for (int j = 0; j < B; ++j) {
        const float* jh = wh + j * ld;
        const float* jl = wl + j * ld;
        df acc = {0.0f, 0.0f};
        for (int k = lane; k < j; k += 32)
            acc = df_add(acc, df_mul(jh[k], jl[k], jh[k], jl[k]));
        acc = warp_fold(acc);
        acc.h = __shfl_sync(0xffffffffu, acc.h, 0);
        acc.l = __shfl_sync(0xffffffffu, acc.l, 0);
        const df s = df_sub({jh[j], jl[j]}, acc);
        const df d = df_sqrt({fmaxf(s.h, 1e-30f), s.l});
        if (threadIdx.x == 0) {
            dh[j] = d.h;
            dl[j] = d.l;
        }
        for (int i = j + 1 + warp; i < B; i += kBlockWarps) {
            float* ih = wh + i * ld;
            float* il = wl + i * ld;
            df t = {0.0f, 0.0f};
            for (int k = lane; k < j; k += 32)
                t = df_add(t, df_mul(ih[k], il[k], jh[k], jl[k]));
            t = warp_fold(t);
            if (lane == 0) {
                const df c = df_div(df_sub({ih[j], il[j]}, t), d);
                ih[j] = c.h;
                il[j] = c.l;
            }
        }
        __syncthreads();
    }
    // in place on route gmem: each thread rewrites only what it read
    for (int e = threadIdx.x; e < B * B; e += kBlockThreads) {
        const int i = e / B, k = e - i * B;
        float h = 0.0f, l = 0.0f;
        if (k < i) {
            h = wh[i * ld + k];
            l = wl[i * ld + k];
        } else if (k == i) {
            h = dh[i];
            l = dl[i];
        }
        a.lh[e] = h;
        a.ll[e] = l;
    }
}

struct TrsmArgs {
    const float* ah;
    const float* al;
    int lda;
    const float* lh;
    const float* ll;
    int ldl;
    float* xh;        // (m, B) row-major
    float* xl;
    int m, B, tile;   // tile 0: route gmem
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [t tile, (t + 1) tile) of L, each up to and including its diagonal
__device__ __forceinline__ void stage_tile(const TrsmArgs& a, float* th,
                                           float* tl, int t) {
    const int j0 = t * a.tile, n = min(a.tile, a.B - j0);
    for (int e = threadIdx.x; e < n * a.B; e += kTrsmThreads) {
        const int rr = e / a.B, k = e - rr * a.B;
        if (k > j0 + rr) continue;
        const size_t g = (size_t)(j0 + rr) * a.ldl + k;
        cp_async4(th + e, a.lh + g);
        cp_async4(tl + e, a.ll + g);
    }
    cp_async_commit();
}

// Steps j0 <= j < j1 of one row x of X: row j of L at lrh + (j - j0) ld.
__device__ __forceinline__ void trsm_steps(float* xh, float* xl,
                                           const float* lh, const float* ll,
                                           size_t ld, int j0, int j1,
                                           int lane) {
    for (int j = j0; j < j1; ++j) {
        const float* lrh = lh + (j - j0) * ld;
        const float* lrl = ll + (j - j0) * ld;
        df acc = {0.0f, 0.0f};
        for (int k = lane; k < j; k += 32)
            acc = df_add(acc, df_mul(xh[k], xl[k], lrh[k], lrl[k]));
        acc = warp_fold(acc);
        if (lane == 0) {
            const df c = df_div(df_sub({xh[j], xl[j]}, acc),
                                {lrh[j], lrl[j]});
            xh[j] = c.h;
            xl[j] = c.l;
        }
        __syncwarp();
    }
}

__global__ void __launch_bounds__(kTrsmThreads)
df_trsm_rlt_kernel(TrsmArgs a) {
    extern __shared__ float sm[];
    const int B = a.B, T = a.tile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * kTrsmWarps + warp;
    if (T == 0) {   // route gmem: the row in place in X, L from global
        if (row < a.m) {
            float* xh = a.xh + (size_t)row * B;
            float* xl = a.xl + (size_t)row * B;
            for (int k = lane; k < B; k += 32) {
                xh[k] = a.ah[(size_t)row * a.lda + k];
                xl[k] = a.al[(size_t)row * a.lda + k];
            }
            __syncwarp();
            trsm_steps(xh, xl, a.lh, a.ll, a.ldl, 0, B, lane);
        }
        return;
    }
    const int tiles = (B + T - 1) / T;
    float* xh = sm + warp * B;
    float* xl = sm + (kTrsmWarps + warp) * B;
    float* tiles_h = sm + 2 * kTrsmWarps * B;
    float* tiles_l = tiles_h + (tiles > 1 ? 2 : 1) * T * B;
    if (row < a.m) {
        for (int k = lane; k < B; k += 32) {
            xh[k] = a.ah[(size_t)row * a.lda + k];
            xl[k] = a.al[(size_t)row * a.lda + k];
        }
    }
    stage_tile(a, tiles_h, tiles_l, 0);
    for (int t = 0; t < tiles; ++t) {
        if (t + 1 < tiles) {
            const int nb = (t + 1) & 1;
            stage_tile(a, tiles_h + nb * T * B, tiles_l + nb * T * B, t + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* th = tiles_h + (t & 1) * T * B;
        const float* tl = tiles_l + (t & 1) * T * B;
        const int j0 = t * T, j1 = min(B, j0 + T);
        if (row < a.m) trsm_steps(xh, xl, th, tl, B, j0, j1, lane);
        // every warp is done with this buffer before tile t + 2 lands in it
        __syncthreads();
    }
    if (row < a.m) {
        for (int k = lane; k < B; k += 32) {
            a.xh[(size_t)row * B + k] = xh[k];
            a.xl[(size_t)row * B + k] = xl[k];
        }
    }
}

// `bytes` given by the caller must cover `need` floats and fit a block.
template <typename Kern>
int set_smem(Kern kern, size_t bytes, int need, size_t& checked) {
    if ((size_t)need * sizeof(float) > bytes || bytes > (size_t)kMaxSmem)
        return (int)cudaErrorInvalidValue;
    if (bytes > checked) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
        checked = bytes;
    }
    return 0;
}

}  // namespace

// L (B, B), row-major contiguous, lower-triangular, of the (B, B) SPD df
// block A with row stride lda, on `stream`, with the block in shared
// memory (gmem 0) or in place in L (gmem 1) and `smem` bytes of dynamic
// shared memory.  Allocates nothing, does not synchronize; returns the
// launch's error code (0 on success, cudaErrorInvalidValue for a size that
// does not cover the route's layout).
extern "C" int xerus_df_chol_block(const float* ah, const float* al, int lda,
                                   float* lh, float* ll, int B, int gmem,
                                   int smem, void* stream) {
    if (B <= 0) return 0;
    static size_t checked = 0;
    const size_t bytes = (size_t)smem;
    int rc = set_smem(df_chol_block_kernel, bytes,
                      block_floats(B, gmem != 0), checked);
    if (rc != 0) return rc;
    BlockArgs a{ah, al, lda, lh, ll, B, gmem != 0};
    df_chol_block_kernel<<<1, kBlockThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// X (m, B), row-major contiguous, with X L^T = A for the (m, B) df A (row
// stride lda) and the lower-triangular (B, B) df L (row stride ldl); L in
// shared memory `tile` rows at a time, or (tile 0, route gmem) read from
// global memory.  Same conventions as above.
extern "C" int xerus_df_trsm_rlt(const float* ah, const float* al, int lda,
                                 const float* lh, const float* ll, int ldl,
                                 float* xh, float* xl, int m, int B, int tile,
                                 int smem, void* stream) {
    if (m <= 0 || B <= 0) return 0;
    if (tile < 0 || tile > B) return (int)cudaErrorInvalidValue;
    static size_t checked = 0;
    const size_t bytes = (size_t)smem;
    int rc = set_smem(df_trsm_rlt_kernel, bytes, trsm_floats(B, tile),
                      checked);
    if (rc != 0) return rc;
    TrsmArgs a{ah, al, lda, lh, ll, ldl, xh, xl, m, B, tile};
    const int grid = (m + kTrsmWarps - 1) / kTrsmWarps;
    df_trsm_rlt_kernel<<<grid, kTrsmThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}
