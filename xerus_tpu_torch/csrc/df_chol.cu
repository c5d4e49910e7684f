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
// at 5.4-6.3 us each on an H100 80GB HBM3, against a 0.15 us bound.  Here
// each loop is one kernel whose operands stay in shared memory, with K1's
// arithmetic (df_arith.cuh): explicit round-to-nearest intrinsics, FMA
// TwoProd, built with -fmad=false.
//
// What bounds them: latency.  Step j of either loop depends on step j - 1;
// the operations (21 FP32 a df multiply-add term: 3.5 B^3 for a block,
// 10.5 m B^2 for a panel) are far below the card's rate for the time a
// chain of B dependent steps takes.  Both kernels run in the right-looking
// order, so that no reduction sits in a step's chain: each step is one
// df_sqrt or df_div and a rank-1 df update that every owner of an entry
// applies to its own entries in place, with no device memory traffic
// inside the loop on the shared-memory routes:
//
// - df_chol_block: one CTA holds the lower triangle in shared memory
//   (row-major, odd row stride), A's entries in the places L's are
//   written.  Thread t owns
//   the lower triangle's entries t, t + 512, ... in column-major order (a
//   column's entries on consecutive threads) and step j walks only those
//   of columns >= j.  Step j, one __syncthreads: the owners of the
//   trailing triangle (k >= j) subtract the update of column j - 1,
//   a_ik -= L_i,j-1 L_k,j-1; the owners of column j also compute the
//   updated diagonal s = a_jj - L_j,j-1^2 (the same operations as its
//   owner, so the same bits), d = df_sqrt(max(s, 1e-30)), and
//   L_ij = df_div(a_ij, d) in place;
//   the owner of (j, j) keeps d apart, since the others read a_jj in the
//   same step.  So a_ik ends as A_ik - sum_{l<k} L_il L_kl, each product
//   subtracted in order of l.  Route gmem, for a block past shared memory
//   (B > 169): the same steps on the block held in place in the output L
//   (global memory, cached in L1 and L2), column-major so that a column's
//   entries are adjacent (row-major it took 10.3 ms at B = 256 on an H100,
//   against 2.08); only the diagonal stays in shared memory.
// - df_trsm_rlt: rows of X are independent, so one warp per row, the row
//   kept in shared memory (A's entries where X's are written) and lane l
//   owning its columns l, l + 32, ...  Step j: one shuffle hands x_j to
//   every lane, each lane subtracts x_j L_kj from its a_k, k > j, and the
//   owner of column j + 1 divides its updated a_j+1 by L_j+1,j+1 before
//   its other updates, so a step's chain is one shuffle, one df
//   multiply-add and one df_div.  L is staged in shared memory whole where
//   it fits and otherwise in tiles of columns (column-major, so the lanes
//   read a column of L contiguously), double-buffered with cp.async (tile
//   t + 1 loads while the warps walk tile t), its diagonal whole beside
//   them.  Route gmem, for a B whose tiles of 8 columns no longer fit
//   (B > 1162): the same steps with L read in place from global memory,
//   eight entries' loads at a time, and each row of X in place in the
//   output.
//
// Every reduction runs in a fixed order, so two launches on the same input
// are bitwise equal, and route gmem computes bitwise what the shared-memory
// routes compute.  The order differs from the plain version's pairwise
// trees, so the results agree to df accuracy, not bitwise;
// xerus_tpu_torch/ops/df_loops.py df_chol_model and df_trsm_model are
// these orders in torch.

#include <cuda_runtime.h>

#include "df_arith.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB, the largest a block can use
constexpr int kBlockThreads = 512;
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
    return 2 * kTrsmWarps * B + 2 * (tiles > 1 ? 2 : 1) * tile * B + 2 * B;
}

struct BlockArgs {
    const float* ah;
    const float* al;
    int lda;
    float* lh;        // (B, B) row-major
    float* ll;
    int B;
};

// The lower triangle's entries in column-major order: column k holds rows
// k, ..., B - 1 and starts at index first(k) = k B - k (k - 1) / 2.
__device__ __forceinline__ int tri_first(int B, int k) {
    return k * B - k * (k - 1) / 2;
}

// The column k of the lower triangle's entry e (first(k) <= e <
// first(k + 1)): the root of first(k) = e, then a step either way.
__device__ __forceinline__ int tri_column(int B, int e) {
    const float b = 2.0f * B + 1.0f;
    int k = (int)((b - sqrtf(b * b - 8.0f * e)) * 0.5f);
    k = max(0, min(k, B - 1));
    while (k + 1 < B && tri_first(B, k + 1) <= e) ++k;
    while (tri_first(B, k) > e) --k;
    return k;
}

// df_chol_block: the lower triangle row-major in shared memory (odd row
// stride), or on route gmem in place in the output, column-major (so that
// a column's entries, on consecutive threads, are adjacent); a
// compile-time choice, so that the loads and stores keep their address
// space.  Thread t owns the lower triangle's entries t, t + 512, ... in
// column-major order; step j walks only those of columns >= j (a suffix
// of that order).
template <bool kGmem>
__global__ void __launch_bounds__(kBlockThreads)
df_chol_block_kernel(BlockArgs a) {
    extern __shared__ float sm[];
    const int B = a.B, ld = kGmem ? B : block_ld(B);
    float* wh = kGmem ? a.lh : sm;
    float* wl = kGmem ? a.ll : sm + B * ld;
    float* dh = kGmem ? sm : sm + 2 * B * ld;   // the diagonal, (B,)
    float* dl = dh + B;
    auto at = [&](int i, int k) { return kGmem ? k * ld + i : i * ld + k; };
    for (int e = threadIdx.x; e < B * B; e += kBlockThreads) {
        const int i = e / B, k = e - i * B;
        if (k > i) continue;
        wh[at(i, k)] = a.ah[(size_t)i * a.lda + k];
        wl[at(i, k)] = a.al[(size_t)i * a.lda + k];
    }
    __syncthreads();
    const int E = tri_first(B, B);
    for (int j = 0; j < B; ++j) {
        // column j - 1 of L, final since step j - 1, and its row j
        df pj = {0.0f, 0.0f};
        if (j > 0) pj = {wh[at(j, j - 1)], wl[at(j, j - 1)]};
        const int s = tri_first(B, j);
        int e = s + (((int)threadIdx.x - s) % kBlockThreads
                     + kBlockThreads) % kBlockThreads;
        for (; e < E; e += kBlockThreads) {
            const int k = tri_column(B, e), i = k + e - tri_first(B, k);
            df v = {wh[at(i, k)], wl[at(i, k)]};
            if (j > 0) {
                const df p = {wh[at(i, j - 1)], wl[at(i, j - 1)]};
                const df q = {wh[at(k, j - 1)], wl[at(k, j - 1)]};
                v = df_sub(v, df_mul(p.h, p.l, q.h, q.l));
            }
            if (k > j) {
                wh[at(i, k)] = v.h;
                wl[at(i, k)] = v.l;
                continue;
            }
            // column j: a_ij / d with d = sqrt(a_jj) (updated the same way)
            df sj = {wh[at(j, j)], wl[at(j, j)]};
            if (j > 0) sj = df_sub(sj, df_mul(pj.h, pj.l, pj.h, pj.l));
            const df d = df_sqrt({fmaxf(sj.h, 1e-30f), sj.l});
            if (i == j) {
                dh[j] = d.h;
                dl[j] = d.l;
            } else {
                const df c = df_div(v, d);
                wh[at(i, j)] = c.h;
                wl[at(i, j)] = c.l;
            }
        }
        __syncthreads();
    }
    // L row-major: below the diagonal first, into places of the
    // column-major block that hold no entry of L (on route gmem); then,
    // once every entry is read, the diagonal and the zeros above it
    for (int e = threadIdx.x; e < B * B; e += kBlockThreads) {
        const int i = e / B, k = e - i * B;
        if (k >= i) continue;
        const float h = wh[at(i, k)], l = wl[at(i, k)];
        a.lh[e] = h;
        a.ll[e] = l;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < B * B; e += kBlockThreads) {
        const int i = e / B, k = e - i * B;
        if (k < i) continue;
        a.lh[e] = k == i ? dh[i] : 0.0f;
        a.ll[e] = k == i ? dl[i] : 0.0f;
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

// columns [t tile, (t + 1) tile) of L, each from its diagonal down,
// column-major in the tile: (k, j) at (j - t tile) B + k
__device__ __forceinline__ void stage_tile(const TrsmArgs& a, float* th,
                                           float* tl, int t) {
    const int j0 = t * a.tile, n = min(a.tile, a.B - j0);
    for (int e = threadIdx.x; e < n * a.B; e += kTrsmThreads) {
        const int k = e / n, jj = e - k * n;
        if (k < j0 + jj) continue;
        const size_t g = (size_t)k * a.ldl + j0 + jj;
        cp_async4(th + jj * a.B + k, a.lh + g);
        cp_async4(tl + jj * a.B + k, a.ll + g);
    }
    cp_async_commit();
}

// Steps j0 <= j < j1 of one row x of X, lane l owning its columns l,
// l + 32, ...: column j of L at (j - j0) cs, its row k at k ks; the
// diagonal entry L_kk at dg k dks.  On entry the owner of column j0 holds
// x_j0 = df_div(a_j0, L_j0j0) in xn.  Step j: one shuffle hands x_j to
// every lane and its owner stores it; each lane subtracts x_j L_kj from
// its a_k, k > j, its first such entry first and then divides it by L_kk
// into xn (the owner of column j + 1: x_j+1, whose chain so starts before
// the lanes' other updates), then the other entries.
template <int kBatch>
__device__ __forceinline__ void trsm_steps(float* xh, float* xl,
                                           const float* lh, const float* ll,
                                           size_t cs, size_t ks,
                                           const float* dgh, const float* dgl,
                                           size_t dks, int j0, int j1, int B,
                                           int lane, df& xn) {
    for (int j = j0; j < j1; ++j) {
        const float* ch = lh + (j - j0) * cs;
        const float* cl = ll + (j - j0) * cs;
        const int own = j & 31;
        const df x = {__shfl_sync(0xffffffffu, xn.h, own),
                      __shfl_sync(0xffffffffu, xn.l, own)};
        if (lane == own) {
            xh[j] = x.h;
            xl[j] = x.l;
        }
        int k = j + 1 + ((lane - j - 1) & 31);
        if (k < B) {
            const df v = df_sub({xh[k], xl[k]},
                                df_mul(x.h, x.l, ch[k * ks], cl[k * ks]));
            xh[k] = v.h;
            xl[k] = v.l;
            xn = df_div(v, {dgh[k * dks], dgl[k * dks]});
        }
        // the other entries, kBatch at a time with their loads first
        for (k += 32; k < B; k += 32 * kBatch) {
            df v[kBatch], c[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int q = k + 32 * u;
                if (q < B) {
                    v[u] = {xh[q], xl[q]};
                    c[u] = {ch[q * ks], cl[q * ks]};
                }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int q = k + 32 * u;
                if (q < B) {
                    v[u] = df_sub(v[u], df_mul(x.h, x.l, c[u].h, c[u].l));
                    xh[q] = v[u].h;
                    xl[q] = v[u].l;
                }
            }
        }
    }
}

__global__ void __launch_bounds__(kTrsmThreads)
df_trsm_rlt_kernel(TrsmArgs a) {
    extern __shared__ float sm[];
    const int B = a.B, T = a.tile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * kTrsmWarps + warp;
    df xn = {0.0f, 0.0f};
    if (T == 0) {   // route gmem: L in place, the row in place in X
        if (row < a.m) {
            float* xh = a.xh + (size_t)row * B;
            float* xl = a.xl + (size_t)row * B;
            for (int k = lane; k < B; k += 32) {
                xh[k] = a.ah[(size_t)row * a.lda + k];
                xl[k] = a.al[(size_t)row * a.lda + k];
            }
            // column j of L at j, its row k at k ldl
            if (lane == 0) xn = df_div({xh[0], xl[0]}, {a.lh[0], a.ll[0]});
            trsm_steps<8>(xh, xl, a.lh, a.ll, 1, a.ldl, a.lh, a.ll,
                          a.ldl + 1, 0, B, B, lane, xn);
        }
        return;
    }
    const int tiles = (B + T - 1) / T;
    float* xh = sm + warp * B;
    float* xl = sm + (kTrsmWarps + warp) * B;
    float* tiles_h = sm + 2 * kTrsmWarps * B;
    float* tiles_l = tiles_h + (tiles > 1 ? 2 : 1) * T * B;
    float* dgh = tiles_l + (tiles > 1 ? 2 : 1) * T * B;   // L's diagonal
    float* dgl = dgh + B;
    if (row < a.m) {
        for (int k = lane; k < B; k += 32) {
            xh[k] = a.ah[(size_t)row * a.lda + k];
            xl[k] = a.al[(size_t)row * a.lda + k];
        }
    }
    for (int k = threadIdx.x; k < B; k += kTrsmThreads) {
        cp_async4(dgh + k, a.lh + (size_t)k * a.ldl + k);
        cp_async4(dgl + k, a.ll + (size_t)k * a.ldl + k);
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
        if (row < a.m) {
            if (t == 0 && lane == 0)
                xn = df_div({xh[0], xl[0]}, {dgh[0], dgl[0]});
            trsm_steps<1>(xh, xl, th, tl, B, 1, dgh, dgl, 1, j0, j1, B,
                          lane, xn);
        }
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
    static size_t checked[2] = {0, 0};
    const size_t bytes = (size_t)smem;
    int rc = gmem ? set_smem(df_chol_block_kernel<true>, bytes,
                             block_floats(B, true), checked[1])
                  : set_smem(df_chol_block_kernel<false>, bytes,
                             block_floats(B, false), checked[0]);
    if (rc != 0) return rc;
    BlockArgs a{ah, al, lda, lh, ll, B};
    auto s = static_cast<cudaStream_t>(stream);
    if (gmem)
        df_chol_block_kernel<true><<<1, kBlockThreads, bytes, s>>>(a);
    else
        df_chol_block_kernel<false><<<1, kBlockThreads, bytes, s>>>(a);
    return (int)cudaGetLastError();
}

// X (m, B), row-major contiguous, with X L^T = A for the (m, B) df A (row
// stride lda) and the lower-triangular (B, B) df L (row stride ldl); L in
// shared memory `tile` columns at a time, or (tile 0, route gmem) read
// in place from global memory.  Same conventions as above.
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
