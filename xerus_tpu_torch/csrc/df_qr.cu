// K1q: the CGS2 double-word float32 ("df") thin QR of an (m, r) matrix in
// one launch on Hopper.
//
// The JAX package runs this loop as one lax.fori_loop of jnp df operations
// (xerus_tpu/ops/mixed_precision.py df_qr), compiled into one program; its
// row products are the df matvec of K1 (xerus_tpu/ops/pallas_df.py,
// _df_matvec_kernel).  Run eagerly, each column is four df matvecs and
// about 300 small torch operations, so the loop is bound by launches:
// 260 ms on an H100 80GB HBM3 for the (60, 30) factor of the Poisson
// solve, against a few microseconds of arithmetic.  Here the whole loop is one kernel that keeps
// its operands on chip and computes each step's row products with K1's
// arithmetic (df_arith.cuh).
//
// What it computes, column by column, is xerus_tpu_torch/ops/
// mixed_precision.py df_qr_reference: two projection rounds c = Q^T v,
// p = Q c, v -= p, coef += c; the df norm n of v; the test
// n <= max(1e-12 orig_norm, 1e-13 mat_scale) + 1e-30; for a deficient
// column the projected canonical vector e_{j mod m} (the plain version
// computes both branches and selects, this kernel computes the fallback
// only where the test holds: the result is the same); the reciprocal
// df_div(1, max(n, 1e-20)) and then the product, never a division of v by
// n; the R column with the diagonal zeroed where the column is deficient.
// mat_scale and orig_norm are plain f32 sums (they only set a threshold).
//
// What bounds it: latency.  A column is a chain of dependent steps (two
// reductions per projection round, one per norm), so the work of
// 42 m r^2 FP32 operations is far below what the card could do in the time.
// The design keeps every operand in shared memory and pays one barrier per
// dependent step:
//
// - route cta (one thread block): when Q, v and R's column fit one CTA's
//   shared memory.  Q lives in shared memory in the columns of A it
//   replaces: column j holds A's column j until step j writes Q's (the
//   projections read only the columns before j).  Column-major with an odd
//   column stride, so both the warp-per-column reduction of Q^T v and the
//   warp-per-row reduction of Q c read without bank conflicts.
// - route cluster (one 16-CTA thread-block cluster): when Q only fits across
//   the cluster's shared memory.  CTA b holds the band of rows
//   [b ceil(m/16), (b+1) ceil(m/16)).  Q^T v is a band partial, reduced
//   through distributed shared memory: each partial c_i goes to the CTA
//   that owns i (i mod 16), which sums the 16 partials in band order and
//   pushes the sum to every CTA (reduce-scatter, cluster barrier,
//   all-gather, cluster barrier).  Only r-vectors cross the cluster, never
//   bands.  p = Q c and v -= p stay in the band.  The norm and orig_norm
//   take one pushed scalar triple per CTA and one barrier.
// - route gmem (the cluster route with Q in global memory): when a band of
//   Q does not fit a CTA's shared memory (a (1024, 512) factor).  Each CTA
//   keeps its band of Q in its own part of a global workspace, L2-resident
//   at these sizes, and only the vectors in shared memory; the steps, the
//   exchanges and their orders are the cluster route's, so its results are
//   bitwise the cluster route's.  Only this CTA's threads touch its band,
//   so the block barriers order its accesses.
//
// Every reduction runs in a fixed order (lanes over rows or columns, the
// shuffle-down fold, warps in order, bands in order), so two launches on
// the same input are bitwise equal.  The order differs from the plain
// version's pairwise trees, so the results agree to df accuracy, not
// bitwise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "df_arith.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCtas = 16;
constexpr int kMaxSmem = 232448;   // 227 KB, the largest a block can use
constexpr int kUnschedulable = 1000;
enum Route { kCta = 0, kCluster = 1, kGmem = 2 };

// Shared-memory layout in floats.  xerus_tpu_torch/ops/df_loops.py
// (df_qr_plan) sizes the launch; the launch checks that its size covers
// this layout.
struct Layout {
    int rows;    // rows of this CTA's band (route cta: all m)
    int ld;      // column stride of the band: rows rounded up to odd
    int slots;   // reduce-scatter slots a CTA owns: ceil(r / 16)
    int wh, wl;  // (ld, r) column-major: Q in columns < j, A's columns after
                 // (route gmem: in the global workspace, not here)
    int vh, vl;  // the column being orthogonalized, (ld,)
    int ch, cl;  // c = Q^T v, (r,)
    int oh, ol;  // coef, the R column, (r,)
    int red;     // per-warp partials: h, l, f32 (3 kWarps)
    int colsq;   // per-column sum of squares of A's high words, (r,)
    int part;    // route cluster: [16 sources][slots] df partials
    int nrm;     // route cluster: [16 sources] (h, l, orig) + pad
    int total;
};

__host__ __device__ inline Layout layout(int m, int r, int route) {
    const bool cluster = route != kCta;
    Layout L;
    L.rows = cluster ? (m + kCtas - 1) / kCtas : m;
    L.ld = L.rows | 1;
    L.slots = (r + kCtas - 1) / kCtas;
    int o = 0;
    const int band = route == kGmem ? 0 : L.ld * r;
    L.wh = o; o += band;
    L.wl = o; o += band;
    L.vh = o; o += L.ld;
    L.vl = o; o += L.ld;
    L.ch = o; o += r;
    L.cl = o; o += r;
    L.oh = o; o += r;
    L.ol = o; o += r;
    L.red = o; o += 3 * kWarps;
    L.colsq = o; o += r;
    L.part = o; o += cluster ? 2 * kCtas * L.slots : 0;
    L.nrm = o; o += cluster ? 4 * kCtas : 0;
    L.total = o;
    return L;
}

struct Args {
    const float* ah;
    const float* al;
    int lda;          // row stride of A (columns are unit-stride)
    float* qh;        // (m, r) row-major
    float* ql;
    float* rh;        // (r, r) row-major
    float* rl;
    float* stats;     // (r, 2) per column: n.h and the threshold; or null
    float* work;      // route gmem: 16 bands of 2 ld r floats; else null
    int m, r, route;
};

template <bool kCluster>
struct Ctx {
    float* sm;
    float* wh;        // this CTA's band of Q / A: shared or global memory
    float* wl;
    Layout L;
    int cr;           // rank in the cluster (0 on route cta)
    int row0, nrows;  // this CTA's band

    __device__ float* at(int off) const { return sm + off; }

    __device__ void cluster_sync() const {
        if constexpr (kCluster) cg::this_cluster().sync();
    }
    __device__ float* remote(float* p, int rank) const {
        if constexpr (kCluster) {
            return cg::this_cluster().map_shared_rank(p, rank);
        } else {
            return p;
        }
    }
};

// c[i] = sum over rows of Q[k, i] src[k] for i < j, in every CTA.  Each
// warp takes columns i = warp, warp + 16, ...; its lanes rows k = lane,
// lane + 32, ... of the band, then the shuffle fold.  Route cta: lane 0
// writes c[i].  Route cluster: lane 0 pushes the band partial into slot
// [cr][i / 16] of CTA i mod 16; after the barrier each owner folds its
// slots over the 16 bands in order and pushes the sum into every CTA's c.
// Ends with c complete in every CTA (a barrier).
template <bool kCluster>
__device__ void project_coefs(const Ctx<kCluster>& x, const float* srch,
                              const float* srcl, int j) {
    const Layout& L = x.L;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* wh = x.wh;
    const float* wl = x.wl;
    float* ch = x.at(L.ch);
    float* cl = x.at(L.cl);
    for (int i = warp; i < j; i += kWarps) {
        df acc = {0.0f, 0.0f};
        for (int k = lane; k < x.nrows; k += 32)
            acc = df_add(acc, df_mul(wh[i * L.ld + k], wl[i * L.ld + k],
                                     srch[k], srcl[k]));
        acc = warp_fold(acc);
        if (lane == 0) {
            if constexpr (kCluster) {
                float* dst = x.remote(x.at(L.part), i % kCtas)
                             + 2 * (x.cr * L.slots + i / kCtas);
                dst[0] = acc.h;
                dst[1] = acc.l;
            } else {
                ch[i] = acc.h;
                cl[i] = acc.l;
            }
        }
    }
    if constexpr (kCluster) {
        x.cluster_sync();
        // thread (s, dst): the owner's slot s, pushed to CTA dst
        const float* part = x.at(L.part);
        for (int e = threadIdx.x; e < L.slots * kCtas; e += kThreads) {
            const int s = e / kCtas, dst = e - s * kCtas;
            const int i = s * kCtas + x.cr;
            if (i >= j) continue;
            df acc = {0.0f, 0.0f};
            for (int b = 0; b < kCtas; ++b)
                acc = df_add(acc, {part[2 * (b * L.slots + s)],
                                   part[2 * (b * L.slots + s) + 1]});
            x.remote(ch, dst)[i] = acc.h;
            x.remote(cl, dst)[i] = acc.l;
        }
        x.cluster_sync();
    } else {
        __syncthreads();
    }
}

// v[k] = src[k] - sum_{i<j} Q[k, i] c[i] for the band's rows: a warp per
// row, lanes over i, the shuffle fold; with `accumulate`, coef += c.
// Ends with a block barrier.
template <bool kCluster>
__device__ void project_out(const Ctx<kCluster>& x, const float* srch,
                            const float* srcl, int j, bool accumulate) {
    const Layout& L = x.L;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* wh = x.wh;
    const float* wl = x.wl;
    const float* ch = x.at(L.ch);
    const float* cl = x.at(L.cl);
    float* vh = x.at(L.vh);
    float* vl = x.at(L.vl);
    for (int k = warp; k < x.nrows; k += kWarps) {
        df acc = {0.0f, 0.0f};
        for (int i = lane; i < j; i += 32)
            acc = df_add(acc, df_mul(wh[i * L.ld + k], wl[i * L.ld + k],
                                     ch[i], cl[i]));
        acc = warp_fold(acc);
        if (lane == 0) {
            df v = df_sub({srch[k], srcl[k]}, acc);
            vh[k] = v.h;
            vl[k] = v.l;
        }
    }
    if (accumulate) {
        float* oh = x.at(L.oh);
        float* ol = x.at(L.ol);
        for (int i = threadIdx.x; i < j; i += kThreads) {
            df o = df_add({oh[i], ol[i]}, {ch[i], cl[i]});
            oh[i] = o.h;
            ol[i] = o.l;
        }
    }
    __syncthreads();
}

// One projection round of src against Q's first j columns into v.
template <bool kCluster>
__device__ void project(const Ctx<kCluster>& x, const float* srch,
                        const float* srcl, int j, bool accumulate) {
    if (j > 0) project_coefs(x, srch, srcl, j);
    project_out(x, srch, srcl, j, accumulate);
}

// The df norm of v over all rows, in every thread: each thread sums rows
// tid, tid + 512, ...; the shuffle fold; the 16 warp partials in order;
// route cluster: the 16 band sums in order.  `orig` carries a plain f32
// per-warp partial (red[2 kWarps + warp], 0 where not wanted) along, summed
// in the same orders.  Starts and ends with barriers as needed.
template <bool kCluster>
__device__ df norm_all(const Ctx<kCluster>& x, float* orig) {
    const Layout& L = x.L;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* vh = x.at(L.vh);
    const float* vl = x.at(L.vl);
    float* red = x.at(L.red);
    df acc = {0.0f, 0.0f};
    for (int k = threadIdx.x; k < x.nrows; k += kThreads)
        acc = df_add(acc, df_mul(vh[k], vl[k], vh[k], vl[k]));
    acc = warp_fold(acc);
    if (lane == 0) {
        red[warp] = acc.h;
        red[kWarps + warp] = acc.l;
    }
    __syncthreads();
    df band = {0.0f, 0.0f};
    float o = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
        band = df_add(band, {red[w], red[kWarps + w]});
        o = __fadd_rn(o, red[2 * kWarps + w]);
    }
    if constexpr (kCluster) {
        float* nrm = x.at(L.nrm);
        if (threadIdx.x < kCtas) {
            float* dst = x.remote(nrm, threadIdx.x) + 4 * x.cr;
            dst[0] = band.h;
            dst[1] = band.l;
            dst[2] = o;
        }
        x.cluster_sync();
        band = {0.0f, 0.0f};
        o = 0.0f;
        for (int b = 0; b < kCtas; ++b) {
            band = df_add(band, {nrm[4 * b], nrm[4 * b + 1]});
            o = __fadd_rn(o, nrm[4 * b + 2]);
        }
    } else {
        // no thread rewrites red before every thread has read it
        __syncthreads();
    }
    *orig = o;
    return df_sqrt(band);
}

template <bool kCluster>
__global__ void __launch_bounds__(kThreads, 1) df_qr_kernel(Args a) {
    extern __shared__ float sm[];
    Ctx<kCluster> x;
    x.sm = sm;
    x.L = layout(a.m, a.r, a.route);
    const Layout& L = x.L;
    x.cr = 0;
    if constexpr (kCluster) x.cr = (int)cg::this_cluster().block_rank();
    x.row0 = x.cr * L.rows;
    x.nrows = max(0, min(L.rows, a.m - x.row0));
    const int r = a.r;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (a.route == kGmem) {
        x.wh = a.work + (size_t)x.cr * 2 * L.ld * r;
        x.wl = x.wh + (size_t)L.ld * r;
    } else {
        x.wh = x.at(L.wh);
        x.wl = x.at(L.wl);
    }
    float* wh = x.wh;
    float* wl = x.wl;
    float* vh = x.at(L.vh);
    float* vl = x.at(L.vl);
    float* red = x.at(L.red);

    // the band of A, column-major
    for (int e = threadIdx.x; e < x.nrows * r; e += kThreads) {
        const int k = e / r, i = e - k * r;
        const size_t g = (size_t)(x.row0 + k) * a.lda + i;
        wh[i * L.ld + k] = a.ah[g];
        wl[i * L.ld + k] = a.al[g];
    }
    __syncthreads();

    // mat_scale = sqrt(max over columns of sum over rows of ah^2), plain f32
    float* colsq = x.at(L.colsq);
    for (int i = warp; i < r; i += kWarps) {
        float s = 0.0f;
        for (int k = lane; k < x.nrows; k += 32)
            s = __fadd_rn(s, __fmul_rn(wh[i * L.ld + k], wh[i * L.ld + k]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
        if (lane == 0) colsq[i] = s;
    }
    __syncthreads();
    x.cluster_sync();
    float big = 0.0f;
    for (int i = threadIdx.x; i < r; i += kThreads) {
        float s = colsq[i];
        if constexpr (kCluster) {
            s = 0.0f;
            for (int b = 0; b < kCtas; ++b)
                s = __fadd_rn(s, x.remote(colsq, b)[i]);
        }
        big = fmaxf(big, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
    if (lane == 0) red[warp] = big;
    __syncthreads();
    big = 0.0f;
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, red[w]);
    const float mat_scale = __fsqrt_rn(big);
    __syncthreads();

    float* oh = x.at(L.oh);
    float* ol = x.at(L.ol);
    for (int j = 0; j < r; ++j) {
        const float* colh = wh + j * L.ld;
        const float* coll = wl + j * L.ld;
        // coef = 0; orig_norm's per-warp partials
        for (int i = threadIdx.x; i < r; i += kThreads) {
            oh[i] = 0.0f;
            ol[i] = 0.0f;
        }
        float o = 0.0f;
        for (int k = threadIdx.x; k < x.nrows; k += kThreads)
            o = __fadd_rn(o, __fmul_rn(colh[k], colh[k]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            o = __fadd_rn(o, __shfl_down_sync(0xffffffffu, o, off));
        if (lane == 0) red[2 * kWarps + warp] = o;
        __syncthreads();

        // two rounds of projection: from A's column, then from v
        project(x, colh, coll, j, true);
        project(x, vh, vl, j, true);
        float orig_sq;
        df n = norm_all(x, &orig_sq);
        const float orig_norm = __fadd_rn(__fsqrt_rn(orig_sq), 1e-38f);
        const float thr = __fadd_rn(fmaxf(__fmul_rn(1e-12f, orig_norm),
                                          __fmul_rn(1e-13f, mat_scale)),
                                    1e-30f);
        const bool deficient = n.h <= thr;
        if (a.stats != nullptr && x.cr == 0 && threadIdx.x == 0) {
            a.stats[2 * j] = n.h;
            a.stats[2 * j + 1] = thr;
        }
        df n2 = n;
        if (deficient) {   // uniform: every thread of every CTA alike
            // no CTA pushes the next norm before every CTA has read this one
            x.cluster_sync();
            const int e = j % a.m;
            for (int k = threadIdx.x; k < x.nrows; k += kThreads) {
                vh[k] = (x.row0 + k == e) ? 1.0f : 0.0f;
                vl[k] = 0.0f;
            }
            for (int w = threadIdx.x; w < kWarps; w += kThreads)
                red[2 * kWarps + w] = 0.0f;
            __syncthreads();
            project(x, vh, vl, j, false);
            float unused;
            n2 = norm_all(x, &unused);
            n = {0.0f, 0.0f};
        }
        const df inv = df_div({1.0f, 0.0f}, {fmaxf(n2.h, 1e-20f), n2.l});
        for (int k = threadIdx.x; k < x.nrows; k += kThreads) {
            const df q = df_mul(vh[k], vl[k], inv.h, inv.l);
            wh[j * L.ld + k] = q.h;
            wl[j * L.ld + k] = q.l;
            const size_t g = (size_t)(x.row0 + k) * r + j;
            a.qh[g] = q.h;
            a.ql[g] = q.l;
        }
        if (x.cr == 0) {
            for (int i = threadIdx.x; i < r; i += kThreads) {
                df v = i < j ? df{oh[i], ol[i]}
                             : (i == j ? n : df{0.0f, 0.0f});
                a.rh[(size_t)i * r + j] = v.h;
                a.rl[(size_t)i * r + j] = v.l;
            }
        }
        __syncthreads();
    }
    // no CTA leaves while another may still touch its shared memory
    x.cluster_sync();
}

template <bool kCluster>
int launch(const Args& a, size_t bytes, cudaStream_t stream) {
    const Layout L = layout(a.m, a.r, a.route);
    if ((size_t)L.total * sizeof(float) > bytes || bytes > (size_t)kMaxSmem)
        return (int)cudaErrorInvalidValue;
    static size_t checked = 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster ? kCtas : 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster ? kCtas : 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = kCluster ? 1 : 0;
    cudaError_t e;
    if (bytes > checked) {
        if (kCluster) {
            e = cudaFuncSetAttribute(
                df_qr_kernel<kCluster>,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (e != cudaSuccess) return (int)e;
        }
        e = cudaFuncSetAttribute(df_qr_kernel<kCluster>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
        if (e != cudaSuccess) return (int)e;
        if (kCluster) {
            int clusters = 0;
            e = cudaOccupancyMaxActiveClusters(&clusters,
                                               df_qr_kernel<kCluster>, &cfg);
            if (e != cudaSuccess) return (int)e;
            if (clusters < 1) return kUnschedulable;
        }
        checked = bytes;
    }
    e = cudaLaunchKernelEx(&cfg, df_qr_kernel<kCluster>, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// Q (m, r) and R (r, r), row-major contiguous, of the (m, r) df matrix A
// with row stride lda, on `stream`, by `route` (0 cta, 1 cluster, 2 gmem)
// with `smem` bytes of dynamic shared memory per CTA; stats (r, 2) or
// null; work (route gmem) 32 ld r floats for ld = ceil(m / 16) | 1, of
// which `work_floats` are given.  Allocates nothing, does not synchronize;
// returns the launch's error code (0 on success, 1000 for a cluster the
// card cannot schedule, cudaErrorInvalidValue for a size that does not
// cover the route's layout).
extern "C" int xerus_df_qr(const float* ah, const float* al, int lda,
                           float* qh, float* ql, float* rh, float* rl,
                           float* stats, float* work, long long work_floats,
                           int m, int r, int route, int smem,
                           void* stream) {
    Args a{ah, al, lda, qh, ql, rh, rl, stats, work, m, r, route};
    if (m <= 0 || r <= 0) return 0;
    if (route < kCta || route > kGmem) return (int)cudaErrorInvalidValue;
    if (route == kGmem) {
        const Layout L = layout(m, r, route);
        if (work == nullptr
            || work_floats < 2LL * kCtas * L.ld * (long long)r)
            return (int)cudaErrorInvalidValue;
    }
    auto s = static_cast<cudaStream_t>(stream);
    return route == kCta ? launch<false>(a, (size_t)smem, s)
                         : launch<true>(a, (size_t)smem, s);
}
