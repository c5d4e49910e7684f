// K1q: the CGS2 double-word float32 ("df") thin QR of an (m, r) matrix in
// one launch on Hopper.
//
// The JAX package runs this loop as one lax.fori_loop of jnp df operations
// (xerus_tpu/ops/mixed_precision.py df_qr), compiled into one program; its
// row products are the df matvec of K1 (xerus_tpu/ops/pallas_df.py,
// _df_matvec_kernel).  Run eagerly, each column is four df matvecs and
// about 300 small torch operations, so the loop is bound by launches:
// 260 ms on an H100 80GB HBM3 for the (60, 30) factor of the Poisson
// solve, against a few microseconds of arithmetic.  Here the whole loop is
// one kernel that keeps its operands on chip and computes each step's row
// products with K1's arithmetic (df_arith.cuh).
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
// mat_scale and orig_norm come from one plain f32 sum of squares per
// column of A's high words (they only set a threshold).
//
// What bounds it: latency.  A column is a chain of dependent steps, and
// its 4 m j df multiply-add terms (21 FP32 operations each) are far below
// what the card could do in the time.  The design keeps every operand on
// chip and makes the chain short: no step of it walks rows or columns one
// reduction after another, and each cross-thread exchange costs one
// barrier.
//
// - Q^T v: lanes in aligned groups of G (a power of two, as many as the
//   threads allow for the j columns, at most 32), one group per column;
//   lane g sums the rows g, g + G, ... in two interleaved accumulators,
//   then one xor butterfly of log2 G levels folds the group.  All columns
//   are in flight at once.  One block barrier.
// - p = Q c and v -= p: groups of H lanes per row, lane h summing the
//   columns h, h + H, ... in two accumulators, one butterfly.  The squares
//   of the new v go into a per-thread partial for the norm on the way.
//   One block barrier.
// - the norm: one warp butterfly of the partials, a tree over the warps.
//
// Routes:
// - cta (one thread block): when Q, v and R's column fit one CTA's shared
//   memory.  Q lives in shared memory in the columns of A it replaces:
//   column j holds A's column j until step j writes Q's.  Column-major,
//   (h, l) pairs side by side, the rows of a column permuted by swz so
//   that both steps read without bank conflicts.  Five block barriers a
//   column.
// - cluster (one 16-CTA thread-block cluster): when Q only fits across the
//   cluster's shared memory.  CTA b holds the band of rows
//   [b ceil(m/16), (b+1) ceil(m/16)).  Q^T v and the norm are band
//   partials, all-reduced by a pull: each CTA writes its partials into its
//   own shared memory (two slots used in turn, so a slot is rewritten only
//   after every CTA has passed the barrier that follows its reads), one
//   cluster barrier, then every CTA sums the 16 partials over distributed
//   shared memory (16-byte loads) by a tree over the bands.  Three cluster
//   barriers a column: one per projection round, one for the norm (a
//   deficient column adds two).
// - gmem (the cluster route with Q in global memory): when a band of Q
//   does not fit a CTA's shared memory (a (1024, 512) factor).  Each CTA
//   keeps its band of Q in its own part of a global workspace, L2-resident
//   at these sizes, and only the vectors in shared memory; the steps, the
//   exchanges and their orders are the cluster route's, so its results are
//   bitwise the cluster route's.  Only this CTA's threads touch its band,
//   so the block barriers order its accesses.
//
// Every reduction runs in a fixed order that depends on the shape alone
// (the groups, the butterflies, the trees over warps and bands), so two
// launches on the same input are bitwise equal.  The order differs
// from the plain version's pairwise trees, so the results agree to df
// accuracy, not bitwise.  xerus_tpu_torch/ops/df_loops.py df_qr_model is
// this order in torch.
//
// Built with -DXERUS_DFQR_STAMPS, thread 0 of CTA 0 also counts each
// column's clock cycles by kind (arithmetic, folds, block barriers,
// cluster barriers, the pulls over distributed shared memory, the rest)
// into a buffer: xerus_df_qr_stamped.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "df_arith.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kCtas = 16;
static_assert(kCtas == 16 && kMaxWarps == 16, "tree16 sums 16 leaves");
constexpr int kMaxSmem = 232448;   // 227 KB, the largest a block can use
constexpr int kUnschedulable = 1000;
enum Route { kCta = 0, kCluster = 1, kGmem = 2 };
enum Kind { kArith = 0, kFold = 1, kWait = 2, kClusterWait = 3,
            kPull = 4, kRest = 5, kKinds = 6 };

__host__ __device__ inline int pow2_ceil(int x) {
    int p = 1;
    while (p < x) p *= 2;
    return p;
}

// Threads of a CTA: 512 on the cluster routes; on route cta enough for a
// group of lanes per row and per column (xerus_tpu_torch/ops/df_loops.py
// qr_threads mirrors this).
__host__ __device__ inline int threads_for(int m, int r, int route) {
    if (route != kCta) return kMaxThreads;
    const int t = pow2_ceil(2 * m > 8 * r ? 2 * m : 8 * r);
    return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// ceil(log2 x) for x >= 1
__device__ __forceinline__ int ceil_log2(int x) {
    return x <= 1 ? 0 : 32 - __clz(x - 1);
}

// Q's row k of column i lives at i ld + (k ^ swz(i)): the xor with the
// column's low five bits reversed keeps both the lanes of Q^T v (a group
// of lanes down a column, the groups on consecutive columns) and those of
// Q c (a group of lanes along a row, the groups on consecutive rows) on
// 32 distinct banks, whatever the group size.
__device__ __forceinline__ int swz(int i) {
    return (int)(__brev((unsigned)i) >> 27);
}

// log2 of the lanes per column of Q^T v at step j (j >= 1) on 2^lgT
// threads: as many as the threads allow for j columns, at most 32 and at
// most the band's rows rounded up to a power of two; and of the lanes per
// row of Q c: as many as the threads allow for the band's rows, at most 32
// and at most j rounded up.  (xerus_tpu_torch/ops/df_loops.py coef_lanes
// and row_lanes give 2 to these powers.)
__device__ __forceinline__ int coef_lanes_log2(int lgT, int rows, int j) {
    return min(max(0, lgT - ceil_log2(j)), min(5, ceil_log2(max(rows, 1))));
}

__device__ __forceinline__ int row_lanes_log2(int lgT, int rows, int j) {
    return min(max(0, lgT - ceil_log2(max(rows, 1))),
               min(5, ceil_log2(max(j, 1))));
}

// Shared-memory layout in floats; df values as (h, l) float2 pairs.
// xerus_tpu_torch/ops/df_loops.py (df_qr_plan) sizes the launch; the
// launch checks that its size covers this layout.
struct Layout {
    int rows;    // rows of this CTA's band (route cta: all m)
    int ld;      // column stride of the band in pairs: rows rounded up to 32
    int w;       // (ld, r) column-major pairs: Q in columns < j, A's columns
                 // after (route gmem: in the global workspace, not here)
    int v;       // the column being orthogonalized, (ld,) pairs
    int c;       // c = Q^T v, (r,) pairs
    int o;       // coef, the R column, (r,) pairs
    int red;     // per-warp norm partials, kMaxWarps pairs
    int colsq;   // per-column sum of squares of A's high words, (r,)
    int colb;    // route cluster: this band's colsq partials, (r,)
    int xs;      // route cluster: two exchange slots of slot_pairs(r)
                 // pairs, 16-byte aligned
    int total;
};

// An exchange slot's pairs: r rounded up to even, so that both slots
// start on a 16-byte boundary (pull_pair reads them by float4).
__host__ __device__ inline int slot_pairs(int r) { return (r + 1) & ~1; }

__host__ __device__ inline Layout layout(int m, int r, int route) {
    const bool cluster = route != kCta;
    Layout L;
    L.rows = cluster ? (m + kCtas - 1) / kCtas : m;
    L.ld = (L.rows + 31) / 32 * 32;
    if (L.ld == 0) L.ld = 32;
    int o = 0;
    L.w = o; o += route == kGmem ? 0 : 2 * L.ld * r;
    L.v = o; o += 2 * L.ld;
    L.c = o; o += 2 * r;
    L.o = o; o += 2 * r;
    L.red = o; o += 2 * kMaxWarps;
    L.colsq = o; o += r;
    L.colb = o; o += cluster ? r : 0;
    if (cluster) o = (o + 3) / 4 * 4;
    L.xs = o; o += cluster ? 4 * slot_pairs(r) : 0;
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
    float* work;      // route gmem: 16 bands of ld r pairs; else null
    long long* stamps;  // (r, kKinds) cycles, stamped builds; else null
    int m, r, route;
};

__device__ __forceinline__ df as_df(float2 p) { return {p.x, p.y}; }
__device__ __forceinline__ float2 as_pair(df v) { return {v.h, v.l}; }

template <int kRoute>
struct Ctx {
    static constexpr bool kCluster = kRoute != kCta;
    float* sm;
    float2* w;        // this CTA's band of Q / A: shared memory, or on route
                      // gmem global memory (a compile-time choice)
    Layout L;
    int lgT, T;       // threads of the CTA, 2^lgT
    int r;            // columns
    int cr;           // rank in the cluster (0 on route cta)
    int row0, nrows;  // this CTA's band
    int ex;           // the exchange slot in turn
#ifdef XERUS_DFQR_STAMPS
    bool on;
    long long t, kinds[kKinds];
#endif

    __device__ float2* pairs(int off) const {
        return reinterpret_cast<float2*>(sm + off);
    }

    __device__ void cluster_sync() const {
        if constexpr (kCluster) cg::this_cluster().sync();
    }
    template <typename P>
    __device__ const P* remote(const P* p, int rank) const {
        if constexpr (kCluster) {
            return cg::this_cluster().map_shared_rank(const_cast<P*>(p),
                                                      rank);
        } else {
            return p;
        }
    }
    __device__ float2* slot() const {
        return pairs(L.xs) + ex * slot_pairs(r);
    }

    // stamped builds: the cycles since the last lap go to `kind`
    template <int kind>
    __device__ __forceinline__ void lap() {
#ifdef XERUS_DFQR_STAMPS
        if (on) {
            const long long now = clock64();
            kinds[kind] += now - t;
            t = now;
        }
#endif
    }
};

__device__ __forceinline__ df shfl_xor_df(df v, int off) {
    return {__shfl_xor_sync(0xffffffffu, v.h, off),
            __shfl_xor_sync(0xffffffffu, v.l, off)};
}

// The df sum over each aligned group of 2^lg lanes (lg <= 5), in every
// lane of the group: an xor butterfly, lane p adding lane p ^ off for
// off = 2^(lg-1), ..., 1.  df_add is commutative bit for bit, so every lane
// of a group ends with the same sum: in lane 0 the shuffle-down tree's.
__device__ __forceinline__ df group_fold(df v, int lg) {
    for (int off = (1 << lg) >> 1; off > 0; off >>= 1)
        v = df_add(v, shfl_xor_df(v, off));
    return v;
}

// The df sum of 16 leaves by the pairwise tree of a butterfly: leaf b
// adds leaf b + 8 for b < 8, then b + 4 for b < 4, and so on down (zero
// leaves past the first 2^q make it the tree of those 2^q).  Written out,
// so that the leaves stay in registers.
__device__ __forceinline__ df tree16(df (&v)[16]) {
    v[0] = df_add(v[0], v[8]);
    v[1] = df_add(v[1], v[9]);
    v[2] = df_add(v[2], v[10]);
    v[3] = df_add(v[3], v[11]);
    v[4] = df_add(v[4], v[12]);
    v[5] = df_add(v[5], v[13]);
    v[6] = df_add(v[6], v[14]);
    v[7] = df_add(v[7], v[15]);
    v[0] = df_add(v[0], v[4]);
    v[1] = df_add(v[1], v[5]);
    v[2] = df_add(v[2], v[6]);
    v[3] = df_add(v[3], v[7]);
    v[0] = df_add(v[0], v[2]);
    v[1] = df_add(v[1], v[3]);
    return df_add(v[0], v[1]);
}

// The 16 CTAs' partials at pair i of this exchange's slot, summed over the
// bands by tree16's tree.
template <int kRoute>
__device__ __forceinline__ df pull_sum(const Ctx<kRoute>& x, int i) {
    const float2* s = x.slot();
    df v[kCtas];
#pragma unroll
    for (int b = 0; b < kCtas; ++b) v[b] = as_df(x.remote(s, b)[i]);
    return tree16(v);
}

// The 16 CTAs' partials at pairs 2t and 2t + 1 of this exchange's slot
// (one 16-byte load a CTA), each summed over the bands by tree16's tree,
// its first level as the loads arrive (fewer live registers).
template <int kRoute>
__device__ __forceinline__ void pull_pair(const Ctx<kRoute>& x, int t,
                                          df& s0, df& s1) {
    const float4* slot = reinterpret_cast<const float4*>(x.slot());
    df u0[8], u1[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
        const float4 p = x.remote(slot, b)[t];
        const float4 q = x.remote(slot, b + 8)[t];
        u0[b] = df_add({p.x, p.y}, {q.x, q.y});
        u1[b] = df_add({p.z, p.w}, {q.z, q.w});
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
        u0[b] = df_add(u0[b], u0[b + 4]);
        u1[b] = df_add(u1[b], u1[b + 4]);
    }
    s0 = df_add(df_add(u0[0], u0[2]), df_add(u0[1], u0[3]));
    s1 = df_add(df_add(u1[0], u1[2]), df_add(u1[1], u1[3]));
}

// c[i] = s; with `accumulate`, coef[i] += s
template <int kRoute>
__device__ __forceinline__ void take_coef(const Ctx<kRoute>& x, int i, df s,
                                          bool accumulate) {
    x.pairs(x.L.c)[i] = as_pair(s);
    if (accumulate) {
        float2* o = x.pairs(x.L.o);
        o[i] = as_pair(df_add(as_df(o[i]), s));
    }
}

// sum over rows k = g, g + s, ... < n of q[k ^ qx] v[k ^ vx], the even
// terms in one accumulator and the odd ones in another, then the two
__device__ __forceinline__ df strided_dot(const float2* q, int qx,
                                          const float2* v, int vx, int g,
                                          int n, int s) {
    df a0 = {0.0f, 0.0f}, a1 = {0.0f, 0.0f};
    int k = g;
#pragma unroll 2
    for (; k + s < n; k += 2 * s) {
        const float2 q0 = q[k ^ qx], q1 = q[(k + s) ^ qx];
        const float2 v0 = v[k ^ vx], v1 = v[(k + s) ^ vx];
        a0 = df_add(a0, df_mul(q0.x, q0.y, v0.x, v0.y));
        a1 = df_add(a1, df_mul(q1.x, q1.y, v1.x, v1.y));
    }
    if (k < n) {
        const float2 q0 = q[k ^ qx], v0 = v[k ^ vx];
        a0 = df_add(a0, df_mul(q0.x, q0.y, v0.x, v0.y));
    }
    return df_add(a0, a1);
}

// c[i] = sum over rows of Q[k, i] src[k] for i < j (j >= 1), in every CTA;
// with `accumulate`, coef += c.  A group of G lanes per column (lane g the
// rows g, g + G, ... in two interleaved accumulators, then the group's
// butterfly).  Route cta: the group writes c[i].  Route cluster: the group
// writes its band partial into this CTA's exchange slot; after the cluster
// barrier thread t sums the 16 bands' partials of pairs 2t and 2t + 1 by a
// tree.  Ends with a block barrier.
template <int kRoute>
__device__ void project_coefs(Ctx<kRoute>& x, const float2* src, int sx,
                              int j, bool accumulate) {
    const Layout& L = x.L;
    const int tid = threadIdx.x;
    const int lg = coef_lanes_log2(x.lgT, x.nrows, j);
    const int g = tid & ((1 << lg) - 1), nq = x.T >> lg;
    for (int i0 = 0; i0 < j; i0 += nq) {
        const int i = i0 + (tid >> lg);
        df s = {0.0f, 0.0f};
        if (i < j)
            s = strided_dot(x.w + i * L.ld, swz(i), src, sx, g, x.nrows,
                            1 << lg);
        x.template lap<kArith>();
        s = group_fold(s, lg);
        x.template lap<kFold>();
        if (g == 0 && i < j) {
            if constexpr (Ctx<kRoute>::kCluster) {
                x.slot()[i] = as_pair(s);
            } else {
                take_coef(x, i, s, accumulate);
            }
        }
    }
    if constexpr (Ctx<kRoute>::kCluster) {
        x.cluster_sync();
        x.template lap<kClusterWait>();
        // thread t: the pairs 2t and 2t + 1, one 16-byte load a CTA
        for (int t = tid; 2 * t < j; t += x.T) {
            df s0, s1;
            pull_pair(x, t, s0, s1);
            take_coef(x, 2 * t, s0, accumulate);
            if (2 * t + 1 < j) take_coef(x, 2 * t + 1, s1, accumulate);
        }
        x.ex ^= 1;
        x.template lap<kPull>();
    }
    __syncthreads();
    x.template lap<kWait>();
}

// v[k] = src[k] - sum_{i<j} Q[k, i] c[i] for the band's rows: a group of H
// lanes per row (lane h the columns h, h + H, ... in two interleaved
// accumulators, then the group's butterfly); lane 0 of the group writes
// v[k] (src may be v itself) and adds v[k]^2 to its norm partial, which it
// returns (rows in order), with log2 H in *lanes_log2.  No barrier.
template <int kRoute>
__device__ df project_out(Ctx<kRoute>& x, const float2* src, int sx, int j,
                          int* lanes_log2) {
    const Layout& L = x.L;
    const int tid = threadIdx.x;
    const int lg = row_lanes_log2(x.lgT, x.nrows, j);
    *lanes_log2 = lg;
    const int h = tid & ((1 << lg) - 1), nq = x.T >> lg, H = 1 << lg;
    const float2* c = x.pairs(L.c);
    float2* v = x.pairs(L.v);
    df part = {0.0f, 0.0f};
    for (int k0 = 0; k0 < x.nrows; k0 += nq) {
        const int k = k0 + (tid >> lg);
        df p = {0.0f, 0.0f};
        if (k < x.nrows) {
            // the row k of Q, columns h, h + H, ...
            df a0 = {0.0f, 0.0f}, a1 = {0.0f, 0.0f};
            int i = h;
#pragma unroll 2
            for (; i + H < j; i += 2 * H) {
                const float2 q0 = x.w[i * L.ld + (k ^ swz(i))];
                const float2 q1 = x.w[(i + H) * L.ld + (k ^ swz(i + H))];
                const float2 c0 = c[i], c1 = c[i + H];
                a0 = df_add(a0, df_mul(q0.x, q0.y, c0.x, c0.y));
                a1 = df_add(a1, df_mul(q1.x, q1.y, c1.x, c1.y));
            }
            if (i < j) {
                const float2 q0 = x.w[i * L.ld + (k ^ swz(i))];
                const float2 c0 = c[i];
                a0 = df_add(a0, df_mul(q0.x, q0.y, c0.x, c0.y));
            }
            p = df_add(a0, a1);
        }
        x.template lap<kArith>();
        p = group_fold(p, lg);
        x.template lap<kFold>();
        if (h == 0 && k < x.nrows) {
            const df vk = df_sub(as_df(src[k ^ sx]), p);
            v[k] = as_pair(vk);
            part = df_add(part, df_mul(vk.h, vk.l, vk.h, vk.l));
        }
    }
    x.template lap<kArith>();
    return part;
}

// The df norm of v from every thread's partial (nonzero in the lanes
// 0 mod 2^lg only), in every thread: the warp butterfly down to offset
// 2^lg (the levels below add only zeros), the warps by tree16's tree;
// route cluster: the 16 bands by the same tree (one exchange).
template <int kRoute>
__device__ df norm_all(Ctx<kRoute>& x, df part, int lg) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float2* red = x.pairs(x.L.red);
    for (int off = 16; off >= (1 << lg); off >>= 1)
        part = df_add(part, shfl_xor_df(part, off));
    x.template lap<kFold>();
    if (lane == 0) red[warp] = as_pair(part);
    __syncthreads();
    x.template lap<kWait>();
    df w[kMaxWarps];
#pragma unroll
    for (int q = 0; q < kMaxWarps; ++q)
        w[q] = q < x.T >> 5 ? as_df(red[q]) : df{0.0f, 0.0f};
    df band = tree16(w);
    if constexpr (Ctx<kRoute>::kCluster) {
        if (threadIdx.x == 0) x.slot()[0] = as_pair(band);
        x.cluster_sync();
        x.template lap<kClusterWait>();
        band = pull_sum(x, 0);
        x.ex ^= 1;
        x.template lap<kPull>();
    }
    const df n = df_sqrt(band);
    x.template lap<kRest>();
    return n;
}

template <int kRoute>
__global__ void __launch_bounds__(kMaxThreads, 1) df_qr_kernel(Args a) {
    constexpr bool kCluster = Ctx<kRoute>::kCluster;
    extern __shared__ __align__(16) float sm[];
    Ctx<kRoute> x;
    x.sm = sm;
    x.L = layout(a.m, a.r, kRoute);
    const Layout& L = x.L;
    x.T = blockDim.x;
    x.lgT = 31 - __clz(x.T);
    x.r = a.r;
    x.cr = 0;
    if constexpr (kCluster) x.cr = (int)cg::this_cluster().block_rank();
    x.row0 = x.cr * L.rows;
    x.nrows = max(0, min(L.rows, a.m - x.row0));
    x.ex = 0;
    const int r = a.r, T = x.T, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
#ifdef XERUS_DFQR_STAMPS
    x.on = a.stamps != nullptr && x.cr == 0 && tid == 0;
    x.t = clock64();
#endif
    if constexpr (kRoute == kGmem)
        x.w = reinterpret_cast<float2*>(a.work) + (size_t)x.cr * L.ld * r;
    else
        x.w = x.pairs(L.w);
    float2* w = x.w;
    float2* v = x.pairs(L.v);
    float2* o = x.pairs(L.o);
    float* colsq = sm + L.colsq;

    // the band of A, column-major pairs; coef = 0
    for (int e = tid; e < x.nrows * r; e += T) {
        const int k = e / r, i = e - k * r;
        const size_t g = (size_t)(x.row0 + k) * a.lda + i;
        w[i * L.ld + (k ^ swz(i))] = {a.ah[g], a.al[g]};
    }
    for (int i = tid; i < r; i += T) o[i] = {0.0f, 0.0f};
    __syncthreads();

    // colsq[i] = sum over rows of ah^2, plain f32 (a warp per column, the
    // lanes' rows, the butterfly; route cluster: the bands in order);
    // mat_scale = sqrt(max colsq); then each column's deficiency threshold
    // max(1e-12 orig_norm, 1e-13 mat_scale) + 1e-30 with
    // orig_norm = sqrt(colsq) + 1e-38, in place of colsq
    float* colb = kCluster ? sm + L.colb : colsq;
    for (int i = warp; i < r; i += T / 32) {
        float s = 0.0f;
        for (int k = lane; k < x.nrows; k += 32) {
            const float q = w[i * L.ld + (k ^ swz(i))].x;
            s = __fadd_rn(s, __fmul_rn(q, q));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
        if (lane == 0) colb[i] = s;
    }
    if constexpr (kCluster) {
        x.cluster_sync();
        for (int i = tid; i < r; i += T) {
            float s = x.remote(colb, 0)[i];
            for (int b = 1; b < kCtas; ++b)
                s = __fadd_rn(s, x.remote(colb, b)[i]);
            colsq[i] = s;
        }
    }
    __syncthreads();
    float big = 0.0f;
    for (int i = 0; i < r; ++i) big = fmaxf(big, colsq[i]);
    const float mat_scale = __fsqrt_rn(big);
    __syncthreads();
    float* thr = colsq;
    for (int i = tid; i < r; i += T) {
        const float orig_norm = __fadd_rn(__fsqrt_rn(colsq[i]), 1e-38f);
        thr[i] = __fadd_rn(fmaxf(__fmul_rn(1e-12f, orig_norm),
                                 __fmul_rn(1e-13f, mat_scale)),
                           1e-30f);
    }
    __syncthreads();
#ifdef XERUS_DFQR_STAMPS
    x.t = clock64();
#endif

    for (int j = 0; j < r; ++j) {
#ifdef XERUS_DFQR_STAMPS
        for (int q = 0; q < kKinds; ++q) x.kinds[q] = 0;
#endif
        const int sj = swz(j);
        // pass 0 and 1: the two projection rounds, from A's column, then
        // from v; pass 2, for a deficient column: the fallback's one round
        // from e_{j mod m}.  One loop, so that the kernel holds one copy of
        // each step's code.
        df n = {0.0f, 0.0f}, n2 = {0.0f, 0.0f};
        for (int pass = 0; pass < 3; ++pass) {
            const float2* src = pass == 0 ? w + j * L.ld : v;
            const int sx = pass == 0 ? sj : 0;
            if (j > 0) project_coefs(x, src, sx, j, pass < 2);
            int lg;
            const df part = project_out(x, src, sx, j, &lg);
            if (pass == 0) {
                __syncthreads();
                x.template lap<kWait>();
                continue;
            }
            n2 = norm_all(x, part, lg);
            if (pass == 2) break;
            n = n2;
            if (a.stats != nullptr && x.cr == 0 && tid == 0) {
                a.stats[2 * j] = n.h;
                a.stats[2 * j + 1] = thr[j];
            }
            if (!(n.h <= thr[j])) break;
            // deficient (uniform: every thread of every CTA alike)
            n = {0.0f, 0.0f};
            const int e = j % a.m;
            for (int k = tid; k < x.nrows; k += T)
                v[k] = {(x.row0 + k == e) ? 1.0f : 0.0f, 0.0f};
            // v is written, and every thread has read the warp partials
            __syncthreads();
        }
        const df inv = df_div({1.0f, 0.0f}, {fmaxf(n2.h, 1e-20f), n2.l});
        for (int k = tid; k < x.nrows; k += T) {
            const float2 vk = v[k];
            const df q = df_mul(vk.x, vk.y, inv.h, inv.l);
            w[j * L.ld + (k ^ sj)] = as_pair(q);
            const size_t g = (size_t)(x.row0 + k) * r + j;
            a.qh[g] = q.h;
            a.ql[g] = q.l;
        }
        for (int i = tid; i < r; i += T) {
            if (x.cr == 0) {
                const df c = i < j ? as_df(o[i])
                                   : (i == j ? n : df{0.0f, 0.0f});
                a.rh[(size_t)i * r + j] = c.h;
                a.rl[(size_t)i * r + j] = c.l;
            }
            o[i] = {0.0f, 0.0f};
        }
        x.template lap<kRest>();
        __syncthreads();
        x.template lap<kWait>();
#ifdef XERUS_DFQR_STAMPS
        if (x.on)
            for (int q = 0; q < kKinds; ++q)
                a.stamps[(size_t)j * kKinds + q] = x.kinds[q];
#endif
    }
    // no CTA leaves while another may still read its shared memory
    x.cluster_sync();
}

template <int kRoute>
int launch(const Args& a, size_t bytes, cudaStream_t stream) {
    constexpr bool kCluster = kRoute != kCta;
    const Layout L = layout(a.m, a.r, kRoute);
    if ((size_t)L.total * sizeof(float) > bytes || bytes > (size_t)kMaxSmem)
        return (int)cudaErrorInvalidValue;
    static size_t checked = 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster ? kCtas : 1);
    cfg.blockDim = dim3(threads_for(a.m, a.r, kRoute));
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
                df_qr_kernel<kRoute>,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (e != cudaSuccess) return (int)e;
        }
        e = cudaFuncSetAttribute(df_qr_kernel<kRoute>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
        if (e != cudaSuccess) return (int)e;
        if (kCluster) {
            int clusters = 0;
            e = cudaOccupancyMaxActiveClusters(&clusters,
                                               df_qr_kernel<kRoute>, &cfg);
            if (e != cudaSuccess) return (int)e;
            if (clusters < 1) return kUnschedulable;
        }
        checked = bytes;
    }
    e = cudaLaunchKernelEx(&cfg, df_qr_kernel<kRoute>, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

int df_qr(Args a, long long work_floats, int smem, void* stream) {
    if (a.m <= 0 || a.r <= 0) return 0;
    if (a.route < kCta || a.route > kGmem) return (int)cudaErrorInvalidValue;
    if (a.route == kGmem) {
        const Layout L = layout(a.m, a.r, a.route);
        if (a.work == nullptr
            || work_floats < 2LL * kCtas * L.ld * (long long)a.r
            || reinterpret_cast<size_t>(a.work) % 8 != 0)
            return (int)cudaErrorInvalidValue;
    }
    auto s = static_cast<cudaStream_t>(stream);
    if (a.route == kCta) return launch<kCta>(a, (size_t)smem, s);
    if (a.route == kCluster) return launch<kCluster>(a, (size_t)smem, s);
    return launch<kGmem>(a, (size_t)smem, s);
}

}  // namespace

// Q (m, r) and R (r, r), row-major contiguous, of the (m, r) df matrix A
// with row stride lda, on `stream`, by `route` (0 cta, 1 cluster, 2 gmem)
// with `smem` bytes of dynamic shared memory per CTA; stats (r, 2) or
// null; work (route gmem, 8-byte aligned) 32 ld r floats for ld =
// ceil(m / 16) rounded up to 32, of which `work_floats` are given.
// Allocates nothing, does not synchronize; returns the launch's error code
// (0 on success, 1000 for a cluster the card cannot schedule,
// cudaErrorInvalidValue for a size that does not cover the route's
// layout).
extern "C" int xerus_df_qr(const float* ah, const float* al, int lda,
                           float* qh, float* ql, float* rh, float* rl,
                           float* stats, float* work, long long work_floats,
                           int m, int r, int route, int smem,
                           void* stream) {
    return df_qr({ah, al, lda, qh, ql, rh, rl, stats, work, nullptr, m, r,
                  route},
                 work_floats, smem, stream);
}

// The threads of one CTA of the launch above.
extern "C" int xerus_df_qr_threads(int m, int r, int route) {
    return threads_for(m, r, route);
}

#ifdef XERUS_DFQR_STAMPS
// xerus_df_qr, with each column's clock cycles on thread 0 of CTA 0 by
// kind (arithmetic, folds, block barriers, cluster barriers, pulls, the
// rest) written to stamps, (r, 6) int64.
extern "C" int xerus_df_qr_stamped(const float* ah, const float* al, int lda,
                                   float* qh, float* ql, float* rh,
                                   float* rl, float* stats, float* work,
                                   long long work_floats, int m, int r,
                                   int route, int smem, void* stream,
                                   long long* stamps) {
    return df_qr({ah, al, lda, qh, ql, rh, rl, stats, work, stamps, m, r,
                  route},
                 work_floats, smem, stream);
}
#endif
