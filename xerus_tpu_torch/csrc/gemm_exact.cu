// K2: certified GEMM-only rank-`keep` truncation of one bond matricization
// on Hopper, as one thread-block cluster whose shared memory holds the
// whole iteration.
//
// Replaces the Pallas TPU kernel xerus_tpu/ops/tt_kernels.py
// _gemm_exact_pallas_call (body _gemm_exact_body).  It computes what that
// body computes, not its block structure: for cur (B, M) and a kept rank
// `keep` inside the column bucket K (keep_cap, K <= B),
//   G = cur cur^T;  V0 = NS-orth(G[:, :K] + 1e-3 max|G| hash);
//   outer steps alternating a degree-2 power step Gn (Gn V) and a degree-2
//   Chebyshev step on [0, b], each followed by column balancing and a
//   Newton-Schulz re-orthonormalization, a monotone safeguard on
//   tau = tr(V^T G V), and the Aitken / noise-floor / capture-complete
//   certificates on power steps; `polish` further power steps; then
//   vt_raw = V^T cur, row balancing and a Newton-Schulz row polar.
// Outputs vt0 (K, M) (the polar, valid iff okp), vt_bal (K, M) (the
// balanced rows, input of the Householder-LQ finish that the caller runs
// on the host's decision) and the flags of gemm_exact_common.cuh.  The
// caller is the gemm_exact truncation of xerus_tpu_torch/ops/round_kernels.py:
// 17 calls at (256, 256), keep 128, K 128 per d=32 rank-256 -> 128 rounding
// in f32 (the core-level rounding) and in f64 (TTTensor.round_fast, whose
// bonds are (256, 256) and (256, 512)).
//
// Bound at that shape: operations.  The flags give the FLOP count
// (ops/gemm_exact.py gemm_exact_flops): in f32, at 22.4 outer and 834
// Newton-Schulz steps per bond (the rounding's mean) about 15.7 GFLOP,
// 0.24 ms at the H100's 67 TFLOP/s of FP32 FFMA; in f64, on the slowest
// bond (256 outer steps, about 10,000 Newton-Schulz steps under the
// (256, 64, 16, 3) tuning) 188 GFLOP, 2.8 ms at the 67 TFLOP/s of the FP64
// tensor cores; inputs and outputs (under 2 MB) take under 1 us at 3.35
// TB/s.  What the work really is, though, is a chain of thousands of
// data-dependent small products (the largest (256, 256, 256), the most
// frequent the (128, 128, 256) Newton-Schulz Gram and its (256, 128, 128)
// update), each followed by a reduction that decides the next step.  So
// latency bounds it: the grid route (gemm_exact_grid.cuh) pays a
// grid-wide barrier per phase, an L2 round trip per 32-deep chunk and
// keeps at most 32 of 132 blocks busy.
//
// The cluster route answers that as the TPU kernel did with one core's
// VMEM: 16 CTAs of one non-portable cluster hold the whole state in their
// shared memory, split by rows, and exchange what a product needs through
// distributed shared memory.  Every exchange is a push: a CTA stores its
// slice, its partial Gram rows or its rows of P = 1.5 I - 0.5 S straight
// into the other CTAs' shared memory, destinations staggered by rank, and
// one cluster barrier (release / acquire) publishes them; no CTA waits on
// a remote load.  A Newton-Schulz step is: the CTA's partial Gram, only
// its blocks on and above the diagonal (S is symmetric), pushed to the
// owners of S's rows; barrier; each owner (4-row blocks b and K/4 - 1 - b,
// so that all owners fold the same number of elements) folds the 16
// partials in rank order, takes max|S - diag(mask)| and pushes its upper
// rows of P to all; barrier; every CTA folds the error and updates its
// rows X <- X P in place.  Two cluster barriers, no global memory.
//
// float32 (kernel): 16 rows of G's columns and Gn's, the (B, K) bases V,
// Q and a work buffer, the iterate's transpose, later cur's columns and
// the (M, K) row-polar iterate; the exchange region holds the whole
// (Bp, Kp) basis or all Gram partials plus the whole P (52,108 elements,
// 208 KB, at the rounding's bonds).  Products are SIMT FFMA on k-major
// shared-memory operands with 4 x 4 register blocks per thread (the
// (K, K) Gram up to four row blocks of one column block per thread; the
// products whose output is a row slice computed transposed, k split over
// neighbouring lanes and folded by shuffles).  TF32 (10-bit mantissa)
// never certifies: the certificates sit at 4, 8 and 16 eps of the working
// type and the Newton-Schulz exits at 64 eps, so every product keeps full
// FP32 FFMA; a 3xTF32 split was not tried.
//
// float64 (f64::kernel, the rounding's bonds: B in (192, 256], K in
// (64, 128], M <= 512): the f32 layout would take 417 KB.  This design
// keeps 16 rows of G and two bases per CTA and slices every exchange:
//   * a product with the distributed basis (Gn V, G V for tau, Gn Y1,
//     cur^T V) pushes the basis in column slices, 256 x 64 (256 x 32
//     beside cur's columns in the row polar), two barriers a slice;
//   * a Newton-Schulz step pushes only the Gram partials of the 8-row
//     diagonal bands and above, packed (row i from column 8 floor(i / 8)),
//     544 elements to each owner, and the owners push P's rows packed the
//     same way: 8,704 elements each way, where f32 holds 16 x 8 x 128 and
//     128 x 132; the update reads P directly above the band diagonal and
//     transposed below it;
//   * G is kept and Gn is not stored: a product with Gn divides its
//     outputs by tr(G) (the same quotient up to rounding; one division per
//     output element, where forming Gn at load would take one per element
//     of G and warp), and tau reads G V as the plain body does;
//   * orthonormalization runs in place on the work basis, so the design
//     stores two bases (V and W) and no transposes.
// Every product runs on the FP64 tensor cores (mma.sync m16n8k4 .f64, as
// inline PTX; wgmma has no f64 type), operands k-major in shared memory
// with row strides of 4 mod 16 doubles or an XOR swizzle, so that a
// fragment's lanes hit distinct banks; each warp owns whole 16 x 8 output
// tiles, so a tile's sum runs over k in one order.  Shared memory per CTA
// (f64::layout, doubles): exchange 17,408 (Gram partials + P; or the
// 256 x 64 slice; or the 256 x 32 slice and cur's 16 or 32 columns, 260
// apart), G's rows 16 x 260 (phase 2: Y, rm x 132), two bases 2 x 16 x
// 132, column sums 16 x 128 + 128, reduction slots 256, block scratch 12:
// 28,236 doubles (225,888 bytes) at (256, 256) and 28,300 (226,400 bytes)
// at (256, 512), within the 232,448 bytes a block may opt into.  A
// Newton-Schulz step then costs a CTA 1.05 MFLOP on the tensor cores
// (about 2 us at one SM's share of 67 TFLOP/s), its pushes of about 140 KB
// and two cluster barriers.
//
// Route: the cluster route takes every shape whose state fits one CTA's
// 227 KB of shared memory (f32 up to B = 256, K = 128, M = 512; f64 the
// rounding's bonds above and small shapes in the f32 layout), chosen
// from the shape before the launch (xerus_gemm_exact_route); the others
// (B > 256, K > 128, long M) take the grid route of gemm_exact_grid.cuh,
// a cooperative grid kernel.  flags[kClusterCtas] says which ran.  The
// cluster size is fixed at 16; if the card cannot schedule it, the launch
// fails (a different CTA count would change the reduction order and the
// bitwise result).
//
// Determinism: every reduction folds per-CTA partials in rank order and
// per-thread partials in a fixed tree; no float atomics.  Every CTA folds
// the same values in the same order and takes the same branch, so no
// barrier deadlocks and two launches give bitwise equal outputs.  The
// tau >= tau_prev safeguard and the Aitken ratios make the iteration
// count sensitive to the last bit of every reduction.
//
// Built without -fmad=false: the GEMMs and scalar updates may contract
// into FMAs, which changes nothing the certificates rely on.

#include <cooperative_groups.h>
#include <type_traits>

#include "gemm_exact_common.cuh"
#include "gemm_exact_grid.cuh"

namespace gemm_exact {
namespace cluster {

namespace cg = cooperative_groups;

constexpr int kCtas = 16;       // CTAs per cluster (non-portable size)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTasks = 4;    // 4 x 4 output blocks per thread, at most
constexpr int kSplitMax = 8;    // k slices of a small product
constexpr int kChunkM = 32;     // inner chunk of the G = cur cur^T staging
// error code of a cluster that the card cannot schedule
constexpr int kUnschedulable = 100001;
// rows of S one CTA owns: two 4-row blocks, b and q4 - 1 - b
constexpr int kOwnRows = 8;

__host__ __device__ inline int up4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ inline int pow2_at_least(int n) {
    int p = 4;
    while (p < n) p *= 2;
    return p;
}
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory layout of one CTA, in elements (every offset a multiple
// of 4).  The CTA owns rows [c rb, (c+1) rb) of the (Bp, Kp) bases and of
// G, rows [c rm, (c+1) rm) of the (Mp, Kp) row-polar iterate, and the
// rows of the (Kp, Kp) Newton-Schulz Gram that owned_block gives it (at most
// kOwnRows).  Padding rows and columns are zero and stay zero (dead
// columns).  P's rows are ldp = Kp + 4 apart: an odd number of 16-byte
// units, so 4-wide loads down a column hit distinct banks.
struct Layout {
    int Bp, Kp, rb, rm, ldp, ldg;
    int A;                        // exchange: full (Bp, Kp) basis, or
    int recv, pfull;              //   Gram partials (kCtas, kOwnRows, Kp) + P
    int Gt, Gnt, V, Q, T1, Xt;    // phase 1
    int Cs, Y, Yt;                // phase 2 (row polar), aliases phase 1
    int col, colv, red, blk, total;
};

__host__ __device__ inline Layout layout(int B, int M, int K) {
    Layout l;
    l.rb = up4((B + kCtas - 1) / kCtas);
    l.rm = pow2_at_least((M + kCtas - 1) / kCtas);
    l.Kp = pow2_at_least(K);
    l.ldp = l.Kp + 4;
    l.Bp = kCtas * l.rb;
    l.ldg = l.Bp + 4;
    int o = 0;
    l.A = o;
    l.recv = o;
    l.pfull = o + kCtas * kOwnRows * l.Kp;
    o += imax(imax(l.Bp * l.Kp, kCtas * kOwnRows * l.Kp + l.Kp * l.ldp),
              kChunkM * l.ldg);
    const int p1 = o;
    l.Gt = o; o += l.Bp * l.rb;
    l.Gnt = o; o += l.Bp * l.rb;
    l.V = o; o += l.rb * l.Kp;
    l.Q = o; o += l.rb * l.Kp;
    l.T1 = o; o += l.rb * l.Kp;
    l.Xt = o; o += l.Kp * l.rb;
    const int end1 = o;
    o = p1;
    l.Cs = o; o += l.Bp * l.rm;
    l.Y = o; o += l.rm * l.Kp;
    l.Yt = o; o += l.Kp * l.rm;
    o = imax(o, end1);
    l.col = o; o += kCtas * l.Kp;
    l.colv = o; o += l.Kp;
    l.red = o; o += 2 * kCtas * kWarps;
    l.blk = o; o += up4(kWarps + 1);
    l.total = o;
    return l;
}

// the shape limits of the cluster route besides the shared memory: one
// 4 x 4 block of G's columns per thread (rb <= 16), at most kMaxTasks
// blocks per thread in the (Kp, Kp) Gram and the (rm, Kp) products
inline bool shape_ok(const Layout& l) {
    return l.rb <= 16 && l.Kp <= 8 * kCtas
           && l.rm * l.Kp / 16 <= kMaxTasks * kThreads;
}

template <typename T> struct Params {
    Args<T> a;
    Layout l;
};

// Sizes fixed at compile time (0: the layout's, read at run time).  The
// rounding's bonds get their own instantiation, so that every loop bound,
// stride and tile count below is a constant and the GEMM loops unroll.
template <int KP, int RB, int RM> struct Fixed {
    static constexpr int kp = KP, rb = RB, rm = RM;
};
using Generic = Fixed<0, 0, 0>;
template <class D, class L> __device__ __forceinline__ int kp_of(const L& l) {
    return D::kp ? D::kp : l.Kp;
}
template <class D> __device__ __forceinline__ int rb_of(const Layout& l) {
    return D::rb ? D::rb : l.rb;
}
template <class D> __device__ __forceinline__ int rm_of(const Layout& l) {
    return D::rm ? D::rm : l.rm;
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
    const double2 t0 = reinterpret_cast<const double2*>(p)[0];
    const double2 t1 = reinterpret_cast<const double2*>(p)[1];
    v[0] = t0.x; v[1] = t0.y; v[2] = t1.x; v[3] = t1.y;
}
// p may be a local or a remote (distributed) shared-memory address
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Fixed-order block reduction; every thread of the block gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T ident, T* blk) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = op(v, __shfl_down_sync(0xffffffffu, v, off));
    __syncthreads();
    if (lane == 0) blk[w] = v;
    __syncthreads();
    if (w == 0) {
        T r = lane < kWarps ? blk[lane] : ident;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            r = op(r, __shfl_down_sync(0xffffffffu, r, off));
        if (lane == 0) blk[kWarps] = r;
    }
    __syncthreads();
    return blk[kWarps];
}

template <typename T, typename P = Params<T>> struct Ctx {
    cg::cluster_group cl;
    T* sm;                  // this CTA's dynamic shared memory
    const P& p;
    int cr;                 // rank in the cluster
    int rnd;                // reduction round: picks one of two slot sets
    int ns_total, ns_rows;  // Newton-Schulz iterations (all; row polar)
    int syncs;              // cluster barriers
    const T* staged;        // the basis the exchange region holds, if any

    __device__ const auto& l() const { return p.l; }
    __device__ T* at(int off) const { return sm + off; }
    // the same offset in CTA `rank`'s shared memory
    __device__ T* remote(T* local, int rank) const {
        return cl.map_shared_rank(local, rank);
    }
    __device__ void sync() {
        cl.sync();   // barrier.cluster.arrive.release + wait.acquire
        ++syncs;
    }

    // Cluster-wide reduction of n <= kWarps values, each already reduced
    // over this CTA: push them into slot [cr] of every CTA, barrier, and
    // fold the kCtas slots in rank order (fold_slots) in every CTA alike.
    // Two slot sets alternate, so round r + 2 never overwrites slots that a
    // CTA still reads: the barrier of round r + 1 lies between.
    __device__ T* slots() const {
        return sm + p.l.red + (rnd & 1) * kCtas * kWarps;
    }
    __device__ void publish(const T* v, int n) {
        if (threadIdx.x < kCtas) {
            T* dst = remote(slots() + cr * kWarps, threadIdx.x);
            for (int q = 0; q < n; ++q) dst[q] = v[q];
        }
    }
    template <typename Op>
    __device__ T fold_slots(int q, Op op, T ident) const {
        const T* buf = slots();
        T r = ident;
        for (int src = 0; src < kCtas; ++src)
            r = op(r, buf[src * kWarps + q]);
        return r;
    }
    // One value per thread reduced over the cluster: each warp's xor tree
    // (the same result in every lane) goes to slot [cr][warp] of every
    // CTA; after the barrier every lane folds four slots in order and the
    // warp an xor tree over them, alike in every warp of every CTA.
    template <typename Op>
    __device__ T all_reduce(T v, Op op, T ident) {
        static_assert(kCtas * kWarps == 4 * 32, "four slots per lane");
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
        const int lane = threadIdx.x & 31;
        if (lane < kCtas)
            *remote(slots() + cr * kWarps + (threadIdx.x >> 5), lane) = v;
        sync();
        const T* buf = slots() + 4 * lane;
        T r = op(op(op(op(ident, buf[0]), buf[1]), buf[2]), buf[3]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            r = op(r, __shfl_xor_sync(0xffffffffu, r, off));
        ++rnd;
        return r;
    }
};

// How a block of threads covers an (m, n) output in 4 x 4 blocks (m, n
// multiples of 4).  Up to kThreads blocks: one per group of `split`
// neighbouring lanes (a power of two), lane s of the group taking k = s,
// s + split, ...; the group folds its partials by shuffles.  More blocks
// (`multi`): each thread takes one column block and up to kMaxTasks row
// blocks (n / 4 must divide kThreads), the q-th of them bi0 + ((q + rot)
// mod kMaxTasks) bstep: `rot` staggers, CTA by CTA, which rows come first.
struct Tiles {
    int tasks, tn, m4, split, slice, t, bi0, bstep, bj, rot, k0, k1;
    bool multi;
};

// row block of a thread's q-th block, and whether it has one
__device__ __forceinline__ int bi_of(const Tiles& s, int q) {
    return s.multi ? s.bi0 + ((q + s.rot) % kMaxTasks) * s.bstep : s.bi0;
}
__device__ __forceinline__ bool has_block(const Tiles& s, int q) {
    return s.multi ? bi_of(s, q) < s.m4 : q == 0;
}

__device__ __forceinline__ Tiles tiles_of(int m, int n, int kd, bool allow_split,
                                 int rot = 0) {
    Tiles s;
    s.tn = n / 4;
    s.m4 = m / 4;
    s.rot = rot;
    s.tasks = s.m4 * s.tn;
    s.multi = s.tasks > kThreads;
    if (!s.multi) {
        int split = 1;
        if (allow_split)
            while (split < kSplitMax && s.tasks * split * 2 <= kThreads)
                split *= 2;
        s.split = split;
        s.slice = threadIdx.x & (split - 1);
        s.t = threadIdx.x / split;           // >= tasks: idle
        s.bi0 = s.t / s.tn;
        s.bj = s.t % s.tn;
        s.bstep = 0;
        s.k0 = s.slice;                      // k0, k0 + split, ... < kd
        s.k1 = kd;
    } else {
        s.split = 1;
        s.slice = 0;
        s.t = threadIdx.x;
        s.bstep = kThreads / s.tn;
        s.bi0 = threadIdx.x / s.tn;
        s.bj = threadIdx.x % s.tn;
        s.k0 = 0;
        s.k1 = kd;
    }
    return s;
}

// acc[q] += sum_{k0 <= k < k1} A[k][4 bi_q ..] (x) B[k][4 bj ..], the
// operands k-major in shared memory (rows of lda / ldb elements).
template <typename T>
__device__ __forceinline__ void mma(const Tiles& s, const T* A, int lda,
                                    const T* B, int ldb, int k0, int k1,
                                    T (&acc)[kMaxTasks][4][4]) {
    if (s.t >= s.tasks || k0 >= k1) return;
    const T* bp = B + 4 * s.bj;
    if (!s.multi) {
        // k = k0 + split * kk, kk < cnt
        const int st = s.split;
        const T* ap = A + 4 * s.bi0 + k0 * lda;
        bp += k0 * ldb;
        const int cnt = (k1 - k0 + st - 1) / st;
#pragma unroll 4
        for (int k = 0; k < cnt; ++k) {
            T a[4], b[4];
            ld4(ap + k * st * lda, a);
            ld4(bp + k * st * ldb, b);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[0][i][j] = Num<T>::mad(a[i], b[j], acc[0][i][j]);
        }
    } else {
        int aoff[kMaxTasks];
#pragma unroll
        for (int q = 0; q < kMaxTasks; ++q)
            aoff[q] = has_block(s, q) ? 4 * bi_of(s, q) : -1;
#pragma unroll 2
        for (int k = k0; k < k1; ++k) {
            T b[4];
            ld4(bp + k * ldb, b);
            const T* ak = A + k * lda;
            T a[kMaxTasks][4];
#pragma unroll
            for (int q = 0; q < kMaxTasks; ++q)
                if (aoff[q] >= 0) ld4(ak + aoff[q], a[q]);
#pragma unroll
            for (int q = 0; q < kMaxTasks; ++q) {
                if (aoff[q] >= 0) {
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            acc[q][i][j] = Num<T>::mad(a[q][i], b[j],
                                                       acc[q][i][j]);
                }
            }
        }
    }
}

// C = A^T B over kd (A: (kd, m), B: (kd, n), k-major in shared memory),
// handed in 4 x 4 blocks to epi(i0, j0, c).  Every read of A and B ends
// before the first epilogue call, so an epilogue may overwrite the
// operands; the block is synchronized on return.
template <typename T, typename Epi>
__device__ __forceinline__ void cgemm(int m, int n, int kd, const T* A,
                                      int lda, const T* B, int ldb, Epi& epi,
                                      int rot = 0) {
    const Tiles s = tiles_of(m, n, kd, true, rot);
    T acc[kMaxTasks][4][4];
#pragma unroll
    for (int q = 0; q < kMaxTasks; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[q][i][j] = T(0);
    mma(s, A, lda, B, ldb, s.k0, s.k1, acc);
    // fold the k slices of a lane group, a fixed pairwise tree
    for (int off = 1; off < s.split; off <<= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[0][i][j] += __shfl_xor_sync(0xffffffffu, acc[0][i][j], off);
    }
    __syncthreads();
    if (s.slice == 0 && s.t < s.tasks) {
#pragma unroll
        for (int q = 0; q < kMaxTasks; ++q)
            if (has_block(s, q)) epi(4 * bi_of(s, q), 4 * s.bj, acc[q]);
    }
    __syncthreads();
}

// ---- epilogues ----
// The products with a row slice of this CTA as output are computed
// transposed, out(i, j) with i < Kp a basis column and j < r a local row,
// so that both operands' 4-wide loads spread over few banks; the
// epilogues store into the row-major (r, Kp) buffers.

template <typename T> struct StoreT {      // R[j][i] = out(i, j)
    T* R; int ld;
    __device__ void operator()(int i0, int j0, T (&c)[4][4]) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            T v[4] = {c[0][b], c[1][b], c[2][b], c[3][b]};
            st4(R + (j0 + b) * ld + i0, v);
        }
    }
};

template <typename T> struct StoreBothT {  // Xt[i][j] and X[j][i]
    T* X; T* Xt; int ldx, ldt;
    __device__ void operator()(int i0, int j0, T (&c)[4][4]) {
#pragma unroll
        for (int a = 0; a < 4; ++a) st4(Xt + (i0 + a) * ldt + j0, c[a]);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            T v[4] = {c[0][b], c[1][b], c[2][b], c[3][b]};
            st4(X + (j0 + b) * ldx + i0, v);
        }
    }
};

template <typename T> struct TauSumT {     // sum of V (.) out^T
    const T* V; int ld; T part;
    __device__ void operator()(int i0, int j0, T (&c)[4][4]) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                part += V[(j0 + b) * ld + i0 + a] * c[a][b];
    }
};

template <typename T> struct ChebT {       // W = 2 (c s - Y1) - V into Y1
    T* Y1; const T* V; int ld; T coef;
    __device__ void operator()(int i0, int j0, T (&c)[4][4]) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int at = (j0 + b) * ld + i0 + a;
                Y1[at] = T(2) * (coef * c[a][b] - Y1[at]) - V[at];
            }
    }
};

// Owners of S's rows: CTA c owns the 4-row blocks c and q4 - 1 - c (of
// q4), its `half` 0 and 1, so that every owner folds about as many blocks
// on and above the diagonal.
// the 4-row block of S that CTA c owns as its `half`, or -1
__device__ __forceinline__ int owned_block(int c, int half, int q4) {
    const int b = half ? q4 - 1 - c : c;
    if (b < 0) return -1;
    return (2 * b < q4) == (half == 0) ? b : -1;
}

// a CTA's partial Gram rows, pushed into the owner's slot [cr]; only the
// blocks on and above the diagonal (S is symmetric)
template <typename T> struct GramPush {
    const Ctx<T>* cx; T* recv; int Kp;
    __device__ void operator()(int i0, int j0, T (&c)[4][4]) {
        if (i0 > j0) return;
        const int q4 = Kp / 4, b = i0 / 4, half = 2 * b < q4 ? 0 : 1;
        const int owner = half ? q4 - 1 - b : b;
        T* dst = cx->remote(recv + (cx->cr * kOwnRows + 4 * half) * Kp + j0,
                            owner);
#pragma unroll
        for (int a = 0; a < 4; ++a) st4(dst + a * Kp, c[a]);
    }
};

// ---- cluster exchanges ----

// Every CTA's (r, Kp) row slice x into every CTA's exchange region, as
// the full (kCtas r, Kp) matrix; nothing to do if the region holds x
// already (cx.staged: every writer of a staged basis or of the region
// clears it).  The first barrier makes sure no CTA still reads its
// exchange region from the phase before.  Destinations are staggered by
// rank, so the CTAs do not all push into the same one at once.
template <typename T, class D>
__device__ __forceinline__ void allgather(Ctx<T>& cx, const T* x, int r) {
    if (cx.staged == x) return;
    const Layout& l = cx.l();
    const int Kp = kp_of<D>(l);
    cx.sync();
    T* full = cx.at(l.A) + cx.cr * r * Kp;
    const int n4 = r * Kp / 4;
    for (int e = threadIdx.x; e < n4 * kCtas; e += kThreads) {
        const int dd = e / n4, f = e - dd * n4, d = (dd + cx.cr) % kCtas;
        T v[4];
        ld4(x + 4 * f, v);
        st4(cx.remote(full + 4 * f, d), v);
    }
    cx.sync();
    cx.staged = x;
}

// colv[j] = sum over all CTAs' rows i < r of f(i, j), folded in rank
// order in every CTA alike.  Each use is followed by another barrier
// before the next one writes the slots again.
template <typename T, class D, typename P, typename F>
__device__ __forceinline__ void col_reduce(Ctx<T, P>& cx, int r, F f) {
    const auto& l = cx.l();
    const int Kp = kp_of<D>(l);
    T* col = cx.at(l.col);
    for (int j = threadIdx.x; j < Kp; j += kThreads) {
        T s = T(0);
        for (int i = 0; i < r; ++i) s += f(i, j);
        for (int dd = 0; dd < kCtas; ++dd)
            *cx.remote(col + cx.cr * Kp + j, (dd + cx.cr) % kCtas) = s;
    }
    cx.sync();
    T* colv = cx.at(l.colv);
    for (int j = threadIdx.x; j < Kp; j += kThreads) {
        T s = T(0);
        for (int src = 0; src < kCtas; ++src) s += col[src * Kp + j];
        colv[j] = s;
    }
    __syncthreads();
}

// The blocks of P below the diagonal blocks from those above (P is
// symmetric), a 4 x 4 block per thread through registers; neighbouring
// lanes take neighbouring upper blocks of one block row, so the loads run
// along P's rows.
template <typename T>
__device__ __forceinline__ void mirror_lower(T* P, int ldp, int q4) {
    for (int e = threadIdx.x; e < q4 * q4; e += kThreads) {
        const int bj = e / q4, bi = e - bj * q4;
        if (bi <= bj) continue;
        T u[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x) ld4(P + (4 * bj + x) * ldp + 4 * bi, u[x]);
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            T v[4] = {u[0][y], u[1][y], u[2][y], u[3][y]};
            st4(P + (4 * bi + y) * ldp + 4 * bj, v);
        }
    }
}

// Newton-Schulz on the distributed (kCtas r, Kp) matrix whose rows
// [cr r, (cr+1) r) are X (row-major) and Xt (its transpose):
// X <- X (1.5 I - 0.5 X^T X) until max|X^T X - diag(j < keep)| <= 64 eps
// or max_ns steps.  In place; returns err <= tol.
template <typename T, class D, int RC>
__device__ bool ns(Ctx<T>& cx, T* X, T* Xt, int r_run, bool rows) {
    const Layout& l = cx.l();
    const Args<T>& a = cx.p.a;
    const T tol = T(64.0 * Num<T>::eps);
    const int Kp = kp_of<D>(l), ldp = Kp + 4, q4 = Kp / 4;
    const int r = RC ? RC : r_run;
    T* recv = cx.at(l.recv);
    T* pfull = cx.at(l.pfull);
    int it = 0;
    T err;
    cx.staged = nullptr;   // the exchange region holds S and P now
    for (;;) {
        GramPush<T> gp{&cx, recv, Kp};
        cgemm(Kp, Kp, r, X, Kp, X, Kp, gp, cx.cr);
        cx.sync();
        // this CTA's rows of S on and above the diagonal blocks: fold the
        // partials in rank order, the error, and P's rows to every CTA
        T e = T(0);
        for (int f = threadIdx.x; f < kOwnRows * q4; f += kThreads) {
            const int lr = f / q4, jb = f - lr * q4;
            const int b = owned_block(cx.cr, lr >> 2, q4);
            if (b < 0 || jb < b) continue;
            const int i = 4 * b + (lr & 3), j0 = 4 * jb;
            T s[4] = {T(0), T(0), T(0), T(0)};
            for (int src = 0; src < kCtas; ++src) {
                T v[4];
                ld4(recv + (src * kOwnRows + lr) * Kp + j0, v);
#pragma unroll
                for (int b = 0; b < 4; ++b) s[b] += v[b];
            }
            T pv[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int j = j0 + b;
                const T tgt = (i == j && j < a.keep) ? T(1) : T(0);
                e = nmax(e, Num<T>::abs(s[b] - tgt));
                pv[b] = (i == j ? T(1.5) : T(0)) - T(0.5) * s[b];
            }
            for (int dd = 0; dd < kCtas; ++dd)
                st4(cx.remote(pfull + i * ldp + j0, (dd + cx.cr) % kCtas), pv);
        }
        err = cx.all_reduce(e, MaxOp(), T(0));
        if (!(err > tol) || it >= a.max_ns) break;
        mirror_lower(pfull, ldp, q4);
        __syncthreads();
        // X <- X P, computed as (X P)^T = P X^T (P symmetric)
        StoreBothT<T> sb{X, Xt, Kp, r};
        cgemm(Kp, r, Kp, pfull, ldp, Xt, r, sb);
        ++it;
    }
    cx.ns_total += it;
    if (rows) cx.ns_rows += it;
    return err <= tol;
}

// orth(W): column balancing, mask, Frobenius prescale, Newton-Schulz,
// into the basis buffer X (rows of this CTA) and Xt
template <typename T, class D>
__device__ bool orth(Ctx<T>& cx, const T* W, T* X) {
    const Layout& l = cx.l();
    const int Kp = kp_of<D>(l), rb = rb_of<D>(l), keep = cx.p.a.keep;
    const T tiny = T(1e-30);
    T* Xt = cx.at(l.Xt);
    if (cx.staged == X) cx.staged = nullptr;
    col_reduce<T, D>(cx, rb, [&](int i, int j) {
        const T v = W[i * Kp + j];
        return v * v;
    });
    const T* colv = cx.at(l.colv);
    T q = T(0);
    for (int e = threadIdx.x; e < rb * Kp; e += kThreads) {
        const int j = e % Kp;
        const T nrm = nmax(Num<T>::sqrt(colv[j]), tiny);
        const T v = (W[e] / nrm) * mask_of<T>(j, keep);
        X[e] = v;
        q += v * v;
    }
    const T alpha = Num<T>::sqrt(cx.all_reduce(q, SumOp(), T(0))) + tiny;
    for (int e = threadIdx.x; e < rb * Kp; e += kThreads) {
        const int i = e / Kp, j = e - i * Kp;
        const T v = X[e] / alpha;
        X[e] = v;
        Xt[j * rb + i] = v;
    }
    __syncthreads();
    return ns<T, D, D::rb>(cx, X, Xt, rb, false);
}

// tau = sum(V * (G V)) without storing G V
template <typename T, class D>
__device__ T tau_of(Ctx<T>& cx, const T* Vb) {
    const Layout& l = cx.l();
    const int Kp = kp_of<D>(l), rb = rb_of<D>(l);
    allgather<T, D>(cx, Vb, rb);
    TauSumT<T> ts{Vb, Kp, T(0)};
    cgemm(Kp, rb, kCtas * rb, cx.at(l.A), Kp, cx.at(l.Gt), rb,
          ts);
    return cx.all_reduce(ts.part, SumOp(), T(0));
}

// dst (this CTA's rows) = Gn @ src; dst may be src
template <typename T, class D>
__device__ void gn_times(Ctx<T>& cx, const T* src, T* dst) {
    const Layout& l = cx.l();
    const int Kp = kp_of<D>(l), rb = rb_of<D>(l);
    allgather<T, D>(cx, src, rb);
    StoreT<T> st{dst, Kp};
    cgemm(Kp, rb, kCtas * rb, cx.at(l.A), Kp, cx.at(l.Gnt), rb,
          st);
    if (cx.staged == dst) cx.staged = nullptr;
}

template <typename T, class D>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ Params<T> p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::cluster_group cl = cg::this_cluster();
    Ctx<T> cx{cl, reinterpret_cast<T*>(smem_raw), p, (int)cl.block_rank(),
              0, 0, 0, 0, nullptr};
    const Args<T>& a = p.a;
    const Layout& l = p.l;
    const int B = a.B, M = a.M, K = a.K;
    const int Kp = kp_of<D>(l), rb = rb_of<D>(l), rm = rm_of<D>(l);
    const int Bp = kCtas * rb;
    const int cr = cx.cr;
    const T tiny = T(1e-30);
    const T eps = T(Num<T>::eps);
    const T stag_tol = T(8.0 * Num<T>::eps);
    const T noise_floor = T(4.0 * Num<T>::eps);
    const T cap_tol = T(16.0 * Num<T>::eps);
    T* blk = cx.at(l.blk);
    T* Gt = cx.at(l.Gt);
    T* Gnt = cx.at(l.Gnt);
    T* T1 = cx.at(l.T1);

    cx.sync();   // every CTA runs: its shared memory may be written

    // ---- G[:, rows of this CTA] = cur cur[rows]^T, staged by chunks ----
    T gm = T(0);
    {
        T* st = cx.at(l.A);   // st[mm][k] = cur[k][m0 + mm]
        const Tiles s = tiles_of(Bp, rb, kChunkM, false);
        T acc[kMaxTasks][4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[0][i][j] = T(0);
        for (int m0 = 0; m0 < M; m0 += kChunkM) {
            for (int e = threadIdx.x; e < Bp * kChunkM; e += kThreads) {
                const int k = e / kChunkM, mm = e - k * kChunkM;
                const int m = m0 + mm;
                st[mm * l.ldg + k] = (k < B && m < M)
                                         ? a.cur[(size_t)k * M + m] : T(0);
            }
            __syncthreads();
            mma(s, st, l.ldg, st + cr * rb, l.ldg, 0, kChunkM, acc);
            __syncthreads();
        }
        if (s.t < s.tasks) {
            const int k0 = 4 * s.bi0, j0 = 4 * s.bj;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                st4(Gt + (k0 + i) * rb + j0, acc[0][i]);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    gm = nmax(gm, Num<T>::abs(acc[0][i][j]));
            }
        }
        __syncthreads();
    }
    T trG, live, gmax;
    {
        T s = T(0), c = T(0);
        for (int il = threadIdx.x; il < rb; il += kThreads) {
            const T gii = Gt[(cr * rb + il) * rb + il];
            s += gii;
            c += gii > T(0) ? T(1) : T(0);
        }
        T v[3];
        v[0] = block_reduce(gm, MaxOp(), T(0), blk);
        v[1] = block_reduce(s, SumOp(), T(0), blk);
        v[2] = block_reduce(c, SumOp(), T(0), blk);
        cx.publish(v, 3);
        cx.sync();
        gmax = cx.fold_slots(0, MaxOp(), T(0)) + tiny;
        trG = cx.fold_slots(1, SumOp(), T(0));
        live = cx.fold_slots(2, SumOp(), T(0));
        ++cx.rnd;
    }
    const T keep_f = nmax(T(a.keep), T(1));
    const T gscale = trG + tiny;

    // Gn = G / gscale; start basis W = (G[:, :K] + 1e-3 gmax hash) * mask
    {
        const T hscale = T(1e-3) * gmax;
        for (int e = threadIdx.x; e < Bp * rb; e += kThreads)
            Gnt[e] = Gt[e] / gscale;
        for (int e = threadIdx.x; e < rb * Kp; e += kThreads) {
            const int il = e / Kp, j = e - il * Kp, i = cr * rb + il;
            T w = T(0);
            if (i < B && j < K)   // G[i][j] = G[j][i] = Gt[j][il]
                w = (Gt[j * rb + il] + hscale * start_hash<T>(i, j))
                    * mask_of<T>(j, a.keep);
            T1[e] = w;
        }
        __syncthreads();
    }

    // basis pool: V and the candidate Q (orth writes into Q in place)
    T* Vb = cx.at(l.V);
    T* Qb = cx.at(l.Q);
    bool ok = orth<T, D>(cx, T1, Qb);
    { T* t = Vb; Vb = Qb; Qb = t; }
    T tau = tau_of<T, D>(cx, Vb);

    // ---- outer loop: power / Chebyshev steps, certificates ----
    const T big = T(Num<T>::big);
    T I_prev = big, I_pprev = big;
    int stall = 0, it = 0;
    while (stall < a.stall_need && it < a.max_outer) {
        const bool power = (it % 2) == 0;
        gn_times<T, D>(cx, Vb, T1);                  // GV
        if (power) {
            gn_times<T, D>(cx, T1, T1);              // W = Gn GV
        } else {
            // column Rayleigh quotients of V (dead columns: +inf)
            const T* Vc = Vb;
            col_reduce<T, D>(cx, rb, [&](int i, int j) {
                return Vc[i * Kp + j] * T1[i * Kp + j];
            });
            const T* colv = cx.at(l.colv);
            T r = Num<T>::inf();
            for (int j = threadIdx.x; j < Kp; j += kThreads)
                r = nmin(r, j < a.keep ? colv[j] * gscale : Num<T>::inf());
            const T rmin = block_reduce(r, MinOp(), Num<T>::inf(), blk);
            const T resid = nmax(trG - tau, T(0));
            const T b_floor = T(0.5) * resid / nmax(live - keep_f, T(1))
                              + eps * trG + tiny;
            const T b = nmax(T(0.9) * rmin, b_floor);
            const T c = T(2) * gscale / b;
            for (int e = threadIdx.x; e < rb * Kp; e += kThreads)
                T1[e] = c * T1[e] - Vb[e];     // Y1
            __syncthreads();
            if (cx.staged == T1) cx.staged = nullptr;
            allgather<T, D>(cx, T1, rb);
            ChebT<T> ch{T1, Vb, Kp, c};
            cgemm(Kp, rb, Bp, cx.at(l.A), Kp, Gnt, rb, ch);
            cx.staged = nullptr;
        }
        ok = orth<T, D>(cx, T1, Qb);
        T tau2 = tau_of<T, D>(cx, Qb);
        const bool better = tau2 >= tau;
        if (better) {
            T* t = Vb; Vb = Qb; Qb = t;
        } else {
            tau2 = tau;
        }
        const T I_t = nmax(tau2 - tau, T(0));
        const T rho1 = I_t / nmax(I_prev, tiny);
        const T rho2 = I_prev / nmax(I_pprev, tiny);
        const T rho = nmin(nmax(nmax(rho1, rho2), T(0)), T(1.0 - 1e-6));
        const T bound = I_t * rho / (T(1) - rho);
        const T tau_s = nmax(tau2, tiny);
        bool cert = ok && (I_t <= noise_floor * tau_s
                           || nmax(bound, I_t) <= stag_tol * tau_s);
        cert = cert || (trG - tau2 <= cap_tol * trG);
        if (power) {
            stall = cert ? stall + 1 : 0;
            I_pprev = I_prev;
            I_prev = I_t;
        }
        tau = tau2;
        ++it;
    }
    const bool converged = stall >= a.stall_need;

    // ---- polish: fixed power steps under the monotone safeguard ----
    for (int s = 0; s < a.polish; ++s) {
        gn_times<T, D>(cx, Vb, T1);
        gn_times<T, D>(cx, T1, T1);
        const bool ok2 = orth<T, D>(cx, T1, Qb);
        const T tau2 = tau_of<T, D>(cx, Qb);
        if (ok2 && tau2 >= tau * (T(1) - stag_tol)) {
            T* t = Vb; Vb = Qb; Qb = t;
            tau = tau2;
        }
    }

    // ---- vt_raw^T = cur^T V (rows m of this CTA), row balancing, polar ----
    allgather<T, D>(cx, Vb, rb);   // V in full; phase 1's buffers are free now
    T* Cs = cx.at(l.Cs);     // Cs[b][ml] = cur[b][cr rm + ml]
    T* Y = cx.at(l.Y);
    T* Yt = cx.at(l.Yt);
    for (int e = threadIdx.x; e < Bp * rm; e += kThreads) {
        const int b = e / rm, ml = e - b * rm, m = cr * rm + ml;
        Cs[e] = (b < B && m < M) ? a.cur[(size_t)b * M + m] : T(0);
    }
    __syncthreads();
    {
        StoreT<T> st{Y, Kp};
        cgemm(Kp, rm, Bp, cx.at(l.A), Kp, Cs, rm, st);
    }
    col_reduce<T, D>(cx, rm, [&](int i, int j) {
        const T v = Y[i * Kp + j];
        return v * v;
    });
    T q = T(0);
    {
        const T* colv = cx.at(l.colv);
        for (int e = threadIdx.x; e < rm * Kp; e += kThreads) {
            const int ml = e / Kp, k = e - ml * Kp;
            const T v = Y[e] / nmax(Num<T>::sqrt(colv[k]), tiny);
            Y[e] = v;
            Yt[k * rm + ml] = v;
            q += v * v;
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < K * rm; e += kThreads) {
        const int k = e / rm, ml = e - k * rm, m = cr * rm + ml;
        if (m < M) a.vt_bal[(size_t)k * M + m] = Yt[k * rm + ml];
    }
    const T alpha = Num<T>::sqrt(cx.all_reduce(q, SumOp(), T(0))) + tiny;
    for (int e = threadIdx.x; e < rm * Kp; e += kThreads) {
        const int ml = e / Kp, k = e - ml * Kp;
        const T v = Y[e] / alpha;
        Y[e] = v;
        Yt[k * rm + ml] = v;
    }
    __syncthreads();
    const bool okp = ns<T, D, D::rm>(cx, Y, Yt, rm, true);
    for (int e = threadIdx.x; e < K * rm; e += kThreads) {
        const int k = e / rm, ml = e - k * rm, m = cr * rm + ml;
        if (m < M) a.vt0[(size_t)k * M + m] = Yt[k * rm + ml];
    }
    cx.sync();   // no CTA leaves while another may still write into it
    if (cr == 0 && threadIdx.x == 0) {
        a.flags[kOkp] = okp ? 1 : 0;
        a.flags[kConverged] = converged ? 1 : 0;
        a.flags[kOuter] = it;
        a.flags[kNs] = cx.ns_total;
        a.flags[kBarriers] = cx.syncs;
        a.flags[kClusterCtas] = kCtas;
        a.flags[kNsRows] = cx.ns_rows;
    }
}

// One 16-CTA cluster of `kern` with `bytes` of dynamic shared memory.
// `checked` is the largest size already set and checked for this kernel:
// the caller's function-local static.  Internal linkage: the
// function-local static of a template with external linkage is one object
// (a GNU unique symbol) across every library loaded in the process, so a
// second library holding this kernel would skip setting its own kernel's
// attributes and fail to launch.
template <typename Prm>
static int launch_cluster(void (*kern)(Prm), const Prm& p, size_t bytes,
                          size_t& checked, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCtas);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e;
    if (bytes > checked) {
        e = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
        if (e != cudaSuccess) return (int)e;
        e = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes);
        if (e != cudaSuccess) return (int)e;
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
        if (e != cudaSuccess) return (int)e;
        if (clusters < 1) return kUnschedulable;
        checked = bytes;
    }
    e = cudaLaunchKernelEx(&cfg, kern, p);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <typename T, class D>
static int launch_fixed(const Args<T>& a, cudaStream_t stream) {
    Params<T> p;
    p.a = a;
    p.l = layout(a.B, a.M, a.K);
    static size_t checked = 0;
    return launch_cluster(kernel<T, D>, p, (size_t)p.l.total * sizeof(T),
                          checked, stream);
}

// ---- the float64 design of the rounding's bonds (see the header) ----
namespace f64 {

constexpr int KP = 128;               // column bucket
constexpr int RB = 16;                // rows of B per CTA
constexpr int BP = kCtas * RB;        // 256
constexpr int LDR = KP + 4;           // row stride of the (r, KP) row slices
constexpr int LDG = BP + 4;           // row stride of G's rows, staged cur, Cs
constexpr int kBand = 8;              // rows of a band of S / P
constexpr int kBands = KP / kBand;    // 16
// a packed symmetric matrix keeps row i's columns j >= 8 floor(i / 8)
constexpr int kPacked = kBand * (kBands * KP - kBand * kBands * (kBands - 1) / 2);
// an owner's two 4-row blocks b and 31 - b have row lengths adding to 136
constexpr int kOwnWidth = KP + kBand;
constexpr int kRecvSrc = 4 * kOwnWidth;   // Gram partial elements per source
constexpr int kSlice1 = 64;           // basis columns per exchange slice
constexpr int kSlice2 = 32;           // ... in phase 2, beside cur's columns
constexpr int kGramTiles = 72;        // 16 x 8 tiles with tj >= 2 ti
constexpr int kGramPerWarp = kGramTiles / kWarps;
static_assert(kGramTiles == kGramPerWarp * kWarps, "Gram tiles per warp");
static_assert(2 * kCtas * 4 == KP, "two 4-row blocks of S per CTA");

__host__ __device__ constexpr int band_len(int t) { return KP - kBand * t; }
__host__ __device__ constexpr int band_off(int t) {
    return kBand * (KP * t - kBand * t * (t - 1) / 2);
}
// column swizzle of row i of band t: XOR bits 2-3 (t even: rows are a
// multiple of 16 long) or bit 2 (t odd), so that the B fragment of a
// 4-row k-step, direct or transposed, hits 16 distinct banks
__device__ __forceinline__ int swz(int i, int t) {
    return (t & 1) ? (((i >> 1) & 1) << 2) : ((i & 3) << 2);
}
// element (i, j), j >= 8 floor(i / 8), of a packed symmetric matrix
__device__ __forceinline__ int pidx(int i, int j) {
    const int t = i >> 3;
    return band_off(t) + (i & 7) * band_len(t) + ((j - kBand * t) ^ swz(i, t));
}

struct Layout {
    int Kp, rm;                 // KP; rows of M per CTA (16 or 32)
    int stage, slice, Cs;       // exchange: staged cur chunk, basis slice,
    int recv, P;                //   cur's columns; Gram partials, packed P
    int Grow, Y, S0, S1;        // G's rows (phase 2: Y), two bases
    int col, colv, red, blk, total;
};

__host__ __device__ inline Layout layout(int M) {
    Layout l;
    l.Kp = KP;
    l.rm = imax(16, pow2_at_least((M + kCtas - 1) / kCtas));
    l.stage = l.slice = l.recv = 0;
    l.P = kPacked;
    l.Cs = BP * kSlice2;
    int o = imax(imax(2 * kPacked, BP * kSlice1),
                 imax(BP * kSlice2 + l.rm * LDG, kChunkM * LDG));
    l.Grow = l.Y = o;
    o += imax(RB * LDG, l.rm * LDR);
    l.S0 = o; o += RB * LDR;
    l.S1 = o; o += RB * LDR;
    l.col = o; o += kCtas * KP;
    l.colv = o; o += KP;
    l.red = o; o += 2 * kCtas * kWarps;
    l.blk = o; o += up4(kWarps + 1);
    l.total = o;
    return l;
}

// whether a (B, M) double input with column bucket K takes this design
inline bool takes(const cluster::Layout& l, int M) {
    return l.Kp == KP && l.rb == RB && layout(M).rm <= 32;
}

struct Params {
    Args<double> a;
    Layout l;
};
using Cx = Ctx<double, Params>;

// D += A B on the FP64 tensor cores, one m16n8k4 tile per warp: lane
// (g, t) = (lane / 4, lane % 4) holds a0 = A[g][t], a1 = A[g + 8][t],
// b = B[t][g], and d = C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1]
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double b) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(b));
}

// out(j, i) = sum_k A[j][k] X[k][i] for the R rows j of A (row-major, ld
// LDG) and every column i < KP, X the distributed (BP, KP) basis whose
// rows [cr RB, (cr + 1) RB) are this CTA's `src` (ld LDR).  X goes round
// in column slices of SW: every CTA pushes its rows of the slice into
// every CTA's slice buffer (swizzled), one barrier, then each warp
// computes one 16 x 8 tile of the slice's output over k < BP (two
// accumulators, even and odd k-steps, added at the end) and hands it to
// epi(j, i, v0, v1) for columns i, i + 1.  The barrier before each push
// makes sure no CTA still reads its buffer.  A slice's columns of src are
// pushed before that slice's epilogues run, so epi may overwrite them.
template <int R, int SW, class Epi>
__device__ __forceinline__ void slice_product(Cx& cx, const double* A,
                                              const double* src, Epi& epi) {
    constexpr int NT = SW / 8, TILES = (R / 16) * NT;
    static_assert(TILES <= kWarps, "one output tile per warp");
    constexpr int n4 = RB * SW / 4;   // 4-wide groups of this CTA's part
    double* buf = cx.at(cx.l().slice);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, cr = cx.cr;
#pragma unroll 1
    for (int s = 0; s < KP / SW; ++s) {
        cx.sync();
        for (int e = threadIdx.x; e < n4 * kCtas; e += kThreads) {
            const int dd = e / n4, f = e - dd * n4, d = (dd + cr) % kCtas;
            const int row = f / (SW / 4), c4 = 4 * (f - row * (SW / 4));
            const int k = cr * RB + row;
            double v[4];
            ld4(src + row * LDR + s * SW + c4, v);
            double* at = buf + k * SW + (c4 ^ ((k & 3) << 2));
            st4(d == cr ? at : cx.remote(at, d), v);
        }
        cx.sync();
        if (warp < TILES) {
            const int mt = warp / NT, nt = warp - mt * NT;
            const double* ap = A + (16 * mt + g) * LDG + t;
            const double* bp = buf + t * SW + ((8 * nt + g) ^ (t << 2));
            double c0[4] = {0.0, 0.0, 0.0, 0.0}, c1[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 8
            for (int ks = 0; ks < BP / 4; ks += 2) {
                dmma(c0, ap[4 * ks], ap[4 * ks + 8 * LDG], bp[4 * ks * SW]);
                dmma(c1, ap[4 * ks + 4], ap[4 * ks + 4 + 8 * LDG],
                     bp[(4 * ks + 4) * SW]);
            }
            const int i = s * SW + 8 * nt + 2 * t;
            epi(16 * mt + g, i, c0[0] + c1[0], c0[1] + c1[1]);
            epi(16 * mt + 8 + g, i, c0[2] + c1[2], c0[3] + c1[3]);
        }
    }
    __syncthreads();
}

// a CTA's partial Gram elements (i, j), (i, j + 1) into the owner of row
// i: 4-row block b = i / 4 belongs to CTA b (its first 4 rows) or 31 - b
// (its last 4), each row packed from column 8 floor(i / 8)
__device__ __forceinline__ void push_gram(const Cx& cx, double* recv, int i,
                                          int j, double v0, double v1) {
    const int b = i >> 2, half = b >= kCtas;
    const int owner = half ? 2 * kCtas - 1 - b : b;
    const int L1 = band_len(owner >> 1);
    const int row = half ? 4 * L1 + (i & 3) * (kOwnWidth - L1) : (i & 3) * L1;
    double* dst = recv + cx.cr * kRecvSrc + row + j - kBand * (i >> 3);
    if (owner != cx.cr) dst = cx.remote(dst, owner);
    *reinterpret_cast<double2*>(dst) = make_double2(v0, v1);
}

// Newton-Schulz on the distributed (kCtas R, KP) matrix whose rows
// [cr R, (cr+1) R) are X (ld LDR): X <- X (1.5 I - 0.5 X^T X) until
// max|X^T X - diag(j < keep)| <= 64 eps or max_ns steps.  A step: each
// warp's 9 Gram tiles (16 x 8, tj >= 2 ti) over the R local rows, pushed
// to the owners; barrier; each owner folds the 16 partials of its 136
// groups of 4 in rank order, takes the error and pushes P's groups to
// every CTA; barrier (the error's all-reduce); X P from the packed P
// (direct above the band diagonal, transposed below), in place.
template <int R>
__device__ bool ns(Cx& cx, double* X) {
    const Args<double>& a = cx.p.a;
    const double tol = 64.0 * DBL_EPSILON;
    double* recv = cx.at(cx.l().recv);
    double* P = cx.at(cx.l().P);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3, cr = cx.cr;
    // this warp's Gram tiles: n = warp + 8 q, row u(17 - u) <= n
    int ti[kGramPerWarp], tj[kGramPerWarp];
#pragma unroll
    for (int q = 0; q < kGramPerWarp; ++q) {
        const int n = warp + kWarps * q;
        int u = 0;
        while (n >= (u + 1) * (16 - u)) ++u;
        ti[q] = u;
        tj[q] = 2 * u + n - u * (17 - u);
    }
    // this CTA's rows of S: blocks cr and 31 - cr, 4 rows each
    const int L1 = band_len(cr >> 1), L2 = kOwnWidth - L1;
    constexpr int UT = (R / 16) * (KP / 8) / kWarps;   // update tiles a warp
    int it = 0;
    double err;
    for (;;) {
        // each tile's product, then its push: the stores drain while the
        // next tiles' products run
#pragma unroll
        for (int q = 0; q < kGramPerWarp; ++q) {
            double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
            for (int ks = 0; ks < R / 4; ++ks) {
                const double* xr = X + (4 * ks + t) * LDR + g;
                dmma(acc, xr[16 * ti[q]], xr[16 * ti[q] + 8], xr[8 * tj[q]]);
            }
            const int j = 8 * tj[q] + 2 * t;
            push_gram(cx, recv, 16 * ti[q] + g, j, acc[0], acc[1]);
            if (2 * ti[q] + 1 <= tj[q])
                push_gram(cx, recv, 16 * ti[q] + 8 + g, j, acc[2], acc[3]);
        }
        cx.sync();
        double e = 0.0;
        if (threadIdx.x < kOwnWidth) {
            const int f4 = 4 * threadIdx.x;
            int i, rc;
            if (f4 < 4 * L1) {
                const int lr = f4 / L1;
                i = 4 * cr + lr;
                rc = f4 - lr * L1;
            } else {
                const int f2 = f4 - 4 * L1, lr = f2 / L2;
                i = 4 * (2 * kCtas - 1 - cr) + lr;
                rc = f2 - lr * L2;
            }
            double s[4] = {0.0, 0.0, 0.0, 0.0};
            for (int src = 0; src < kCtas; ++src) {
                double v[4];
                ld4(recv + src * kRecvSrc + f4, v);
#pragma unroll
                for (int b = 0; b < 4; ++b) s[b] += v[b];
            }
            const int tb = i >> 3, j0 = kBand * tb + rc;
            double pv[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int j = j0 + b;
                const double tgt = (i == j && j < a.keep) ? 1.0 : 0.0;
                e = nmax(e, fabs(s[b] - tgt));
                pv[b] = (i == j ? 1.5 : 0.0) - 0.5 * s[b];
            }
            double* dst = P + band_off(tb) + (i & 7) * band_len(tb)
                          + (rc ^ swz(i, tb));
            st4(dst, pv);
            for (int dd = 1; dd < kCtas; ++dd)
                st4(cx.remote(dst, (dd + cr) % kCtas), pv);
        }
        err = cx.all_reduce(e, MaxOp(), 0.0);
        if (!(err > tol) || it >= a.max_ns) break;
        // X <- X P: tiles warp + 8 u of the (R, KP) output
        double out[UT][4];
#pragma unroll
        for (int u = 0; u < UT; ++u)
            out[u][0] = out[u][1] = out[u][2] = out[u][3] = 0.0;
#pragma unroll 4
        for (int ks = 0; ks < KP / 4; ++ks) {
            const int k0 = 4 * ks, kb = k0 >> 3;
#pragma unroll
            for (int u = 0; u < UT; ++u) {
                const int tile = warp + kWarps * u;
                const int mt = tile / (KP / 8), nt = tile % (KP / 8);
                const double* xa = X + (16 * mt + g) * LDR + k0 + t;
                const double b = nt >= kb ? P[pidx(k0 + t, 8 * nt + g)]
                                          : P[pidx(8 * nt + g, k0 + t)];
                dmma(out[u], xa[0], xa[8 * LDR], b);
            }
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < UT; ++u) {
            const int tile = warp + kWarps * u;
            const int mt = tile / (KP / 8), nt = tile % (KP / 8);
            double* x0 = X + (16 * mt + g) * LDR + 8 * nt + 2 * t;
            *reinterpret_cast<double2*>(x0) = make_double2(out[u][0], out[u][1]);
            *reinterpret_cast<double2*>(x0 + 8 * LDR) =
                make_double2(out[u][2], out[u][3]);
        }
        __syncthreads();
        ++it;
    }
    cx.ns_total += it;
    return err <= tol;
}

// orth(X) in place: column balancing, mask, Frobenius prescale,
// Newton-Schulz
template <class D>
__device__ bool orth(Cx& cx, double* X) {
    const int keep = cx.p.a.keep;
    const double tiny = 1e-30;
    col_reduce<double, D>(cx, RB, [&](int i, int j) {
        const double v = X[i * LDR + j];
        return v * v;
    });
    const double* colv = cx.at(cx.l().colv);
    double q = 0.0;
    for (int e = threadIdx.x; e < RB * KP; e += kThreads) {
        const int i = e / KP, j = e - i * KP, at = i * LDR + j;
        const double nrm = nmax(::sqrt(colv[j]), tiny);
        const double v = (X[at] / nrm) * mask_of<double>(j, keep);
        X[at] = v;
        q += v * v;
    }
    const double alpha = ::sqrt(cx.all_reduce(q, SumOp(), 0.0)) + tiny;
    for (int e = threadIdx.x; e < RB * KP; e += kThreads) {
        const int i = e / KP, at = i * LDR + e - i * KP;
        X[at] = X[at] / alpha;
    }
    __syncthreads();
    return ns<RB>(cx, X);
}

// ---- epilogues of slice_product: (row j, columns i and i + 1) ----
struct GnEpi {             // dst = (G src) / tr(G), the Gn product
    double* dst; double gs;
    __device__ void operator()(int j, int i, double v0, double v1) {
        double* d = dst + j * LDR + i;
        d[0] = v0 / gs;
        d[1] = v1 / gs;
    }
};
struct TauEpi {            // sum of X (.) (G X)
    const double* X; double part;
    __device__ void operator()(int j, int i, double v0, double v1) {
        const double* x = X + j * LDR + i;
        part += x[0] * v0;
        part += x[1] * v1;
    }
};
struct ChebEpi {           // W = 2 (c Gn Y1 - Y1) - V into Y1
    double* Y1; const double* V; double coef, gs;
    __device__ void operator()(int j, int i, double v0, double v1) {
        const int at = j * LDR + i;
        Y1[at] = 2.0 * (coef * (v0 / gs) - Y1[at]) - V[at];
        Y1[at + 1] = 2.0 * (coef * (v1 / gs) - Y1[at + 1]) - V[at + 1];
    }
};
struct StoreEpi {
    double* Y;
    __device__ void operator()(int j, int i, double v0, double v1) {
        *reinterpret_cast<double2*>(Y + j * LDR + i) = make_double2(v0, v1);
    }
};

template <class D>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ Params p) {
    static_assert(D::kp == KP && D::rb == RB, "the f64 design's shape");
    constexpr int RM = D::rm;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::cluster_group cl = cg::this_cluster();
    Cx cx{cl, reinterpret_cast<double*>(smem_raw), p, (int)cl.block_rank(),
          0, 0, 0, 0, nullptr};
    const Args<double>& a = p.a;
    const Layout& l = p.l;
    const int B = a.B, M = a.M, K = a.K, cr = cx.cr;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const double tiny = 1e-30;
    const double eps = DBL_EPSILON;
    const double stag_tol = 8.0 * DBL_EPSILON;
    const double noise_floor = 4.0 * DBL_EPSILON;
    const double cap_tol = 16.0 * DBL_EPSILON;
    double* blk = cx.at(l.blk);
    double* Grow = cx.at(l.Grow);

    cx.sync();   // every CTA runs: its shared memory may be written

    // ---- Grow[j][k] = sum_m cur[cr RB + j][m] cur[k][m], staged by chunks;
    // warp w takes the 16 x 8 tiles of columns 8 (w + 8 u) ----
    double gm = 0.0;
    {
        double* st = cx.at(l.stage);   // st[mm][k] = cur[k][m0 + mm]
        constexpr int U = BP / 8 / kWarps;
        double acc[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u)
            acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0;
        for (int m0 = 0; m0 < M; m0 += kChunkM) {
            for (int e = threadIdx.x; e < BP * kChunkM; e += kThreads) {
                const int k = e / kChunkM, mm = e - k * kChunkM, m = m0 + mm;
                st[mm * LDG + k] = (k < B && m < M)
                                       ? a.cur[(size_t)k * M + m] : 0.0;
            }
            __syncthreads();
#pragma unroll
            for (int ks = 0; ks < kChunkM / 4; ++ks) {
                const double* sr = st + (4 * ks + t) * LDG + g;
                const double a0 = sr[cr * RB], a1 = sr[cr * RB + 8];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    dmma(acc[u], a0, a1, sr[8 * (warp + kWarps * u)]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            double* gr = Grow + g * LDG + 8 * (warp + kWarps * u) + 2 * t;
            *reinterpret_cast<double2*>(gr) = make_double2(acc[u][0], acc[u][1]);
            *reinterpret_cast<double2*>(gr + 8 * LDG) =
                make_double2(acc[u][2], acc[u][3]);
#pragma unroll
            for (int v = 0; v < 4; ++v) gm = nmax(gm, fabs(acc[u][v]));
        }
        __syncthreads();
    }
    double trG, live, gmax;
    {
        double s = 0.0, c = 0.0;
        for (int il = threadIdx.x; il < RB; il += kThreads) {
            const double gii = Grow[il * LDG + cr * RB + il];
            s += gii;
            c += gii > 0.0 ? 1.0 : 0.0;
        }
        double v[3];
        v[0] = block_reduce(gm, MaxOp(), 0.0, blk);
        v[1] = block_reduce(s, SumOp(), 0.0, blk);
        v[2] = block_reduce(c, SumOp(), 0.0, blk);
        cx.publish(v, 3);
        cx.sync();
        gmax = cx.fold_slots(0, MaxOp(), 0.0) + tiny;
        trG = cx.fold_slots(1, SumOp(), 0.0);
        live = cx.fold_slots(2, SumOp(), 0.0);
        ++cx.rnd;
    }
    const double keep_f = nmax(double(a.keep), 1.0);
    const double gscale = trG + tiny;

    // the current basis V and the work basis W (candidate after orth)
    double* Vb = cx.at(l.S0);
    double* Wb = cx.at(l.S1);
    // start basis W = (G[:, :K] + 1e-3 gmax hash) * mask
    {
        const double hscale = 1e-3 * gmax;
        for (int e = threadIdx.x; e < RB * KP; e += kThreads) {
            const int il = e / KP, j = e - il * KP, i = cr * RB + il;
            double w = 0.0;
            if (i < B && j < K)
                w = (Grow[il * LDG + j] + hscale * start_hash<double>(i, j))
                    * mask_of<double>(j, a.keep);
            Wb[il * LDR + j] = w;
        }
        __syncthreads();
    }
    auto gn_times = [&](const double* src, double* dst) {
        GnEpi ge{dst, gscale};
        slice_product<RB, kSlice1>(cx, Grow, src, ge);
    };
    auto tau_of = [&](const double* X) {
        TauEpi te{X, 0.0};
        slice_product<RB, kSlice1>(cx, Grow, X, te);
        return cx.all_reduce(te.part, SumOp(), 0.0);
    };
    bool ok = orth<D>(cx, Wb);
    { double* x = Vb; Vb = Wb; Wb = x; }
    double tau = tau_of(Vb);

    // ---- outer loop: power / Chebyshev steps, certificates ----
    const double big = DBL_MAX / 4.0;
    double I_prev = big, I_pprev = big;
    int stall = 0, it = 0;
    while (stall < a.stall_need && it < a.max_outer) {
        const bool power = (it % 2) == 0;
        gn_times(Vb, Wb);                            // GV
        if (power) {
            gn_times(Wb, Wb);                        // W = Gn GV
        } else {
            const double* Vc = Vb;
            const double* GV = Wb;
            col_reduce<double, D>(cx, RB, [&](int i, int j) {
                return Vc[i * LDR + j] * GV[i * LDR + j];
            });
            const double* colv = cx.at(l.colv);
            double r = Num<double>::inf();
            for (int j = threadIdx.x; j < KP; j += kThreads)
                r = nmin(r, j < a.keep ? colv[j] * gscale : Num<double>::inf());
            const double rmin = block_reduce(r, MinOp(), Num<double>::inf(), blk);
            const double resid = nmax(trG - tau, 0.0);
            const double b_floor = 0.5 * resid / nmax(live - keep_f, 1.0)
                                   + eps * trG + tiny;
            const double b = nmax(0.9 * rmin, b_floor);
            const double c = 2.0 * gscale / b;
            for (int e = threadIdx.x; e < RB * KP; e += kThreads) {
                const int i = e / KP, at = i * LDR + e - i * KP;
                Wb[at] = c * Wb[at] - Vb[at];        // Y1
            }
            __syncthreads();
            ChebEpi ch{Wb, Vb, c, gscale};
            slice_product<RB, kSlice1>(cx, Grow, Wb, ch);
        }
        ok = orth<D>(cx, Wb);
        double tau2 = tau_of(Wb);
        const bool better = tau2 >= tau;
        if (better) {
            double* x = Vb; Vb = Wb; Wb = x;
        } else {
            tau2 = tau;
        }
        const double I_t = nmax(tau2 - tau, 0.0);
        const double rho1 = I_t / nmax(I_prev, tiny);
        const double rho2 = I_prev / nmax(I_pprev, tiny);
        const double rho = nmin(nmax(nmax(rho1, rho2), 0.0), 1.0 - 1e-6);
        const double bound = I_t * rho / (1.0 - rho);
        const double tau_s = nmax(tau2, tiny);
        bool cert = ok && (I_t <= noise_floor * tau_s
                           || nmax(bound, I_t) <= stag_tol * tau_s);
        cert = cert || (trG - tau2 <= cap_tol * trG);
        if (power) {
            stall = cert ? stall + 1 : 0;
            I_pprev = I_prev;
            I_prev = I_t;
        }
        tau = tau2;
        ++it;
    }
    const bool converged = stall >= a.stall_need;

    // ---- polish: fixed power steps under the monotone safeguard ----
    for (int s = 0; s < a.polish; ++s) {
        gn_times(Vb, Wb);
        gn_times(Wb, Wb);
        const bool ok2 = orth<D>(cx, Wb);
        const double tau2 = tau_of(Wb);
        if (ok2 && tau2 >= tau * (1.0 - stag_tol)) {
            double* x = Vb; Vb = Wb; Wb = x;
            tau = tau2;
        }
    }

    // ---- Y = cur^T V (rows m of this CTA), row balancing, polar ----
    double* Cs = cx.at(l.Cs);   // Cs[ml][b] = cur[b][cr RM + ml]
    double* Y = cx.at(l.Y);     // G's rows are free now
    for (int e = threadIdx.x; e < BP * RM; e += kThreads) {
        const int b = e / RM, ml = e - b * RM, m = cr * RM + ml;
        Cs[ml * LDG + b] = (b < B && m < M) ? a.cur[(size_t)b * M + m] : 0.0;
    }
    __syncthreads();
    {
        StoreEpi st{Y};
        slice_product<RM, kSlice2>(cx, Cs, Vb, st);
    }
    col_reduce<double, D>(cx, RM, [&](int i, int j) {
        const double v = Y[i * LDR + j];
        return v * v;
    });
    double q = 0.0;
    {
        const double* colv = cx.at(l.colv);
        for (int e = threadIdx.x; e < RM * KP; e += kThreads) {
            const int ml = e / KP, k = e - ml * KP, at = ml * LDR + k;
            const double v = Y[at] / nmax(::sqrt(colv[k]), tiny);
            Y[at] = v;
            q += v * v;
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < K * RM; e += kThreads) {
        const int k = e / RM, ml = e - k * RM, m = cr * RM + ml;
        if (m < M) a.vt_bal[(size_t)k * M + m] = Y[ml * LDR + k];
    }
    const double alpha = ::sqrt(cx.all_reduce(q, SumOp(), 0.0)) + tiny;
    for (int e = threadIdx.x; e < RM * KP; e += kThreads) {
        const int ml = e / KP, at = ml * LDR + e - ml * KP;
        Y[at] = Y[at] / alpha;
    }
    __syncthreads();
    const int ns_before = cx.ns_total;
    const bool okp = ns<RM>(cx, Y);
    cx.ns_rows += cx.ns_total - ns_before;
    for (int e = threadIdx.x; e < K * RM; e += kThreads) {
        const int k = e / RM, ml = e - k * RM, m = cr * RM + ml;
        if (m < M) a.vt0[(size_t)k * M + m] = Y[ml * LDR + k];
    }
    cx.sync();   // no CTA leaves while another may still write into it
    if (cr == 0 && threadIdx.x == 0) {
        a.flags[kOkp] = okp ? 1 : 0;
        a.flags[kConverged] = converged ? 1 : 0;
        a.flags[kOuter] = it;
        a.flags[kNs] = cx.ns_total;
        a.flags[kBarriers] = cx.syncs;
        a.flags[kClusterCtas] = kCtas;
        a.flags[kNsRows] = cx.ns_rows;
    }
}

template <class D>
static int launch(const Args<double>& a, cudaStream_t stream) {
    Params p;
    p.a = a;
    p.l = layout(a.M);
    static size_t checked = 0;
    return launch_cluster(kernel<D>, p, (size_t)p.l.total * sizeof(double),
                          checked, stream);
}

}  // namespace f64

template <typename T> bool fits(int B, int M, int K) {
    const Layout l = layout(B, M, K);
    if (!shape_ok(l)) return false;
    size_t bytes = (size_t)l.total * sizeof(T);
    if (std::is_same<T, double>::value && f64::takes(l, M))
        bytes = (size_t)f64::layout(M).total * sizeof(double);
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return false;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return false;
    return bytes <= (size_t)optin;
}

// the rounding's bonds, (256, 256) and (256, 512) in the 128 bucket, take
// instantiations with fixed sizes: in f32 of the kernel above, in f64 of
// the f64 design; every other shape the generic kernel
template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
    const Layout l = layout(a.B, a.M, a.K);
    if constexpr (std::is_same<T, float>::value) {
        if (l.Kp == 128 && l.rb == 16) {
            if (l.rm == 16) return launch_fixed<T, Fixed<128, 16, 16>>(a, stream);
            if (l.rm == 32) return launch_fixed<T, Fixed<128, 16, 32>>(a, stream);
        }
    } else if (f64::takes(l, a.M)) {
        if (f64::layout(a.M).rm == 16)
            return f64::launch<Fixed<128, 16, 16>>(a, stream);
        return f64::launch<Fixed<128, 16, 32>>(a, stream);
    }
    return launch_fixed<T, Generic>(a, stream);
}

}  // namespace cluster

template <typename T>
int run(const T* cur, int B, int M, int K, int keep, int max_outer,
        int max_ns, int polish, int stall_need, void* ws, T* vt0, T* vt_bal,
        int* flags, void* stream) {
    Args<T> a;
    a.cur = cur; a.B = B; a.M = M; a.K = K;
    a.keep = keep < 0 ? 0 : (keep < K ? keep : K);
    a.max_outer = max_outer; a.max_ns = max_ns; a.polish = polish;
    a.stall_need = stall_need;
    a.vt0 = vt0; a.vt_bal = vt_bal; a.flags = flags;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cluster::fits<T>(B, M, K)) return cluster::launch<T>(a, s);
    return grid::launch<T>(a, ws, s);
}

}  // namespace gemm_exact

// CTAs per cluster of the route a (B, M) input with column bucket K and
// elements of `elt` bytes takes on the current device: 16 for the cluster
// route, 0 for the grid route.
extern "C" int xerus_gemm_exact_route(int B, int M, int K, int elt) {
    const bool fit = elt == 4 ? gemm_exact::cluster::fits<float>(B, M, K)
                              : gemm_exact::cluster::fits<double>(B, M, K);
    return fit ? gemm_exact::cluster::kCtas : 0;
}

// Bytes of device workspace the wrapper allocates: none for the cluster
// route (its state lives in shared memory), the grid route's layout else.
extern "C" size_t xerus_gemm_exact_workspace_bytes(int B, int M, int K,
                                                   int elt) {
    if (xerus_gemm_exact_route(B, M, K, elt)) return 0;
    return gemm_exact::grid::layout(B, M, K).total * (size_t)elt;
}

// Error code of a launch whose cluster the card cannot schedule.
extern "C" int xerus_gemm_exact_unschedulable() {
    return gemm_exact::cluster::kUnschedulable;
}

// One certified truncation of the contiguous (B, M) `cur` on the current
// device, launched on `stream`: vt0 and vt_bal are (K, M), flags
// int32[kFlags].  Allocates nothing, does not synchronize; returns the
// launch's CUDA error code (0 on success).
extern "C" int xerus_gemm_exact_f32(const float* cur, int B, int M, int K,
                                    int keep, int max_outer, int max_ns,
                                    int polish, int stall_need, void* ws,
                                    float* vt0, float* vt_bal, int* flags,
                                    void* stream) {
    return gemm_exact::run<float>(cur, B, M, K, keep, max_outer, max_ns,
                                  polish, stall_need, ws, vt0, vt_bal, flags,
                                  stream);
}

extern "C" int xerus_gemm_exact_f64(const double* cur, int B, int M, int K,
                                    int keep, int max_outer, int max_ns,
                                    int polish, int stall_need, void* ws,
                                    double* vt0, double* vt_bal, int* flags,
                                    void* stream) {
    return gemm_exact::run<double>(cur, B, M, K, keep, max_outer, max_ns,
                                   polish, stall_need, ws, vt0, vt_bal, flags,
                                   stream);
}
