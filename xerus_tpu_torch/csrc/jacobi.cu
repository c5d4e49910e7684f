// K4 and K5: the small dense eigen- and singular-value problems of the
// two-site DMRG sweeps by Jacobi rotations, float64, one launch per batch
// and no host read.
//
// - K4, small_eigh: the (B, m, m) symmetric Ritz problems of the Lanczos
//   and LOBPCG local solves (xerus_tpu_torch/ops/dmrg_kernels.py
//   _ritz_smallest; m = 24 for Lanczos, 3 for LOBPCG) and, past the path,
//   (256, 256) for the df rounding's eigh seed.  Ascending eigenvalues
//   (B, m) and orthonormal eigenvectors (B, m, m), eigenvector k in column
//   k.  Like torch.linalg.eigh, only the lower triangle is read.
// - K5, small_svd: the thin SVD of the (B, M, N) two-site blocks of the
//   masked split (_masked_split: (r n, n r), 32 to 128 a side on the
//   path).  U (B, M, K), S (B, K) descending, Vh (B, K, N), K = min(M, N).
//
// They replace no Pallas kernel.  The JAX package computes both with
// jnp.linalg.eigh / jnp.linalg.svd inside its compiled half-sweep programs
// (xerus_tpu/ops/dmrg_kernels.py:305, :365, :586).  The port ran
// cuSOLVER's syevd and gesvd there, and torch reads each call's info back
// to the host, so no half-sweep could be captured as a CUDA graph.  These
// kernels write a per-matrix status to the device instead (sweeps used,
// negative where a matrix did not converge in `cap` sweeps or is not
// finite) and count failures in a device health record (failures, most
// sweeps, total sweeps, matrices, rotations; 64-bit) that the solve's host
// loop reads once per solve, outside the captured region.
//
// The algorithms, mirrored step for step by the plain versions in
// xerus_tpu_torch/ops/small_eig.py (small_eigh_plain, small_svd_plain):
//
// - Pairs in parallel (round-robin) order over mm indices (mm even, >= n;
//   indices >= n are pads whose pairs are skipped): round k of mm - 1
//   pairs position 0 with the rotating positions; position j holds index
//   j == 0 ? 0 : 1 + (k + j - 1) mod (mm - 1), and pair i joins positions
//   i and mm - 1 - i, so each round's rotations touch disjoint indices and
//   run at once.  A sweep is mm - 1 rounds; a sweep with no rotation ends
//   the iteration.
// - The slot ring: pair i lives in slots 2 i and 2 i + 1 (positions i and
//   mm - 1 - i).  Between rounds every column moves to the slot of its
//   next position (j -> j - 1, 1 -> mm - 1, 0 stays): a fixed permutation,
//   so the columns of a pair always sit side by side.  Split into CTAs of
//   cpc consecutive slots, a CTA hands at most one column to each
//   neighbour a round and receives as many (ring_* in small_eig.py).
// - The rotation annihilating g in [[a, g], [g, b]], by half angles: with
//   d = b - a and r = sqrt(d^2 + 4 g^2) ((d, 2g) scaled by a power of two
//   past 1e150 or below 1e-150), h = (1 + |d| / r) / 2, c = h rsqrt(h),
//   s = sign(d g) |g| rsqrt(h) / r, t = s / c = sign(d g) |g| / (r h)
//   (tau = d / 2g's t = sign(tau) / (|tau| + sqrt(1 + tau^2)) and
//   c = 1 / sqrt(1 + t^2), rearranged); the new diagonal a - t g, b + t g.
//   Two reciprocal square roots and a reciprocal, each the SFU's
//   approximation and two Newton steps: no division or library square
//   root with its special-case branches in the chain each round waits on
//   (tau's chain has three divisions and two square roots).
//   For the pair (p, q), p < q: column p <- c p - s q, q <- s p + c q.
// - K4, cyclic two-sided Jacobi: a pair rotates where
//   |a_pq| > tol sqrt|a_pp| sqrt|a_qq| (relative, tol = m eps; computed as
//   a_pq^2 > tol^2 |a_pp a_qq| on operands scaled by a power of two): the Ritz
//   matrices carry invalid directions lifted by 1e4 (max|T| + 1), and an
//   absolute test against that norm would leave the small block
//   unresolved.  A round applies A <- J^T A J with the 2 x 2 blocks set to
//   their new diagonal and 0, and V <- V J.  Entries outside the 2 x 2
//   blocks mix only off-diagonal entries, so rounding stays relative to
//   the shrinking off-diagonal part and the relative test is reachable.
// - K5, QR-preconditioned one-sided Jacobi: W = A (M >= N) or A^T, R x C
//   with C <= R.  First a column-pivoted Householder QR, W P = Q R: step k
//   takes the unpivoted column of the largest norm over rows k.. (ties by
//   index), its reflector as LAPACK's dlarfg (beta = -sign(alpha) ||x||,
//   tau = (beta - alpha) / beta, v = x / (alpha - beta) below the
//   diagonal, kept unscaled in the pivoted column with the scale beside
//   it) and applies it to the unpivoted columns.  Then one-sided Jacobi on
//   the columns of X = R^T with V_J: a pair rotates where both columns are
//   alive (||x||^2 > (dead ||A||_F)^2, dead = R eps) and
//   |x_p . x_q| > tol ||x_p|| ||x_q|| (tol = R eps).  On graded blocks
//   (sigma from 1 down to 1e-11) the QR takes the sweeps from 19-31 down to
//   6-8.  Afterwards sigma_i = ||x_i|| (0 for a dead column), descending
//   (ties by index); the left factor Q V_J (orthonormal by construction,
//   also where sigma is 0) and the right factor P X / sigma, whose columns
//   for the zero sigma get an orthonormal completion: the first canonical
//   vector e_i (i ascending from the last one taken) whose part orthogonal
//   to the columns before it, projected out twice, keeps a squared norm
//   above 1 / 2C; normalized.  The left factor is U (the right gives Vh)
//   for M >= N, Vh^T (the right gives U) otherwise.
//
// What bounds them: latency.  A sweep is mm - 1 dependent rounds, each a
// few dot products of at most R terms per pair and a barrier; the work is
// far below the card's FP64 rate for the time the chain of rounds takes.
// The design shortens each dependent step:
//
// - K4 route cta (m <= 32): one CTA of 4 warps per matrix (2 for mm = 4).
//   Lane L holds the column in slot L, each warp a quarter of its rows (in
//   slot order, so the index arithmetic is constant: one instantiation per
//   mm = 4, 8, 16, 24, 32) and of V's, in registers.  A round is two CTA
//   barriers: the rotations (set up branch-free in the lanes of the warp
//   holding the pair's rows, into a table), then the mixes (the partner
//   column by shuffle, the row pairs by the table) and the ring through
//   shared memory.  One warp holding whole columns was no faster than
//   torch.linalg.eigh at (1, 24, 24): it issues every instruction of the
//   round's chain alone, and four warps split that issue.
// - K4 route cluster (m > 32): one thread-block cluster per matrix, cpc
//   slots a CTA; A's and V's columns (rows by index) in shared memory.  A
//   round is one cluster barrier: J^T A J on the own columns (a warp per
//   own pair, its lanes over the row pairs) and V J; each own column's
//   diagonal and its entry in the row of the index it meets next,
//   published; the barrier; the ring's columns pulled from the neighbours
//   while every CTA sets every pair's next rotation up itself from the
//   published entries (a thread a pair, the same bits in every CTA).
// - K5: one cluster per matrix, a warp per pair of a round (at most 16 a
//   CTA, so 128 registers a thread), X's and V_J's columns in slot buffers
//   (by index on one CTA, where the ring needs no move), W's columns in the
//   CTAs by blocks.  ||x_p||^2, ||x_q||^2 and x_p . x_q in one interleaved
//   butterfly, as are the QR step's ||x||^2 and the warp's two dot
//   products; one barrier a QR step and a Jacobi round; the left factor's
//   two columns a warp in registers (up to 256 rows).  One CTA up to 32
//   columns: a cluster barrier and the ring's pulls cost more than the
//   round saves there.
// - The ring keeps the columns of a CTA in place and relabels buffers: a
//   column that arrives goes to a spare buffer, one that leaves frees its
//   buffer after the next barrier.
// - Route gmem (K4 past m = 448, K5 from 360 columns of a square block,
//   where the columns do not fit the cluster's shared memory): the
//   cluster routes with the columns in a global workspace that the
//   wrapper allocates, by index, so that each round's owner reads and
//   writes them in place and the ring moves nothing.  K5 takes up to 32
//   warps a CTA there (1,024 columns).
//
// Every reduction runs in a fixed order and every element's arithmetic is
// the same whichever CTA does it, so two launches on the same input, two
// cluster sizes of one route, and route gmem against route cluster at the
// same plan give bitwise equal results.  The plain versions sum in
// torch's order, so kernel and plain version agree to rounding, not
// bitwise.  Nothing here falls back: a launch that cannot run
// returns its error and the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;   // 227 KB, the largest a block can use
constexpr int kEighThreads = 256;  // K4 route cluster
constexpr int kMaxCtas = 16;       // the largest (non-portable) cluster
constexpr int kZr = 8;             // K5: left-factor rows a lane holds
constexpr int kUnschedulable = 1000;
enum Health { kFailures, kMaxSweeps, kTotalSweeps, kMatrices, kRotations };
typedef unsigned long long u64;

// ---------------------------------------------------------------------------
// the slot ring (small_eig.py ring_pos, ring_slot, ring_index, ring_source)

__host__ __device__ constexpr int ring_pos(int mm, int s) {
    return (s & 1) ? mm - 1 - (s >> 1) : s >> 1;
}

__host__ __device__ constexpr int ring_slot(int mm, int j) {
    return j < mm / 2 ? 2 * j : 2 * (mm - 1 - j) + 1;
}

__device__ __forceinline__ int ring_index(int mm, int k, int s) {
    const int j = ring_pos(mm, s);
    int x = k + j - 1;   // < 2 (mm - 1) for k < mm: no division
    if (x >= mm - 1) x -= mm - 1;
    return j == 0 ? 0 : 1 + x;
}

// the slot whose column moves into slot s between two rounds
__host__ __device__ constexpr int ring_src(int mm, int s) {
    return ring_slot(mm, ring_pos(mm, s) == 0        ? 0
                         : ring_pos(mm, s) == mm - 1 ? 1
                                                     : ring_pos(mm, s) + 1);
}

// the slot the column of slot s moves to
__host__ __device__ constexpr int ring_dst(int mm, int s) {
    return ring_slot(mm, ring_pos(mm, s) == 0   ? 0
                         : ring_pos(mm, s) == 1 ? mm - 1
                                                : ring_pos(mm, s) - 1);
}

// The moves of one CTA's slots [s0, s0 + cpc), the same every round: the
// slots fed from another CTA (at most 2: from each neighbour one), their
// sources, and the slots whose column leaves.
struct Moves {
    int n;
    int in_sl[2], in_cta[2], in_src[2], out_sl[2];
};

__device__ Moves ring_moves(int mm, int cpc, int rank) {
    Moves mv{};
    int nout = 0;
    const int s0 = rank * cpc;
    for (int sl = 0; sl < cpc; ++sl) {
        const int src = ring_src(mm, s0 + sl);
        if (src / cpc != rank && mv.n < 2) {
            mv.in_sl[mv.n] = sl;
            mv.in_cta[mv.n] = src / cpc;
            mv.in_src[mv.n] = src % cpc;
            ++mv.n;
        }
        if (ring_dst(mm, s0 + sl) / cpc != rank && nout < 2)
            mv.out_sl[nout++] = sl;
    }
    return mv;
}

// ---------------------------------------------------------------------------
// arithmetic shared by the kernels

// reciprocal square root and reciprocal of a positive normal double: the
// SFU's approximation and two Newton steps, without the library's branches
// for zeros, infinities and subnormals (the rotation's operands are
// scaled into range)
__device__ __forceinline__ double rsqrt_pos(double x) {
    double y;
    asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
    const double hx = 0.5 * x;
    y = y * fma(-hx * y, y, 1.5);
    y = y * fma(-hx * y, y, 1.5);
    return y;
}

__device__ __forceinline__ double rcp_pos(double x) {
    double y;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
    y = y * fma(-x, y, 2.0);
    y = y * fma(-x, y, 2.0);
    return y;
}

// g != 0 (callers pass (1, 1, 1) where there is nothing to rotate)
__device__ __forceinline__ void rotation(double a, double b, double g,
                                         double& c, double& s, double& t) {
    double d = b - a, g2 = 2.0 * g;
    const double h0 = fmax(fabs(d), fabs(g2));
    if (h0 > 1e150 || h0 < 1e-150) {
        // scale by 2^(1023 - e), e the biased exponent of h0 (exact)
        const int e = min(max((__double2hiint(h0) >> 20) & 0x7ff, 1), 2046);
        const double sc = __hiloint2double((2046 - e) << 20, 0);
        d *= sc;
        g2 *= sc;
    }
    const double x = rsqrt_pos(fma(d, d, g2 * g2));    // 1 / r
    const double h = 0.5 * fma(fabs(d), x, 1.0);        // c^2, in [1/2, 1]
    const double gx = (d != 0.0 && signbit(d) != signbit(g2) ? -0.5 : 0.5)
                      * fabs(g2) * x;                   // sign(d g) |2g| / 2r
    const double rh = rsqrt_pos(h);
    c = h * rh;
    s = gx * rh;
    t = gx * rcp_pos(h);
}

// the relative off-diagonal test |g| > tol sqrt|a| sqrt|b| without square
// roots: g^2 > tol^2 |a b| on (a, b, g) scaled by a power of two (exact)
// that brings the largest into [1, 2)
__device__ __forceinline__ bool off_diagonal(double a, double b, double g,
                                             double tol) {
    const double h = fmax(fmax(fabs(a), fabs(b)), fabs(g));
    const int e = min(max((__double2hiint(h) >> 20) & 0x7ff, 1), 2046);
    const double sc = __hiloint2double((2046 - e) << 20, 0);
    const double as = a * sc, bs = b * sc, gs = g * sc;
    return gs * gs > tol * tol * fabs(as * bs);
}

// sum over the warp, the same bits in every lane (addition commutes)
__device__ __forceinline__ double warp_sum(double v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
    return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// Three sums over the warp in one interleaved butterfly: at offset 16 the
// low half keeps (a, b) and the high half (g, 0), at offset 8 each quarter
// one of them, then three plain levels; lanes 0, 8 and 16 hold the totals
// and broadcast them.  9 shuffles instead of 15, the same bits everywhere.
__device__ __forceinline__ void warp_sum3(double& a, double& b, double& g) {
    const int lane = threadIdx.x & 31;
    const bool h16 = lane & 16, h8 = lane & 8;
    const double d = 0.0;
    double k0 = h16 ? g : a, k1 = h16 ? d : b;
    k0 += __shfl_xor_sync(kFull, h16 ? a : g, 16);
    k1 += __shfl_xor_sync(kFull, h16 ? b : d, 16);
    double k = h8 ? k1 : k0;
    k += __shfl_xor_sync(kFull, h8 ? k0 : k1, 8);
    for (int off = 4; off > 0; off >>= 1) k += __shfl_xor_sync(kFull, k, off);
    a = __shfl_sync(kFull, k, 0);
    b = __shfl_sync(kFull, k, 8);
    g = __shfl_sync(kFull, k, 16);
}

// The index of the warp's largest non-negative value, ties by the smaller
// index; index -1 is no candidate.  A non-negative double orders as its bits
// do, so three integer reductions of the warp (REDUX) decide: the high
// words, the low words among them, the smallest index among those.
__device__ __forceinline__ int warp_argmax(double v, int j) {
    const unsigned long long bits = __double_as_longlong(v);
    const unsigned hi = j >= 0 ? (unsigned)(bits >> 32) : 0u;
    const unsigned lo = j >= 0 ? (unsigned)bits : 0u;
    const unsigned mhi = __reduce_max_sync(kFull, hi);
    const unsigned mlo = __reduce_max_sync(kFull, hi == mhi ? lo : 0u);
    const unsigned cand = j >= 0 && hi == mhi && lo == mlo ? (unsigned)j
                                                            : 0xffffffffu;
    return (int)__reduce_min_sync(kFull, cand);
}

__device__ void report(int* status, u64* health, int b, int sweeps,
                       bool converged, bool finite, int cap) {
    const int st = !finite ? -(cap + 1) : converged ? sweeps : -sweeps;
    status[b] = st;
    if (st <= 0) atomicAdd(&health[kFailures], 1ULL);
    atomicMax(&health[kMaxSweeps], (u64)sweeps);
    atomicAdd(&health[kTotalSweeps], (u64)sweeps);
    atomicAdd(&health[kMatrices], 1ULL);
}

template <typename T>
__device__ __forceinline__ T* at_rank(cg::cluster_group& cl, T* p, int r) {
    return cl.map_shared_rank(p, r);
}

// ---------------------------------------------------------------------------
// K4

struct EighArgs {
    const double* a;   // (B, m, m) contiguous
    double* w;         // (B, m)
    double* v;         // (B, m, m)
    int* status;       // (B,)
    u64* health;       // 5
    double* work;      // route gmem: (B, 2, m, m), A's and V's columns by
                       // index; else null
    int batch, m, mm, ctas, cap;
    double tol;
};

// Route cta: one CTA of W warps per matrix (W = 2 for mm = 4, else 4).
// Lane L < mm of every warp holds the column in slot L; warp w holds its
// rows w RW .. w RW + RW - 1 in slot order (RW = mm / W, even, so a row
// pair stays in one warp) in registers, and the same rows of V's column of
// the slot's index (V's rows by index).  A round: the warp holding a pair's
// rows sets its rotation up in the pair's two lanes (branch-free) and
// writes (c, S, new diagonal of the even slot, of the odd slot) to the
// table, S = s where the even slot holds p and -s where it holds q, so
// that both orientations read even' = c e - S o, odd' = S e + c o (S != 0
// exactly where the pair rotated: t > 0; (1, 0) where it did not); a CTA
// barrier; every warp mixes its rows of the column with the partner
// column (shuffle) and its row pairs by the table, and V's rows; the ring
// through shared memory (the block written in slot order, read back at
// the sources' rows and columns: rows and columns move alike) and a second
// barrier.  One warp issues FP64 on one SM sub-partition (16 lanes), so
// the rows are split over the warps: each issues RW / mm of the round.
template <int MM, int W>
__global__ void __launch_bounds__(32 * W, 1) small_eigh_cta_kernel(EighArgs g) {
    extern __shared__ double smem[];
    constexpr int RW = MM / W, H = MM / 2, LD = MM + 1;
    static_assert(RW % 2 == 0, "a row pair stays in one warp");
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x;
    double* blk = smem;                  // MM x LD, [row slot][column slot]
    double* tab = blk + MM * LD;         // H x 4
    double* dg = tab + H * 4;            // MM: the diagonal at the end
    const int m = g.m;
    const double* a = g.a + (size_t)b * m * m;
    const bool on = lane < MM;
    const bool ev = (lane & 1) == 0;
    const int ip = on ? lane >> 1 : 0;               // this lane's pair
    const int r0 = w * RW;                           // this warp's rows
    const bool mine = on && 2 * ip >= r0 && 2 * ip < r0 + RW;
    const int src = on ? ring_src(MM, lane) : lane;
    int srow[RW];
#pragma unroll
    for (int t = 0; t < RW; ++t) srow[t] = ring_src(MM, r0 + t);
    int idx = on ? ring_pos(MM, lane) : MM;          // >= m: a pad

    double col[RW], vc[RW];
    int bad = 0;
#pragma unroll
    for (int t = 0; t < RW; ++t) {
        const int ir = ring_pos(MM, r0 + t);
        double x = 0.0;
        if (idx < m && ir < m)
            x = ir >= idx ? a[(size_t)ir * m + idx] : a[(size_t)idx * m + ir];
        bad |= !isfinite(x);
        col[t] = x;
        vc[t] = r0 + t == idx ? 1.0 : 0.0;
    }
    bool finite = __syncthreads_or(bad) == 0;

    int sweeps = 0;
    u64 rotations = 0;   // this lane's (even lanes of their pairs' warp)
    bool converged = false;
    while (finite && sweeps < g.cap && !converged) {
        int any = 0;
        for (int k = 0; k < MM - 1; ++k) {
            // the pair's 2 x 2 block: rows 2 ip, 2 ip + 1 of this column
            double e0 = 0.0, e1 = 0.0;
#pragma unroll
            for (int u = 0; u < RW / 2; ++u)
                if (2 * u == 2 * ip - r0) {
                    e0 = col[2 * u];
                    e1 = col[2 * u + 1];
                }
            const double f0 = __shfl_xor_sync(kFull, e0, 1);
            const double f1 = __shfl_xor_sync(kFull, e1, 1);
            const int pidx = __shfl_xor_sync(kFull, idx, 1);
            const double E0 = ev ? e0 : f0, E1 = ev ? e1 : f1;
            const double O0 = ev ? f0 : e0, O1 = ev ? f1 : e1;
            const int Ie = ev ? idx : pidx, Io = ev ? pidx : idx;
            const bool ep = Ie < Io;
            const double app = ep ? E0 : O1, aqq = ep ? O1 : E0;
            const double apq = ep ? O0 : E1;                   // A[p][q]
            // lanes with no pair to rotate compute on (1, 1, 1): zeros, pads
            // and NaN would send sqrt, rsqrt and the division down their
            // slow paths, which the whole warp waits for
            const bool val = mine && Ie < m && Io < m && apq != 0.0;
            const double va = val ? app : 1.0, vb = val ? aqq : 1.0;
            const double vg = val ? apq : 1.0;
            double c, s, t;
            rotation(va, vb, vg, c, s, t);
            const bool rot = val && off_diagonal(va, vb, vg, g.tol);
            if (mine && ev) {
                const double tg = t * apq;
                double* e = tab + 4 * ip;
                e[0] = rot ? c : 1.0;
                e[1] = rot ? (ep ? s : -s) : 0.0;
                e[2] = ep ? app - tg : aqq + tg;
                e[3] = ep ? aqq + tg : app - tg;
                rotations += rot;
            }
            const int anyr = __syncthreads_or(rot);
            any |= anyr;
            if (anyr) {
                const double ci = tab[4 * ip], Si = tab[4 * ip + 1];
                const double Sx = ev ? -Si : Si;
                // A J and V J on this warp's rows: new = c own + Sx partner
#pragma unroll
                for (int t2 = 0; t2 < RW; ++t2) {
                    const double o = __shfl_xor_sync(kFull, col[t2], 1);
                    col[t2] = ci * col[t2] + Sx * o;
                }
#pragma unroll
                for (int t2 = 0; t2 < RW; ++t2) {
                    const double o = __shfl_xor_sync(kFull, vc[t2], 1);
                    vc[t2] = ci * vc[t2] + Sx * o;
                }
                // J^T (A J) on this warp's row pairs; the own block set
#pragma unroll
                for (int u = 0; u < RW / 2; ++u) {
                    const int j = r0 / 2 + u;
                    const double cj = tab[4 * j], Sj = tab[4 * j + 1];
                    const double x = col[2 * u], y = col[2 * u + 1];
                    double nx = cj * x - Sj * y, ny = Sj * x + cj * y;
                    if (j == ip && Sj != 0.0) {
                        nx = ev ? tab[4 * j + 2] : 0.0;
                        ny = ev ? 0.0 : tab[4 * j + 3];
                    }
                    col[2 * u] = nx;
                    col[2 * u + 1] = ny;
                }
            }
            // the ring: the block through shared memory, V by shuffle
            if (on) {
#pragma unroll
                for (int t2 = 0; t2 < RW; ++t2) blk[(r0 + t2) * LD + lane] = col[t2];
            }
            __syncthreads();
            if (on) {
#pragma unroll
                for (int t2 = 0; t2 < RW; ++t2) col[t2] = blk[srow[t2] * LD + src];
            }
#pragma unroll
            for (int t2 = 0; t2 < RW; ++t2) vc[t2] = __shfl_sync(kFull, vc[t2], src);
            idx = __shfl_sync(kFull, idx, src);
        }
        ++sweeps;
        converged = any == 0;
    }

    // ascending eigenvalues, ties by index
    if (on && lane >= r0 && lane < r0 + RW) {
#pragma unroll
        for (int t2 = 0; t2 < RW; ++t2)
            if (r0 + t2 == lane) dg[lane] = col[t2];
    }
    __syncthreads();
    int rank = 0, nonfinite = 0;
    const double d = on ? dg[lane] : 0.0;
    for (int j = 0; j < MM; ++j) {
        const double dj = dg[j];
        const int ij = __shfl_sync(kFull, idx, j);
        rank += ij < m && (dj < d || (dj == d && ij < idx));
        nonfinite |= ij < m && !isfinite(dj);
    }
    finite = finite && __syncthreads_or(nonfinite) == 0;
    if (on && idx < m) {
        if (w == 0) g.w[(size_t)b * m + rank] = d;
        double* vb = g.v + (size_t)b * m * m + rank;
#pragma unroll
        for (int t2 = 0; t2 < RW; ++t2)
            if (r0 + t2 < m) vb[(size_t)(r0 + t2) * m] = vc[t2];
    }
    if (rotations) atomicAdd(&g.health[kRotations], rotations);
    if (threadIdx.x == 0)
        report(g.status, g.health, b, sweeps, converged, finite, g.cap);
}

// the CTA route's warps and shared memory (small_eig.py eigh_plan mirrors)
__host__ __device__ constexpr int cta_warps(int mm) { return mm == 4 ? 2 : 4; }
__host__ __device__ constexpr long long cta_bytes(int mm) {
    return 8LL * (mm * (mm + 1) + 3 * mm);
}

// Route cluster's shared memory, per CTA (offsets in doubles, then ints):
// nb = cpc + 2 column buffers of A and of V (m rows, by index; none on
// route gmem, where A's and V's columns lie in the global workspace);
// each own slot's published (diagonal, entry in the row of the index it meets next)
// in two parities; every pair's (c, s, rotated, dp, dq) of the round; the
// own slots' diagonal at the end; ints: every pair's (p, q, the even slot
// holds p), the slot tables of the two parities, the spares, the incoming
// columns (buffer, CTA, remote buffer), flags.  small_eig.py
// _eigh_cluster_bytes mirrors `bytes`.
struct EighLayout {
    int pairs, ppc, cpc, nb;
    long long A, V, pub, all, diag, dbl, pq, sb, spare, inc, flag, bytes;
};

__host__ __device__ inline EighLayout eigh_layout(int m, int mm, int ctas,
                                                  bool gmem) {
    EighLayout L{};
    L.pairs = mm / 2;
    L.ppc = L.pairs / ctas;
    L.cpc = 2 * L.ppc;
    L.nb = gmem ? 0 : L.cpc + 2;
    long long o = 0;
    L.A = o;
    o += (long long)L.nb * m;
    L.V = o;
    o += (long long)L.nb * m;
    L.pub = o;
    o += 4LL * L.cpc;
    L.all = o;
    o += 5LL * L.pairs;
    L.diag = o;
    o += L.cpc;
    L.dbl = o;
    long long i = 0;
    L.pq = i;
    i += 3LL * L.pairs;
    L.sb = i;
    i += 2LL * L.cpc;
    L.spare = i;
    i += 2;
    L.inc = i;
    i += 6;
    L.flag = i;
    i += 4;
    L.bytes = 8 * o + 4 * i;
    return L;
}

// The ring's move between rounds, in two parts that every thread of the
// CTA calls with the same arguments.  Relabel: table `nxt` for the next
// round, the incoming columns into the spares (their remote buffers read
// from the sources' tables `cur`), the leaving columns' buffers the new
// spares.  Pull, after a __syncthreads: copy the incoming columns of A and
// of V (`len` doubles each).
__device__ void ring_relabel(cg::cluster_group& cl, const Moves& mv, int mm,
                             int cpc, int rank, const int* cur, int* nxt,
                             int* spare, int* inc, int off) {
    // threads off, off + 1 take the incoming columns (their remote reads
    // then overlap other threads' work)
    const int tid = threadIdx.x, s0 = rank * cpc, t = tid - off;
    if (tid < cpc) {
        const int src = ring_src(mm, s0 + tid);
        if (src / cpc == rank) nxt[tid] = cur[src - s0];
    }
    if (t >= 0 && t < mv.n) {
        const int sp = spare[t];
        nxt[mv.in_sl[t]] = sp;
        inc[3 * t] = sp;
        inc[3 * t + 1] = mv.in_cta[t];
        inc[3 * t + 2] = *(at_rank(cl, const_cast<int*>(cur), mv.in_cta[t])
                           + mv.in_src[t]);
        spare[t] = cur[mv.out_sl[t]];
    }
}

__device__ void ring_pull(cg::cluster_group& cl, const Moves& mv,
                          const int* inc, double* A, double* V, int len) {
    // one flat loop over (column, matrix, row): its remote loads independent
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int e = tid; e < 2 * mv.n * len; e += nt) {
        const int q = e / len, r = e - q * len, t = q >> 1;
        double* M = q & 1 ? V : A;
        const int c = inc[3 * t + 1];
        const size_t src = (size_t)inc[3 * t + 2] * len + r;
        M[(size_t)inc[3 * t] * len + r] = *(at_rank(cl, M, c) + src);
    }
}

// Publish, for each own slot (the layout of round k), its column's diagonal
// entry and its entry in the row of the index it meets in the round it is
// published for: after the move (`moved`, round k + 1) or in round k.
// The column of slot sl is in buffer cur[sl], or at its index I on route
// gmem (`gmem`).
__device__ void eigh_publish(const EighLayout& L, int mm, int m, int rank,
                             int k, bool moved, const int* cur,
                             const double* A, double* pub, bool gmem) {
    for (int sl = threadIdx.x; sl < L.cpc; sl += blockDim.x) {
        const int s = rank * L.cpc + sl;
        const int I = ring_index(mm, k, s);
        const int d = moved ? ring_dst(mm, s) : s;
        const int J = ring_index(mm, moved ? k + 1 : k, d ^ 1);
        const double* col = A + (size_t)(gmem ? (I < m ? I : 0) : cur[sl]) * m;
        pub[2 * sl] = I < m ? col[I] : 0.0;
        pub[2 * sl + 1] = I < m && J < m ? col[J] : 0.0;
    }
}

// Every pair's rotation of round kn from the published entries, a thread
// per pair and the same in every CTA: (c, s, rotated, dp, dq) and (p, q,
// the even slot holds p).  Returns whether this thread's pairs rotate.
__device__ int eigh_table(cg::cluster_group& cl, const EighLayout& L, int mm,
                          int m, int kn, bool moved, double tol,
                          const double* pub, double* all, int* pq) {
    int mine = 0;
    for (int j = threadIdx.x; j < L.pairs; j += blockDim.x) {
        const int Ie = ring_index(mm, kn, 2 * j);
        const int Io = ring_index(mm, kn, 2 * j + 1);
        const int fe = moved ? ring_src(mm, 2 * j) : 2 * j;
        const int fo = moved ? ring_src(mm, 2 * j + 1) : 2 * j + 1;
        double* pb = const_cast<double*>(pub);
        const double* pe = at_rank(cl, pb, fe / L.cpc) + 2 * (fe % L.cpc);
        const double* po = at_rank(cl, pb, fo / L.cpc) + 2 * (fo % L.cpc);
        const bool ep = Ie < Io;
        const int p = ep ? Ie : Io, q = ep ? Io : Ie;
        const double de = pe[0], oe = pe[1], dd = po[0], oo = po[1];
        const double app = ep ? de : dd, aqq = ep ? dd : de;
        const double apq = ep ? oo : oe;   // column q's entry in row p
        // (1, 1, 1) where there is nothing to rotate: no slow paths
        const bool val = q < m && apq != 0.0;
        const double va = val ? app : 1.0, vb = val ? aqq : 1.0;
        const double vg = val ? apq : 1.0;
        double c, s, t;
        rotation(va, vb, vg, c, s, t);
        const bool rot = val && off_diagonal(va, vb, vg, tol);
        double* e = all + 5 * j;
        e[0] = rot ? c : 1.0;
        e[1] = rot ? s : 0.0;
        e[2] = rot ? 1.0 : 0.0;
        e[3] = app - t * apq;
        e[4] = aqq + t * apq;
        pq[3 * j] = p;
        pq[3 * j + 1] = q;
        pq[3 * j + 2] = ep;
        mine |= rot;
    }
    return mine;
}

// Route cluster: one cluster of `ctas` CTAs per matrix, one cluster barrier
// a round.  Each CTA computes every pair's rotation itself from the 2 x 2
// blocks its neighbours published before the barrier, applies J^T A J to
// its own columns (a warp per own pair, its lanes over the row pairs) and
// V J, publishes the entries the next round's pairs need, and after the
// barrier moves the ring.  Route gmem (kGmem, where A and V do not fit the
// cluster's shared memory): A's and V's columns lie in the global
// workspace by index and a CTA works on the columns its slots hold in the
// round, so the ring moves nothing; the cluster barrier orders a column's
// writes in one round before its reads by the next owner.  The steps and
// their orders are route cluster's, so the results are bitwise its.
template <bool kGmem>
__global__ void __launch_bounds__(kEighThreads, 1)
    small_eigh_cluster_kernel(EighArgs g) {
    extern __shared__ double smem[];
    cg::cluster_group cl = cg::this_cluster();
    const int m = g.m, mm = g.mm;
    const EighLayout L = eigh_layout(m, mm, g.ctas, kGmem);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
    const int rank = (int)cl.block_rank();
    const int b = blockIdx.x / g.ctas;
    const int ppc = L.ppc, cpc = L.cpc, pairs = L.pairs, s0 = rank * cpc;
    double* A = kGmem ? g.work + (size_t)b * 2 * m * m : smem + L.A;
    double* V = kGmem ? A + (size_t)m * m : smem + L.V;
    double* pub = smem + L.pub;
    double* all = smem + L.all;
    double* diag = smem + L.diag;
    int* ib = reinterpret_cast<int*>(smem + L.dbl);
    int* pq = ib + L.pq;
    int* sb = ib + L.sb;
    int* spare = ib + L.spare;
    int* inc = ib + L.inc;
    int* flag = ib + L.flag;
    const double* a = g.a + (size_t)b * m * m;

    // round 0: own slot sl holds index ring_pos(s0 + sl) in buffer sl
    if (tid < cpc) sb[tid] = tid;
    if (tid < 2) spare[tid] = cpc + tid;
    if (tid < 4) flag[tid] = 0;
    __syncthreads();
    for (int e = tid; e < cpc * m; e += nt) {
        const int sl = e / m, r = e % m;
        const int I = ring_pos(mm, s0 + sl);
        if (kGmem && I >= m) continue;
        double x = 0.0;
        if (I < m) x = r >= I ? a[(size_t)r * m + I] : a[(size_t)I * m + r];
        if (!isfinite(x)) flag[0] = 1;
        const size_t c = kGmem ? I : sl;
        A[c * m + r] = x;
        V[c * m + r] = r == I ? 1.0 : 0.0;
    }
    const Moves mv = ring_moves(mm, cpc, rank);
    __syncthreads();
    // round 0's table; the published entries alternate parities by round
    eigh_publish(L, mm, m, rank, 0, false, sb, A, pub + 2 * cpc, kGmem);
    cl.sync();
    bool finite = true;
    for (int c = 0; c < g.ctas; ++c) finite &= *at_rank(cl, flag, c) == 0;
    int tany = __syncthreads_or(eigh_table(cl, L, mm, m, 0, false, g.tol,
                                           pub + 2 * cpc, all, pq));

    int sweeps = 0, par = 0;
    u64 rotations = 0;   // lane 0's of each warp
    bool converged = false;
    while (finite && sweeps < g.cap && !converged) {
        bool any = false;
        for (int k = 0; k < mm - 1; ++k) {
            const int* cur = sb + par * cpc;
            any |= tany != 0;
            for (int i = warp; tany && i < ppc; i += nwarps) {
                const int ci = rank * ppc + i;
                const double* ei = all + 5 * ci;
                const double fi = ei[2];
                const int p = pq[3 * ci], q = pq[3 * ci + 1];
                const bool ep = pq[3 * ci + 2] != 0;
                if (p >= m) continue;
                const bool hq = q < m;
                const int bP = kGmem ? p : cur[ep ? 2 * i : 2 * i + 1];
                const int bQ = kGmem ? (hq ? q : p)
                                     : cur[ep ? 2 * i + 1 : 2 * i];
                double* cP = A + (size_t)bP * m;
                double* cQ = A + (size_t)bQ * m;
                const double c_i = ei[0], s_i = ei[1];
#pragma unroll 4
                for (int j = lane; j < pairs; j += 32) {
                    const double* ej = all + 5 * j;
                    if (fi == 0.0 && ej[2] == 0.0) continue;
                    const int rp = pq[3 * j], rq = pq[3 * j + 1];
                    if (rp >= m) continue;
                    if (j == ci) {   // the own block, rotated
                        cP[p] = ei[3];
                        cQ[p] = 0.0;
                        cP[q] = 0.0;
                        cQ[q] = ei[4];
                        continue;
                    }
                    const bool hr = rq < m;
                    const double cj = ej[0], sj = ej[1];
                    const double a0 = cP[rp], a1 = hr ? cP[rq] : 0.0;
                    const double a2 = hq ? cQ[rp] : 0.0;
                    const double a3 = hq && hr ? cQ[rq] : 0.0;
                    const double b0 = c_i * a0 - s_i * a2;
                    const double b2 = s_i * a0 + c_i * a2;
                    const double b1 = c_i * a1 - s_i * a3;
                    const double b3 = s_i * a1 + c_i * a3;
                    cP[rp] = cj * b0 - sj * b1;
                    if (hr) cP[rq] = sj * b0 + cj * b1;
                    if (hq) {
                        cQ[rp] = cj * b2 - sj * b3;
                        if (hr) cQ[rq] = sj * b2 + cj * b3;
                    }
                }
                if (fi != 0.0) {
                    double* vP = V + (size_t)bP * m;
                    double* vQ = V + (size_t)bQ * m;
#pragma unroll 4
                    for (int r = lane; r < m; r += 32) {
                        const double x = vP[r], y = vQ[r];
                        vP[r] = c_i * x - s_i * y;
                        vQ[r] = s_i * x + c_i * y;
                    }
                    if (lane == 0) ++rotations;
                }
            }
            __syncthreads();
            eigh_publish(L, mm, m, rank, k, true, cur, A, pub + par * 2 * cpc,
                         kGmem);
            cl.sync();
            if constexpr (!kGmem)
                ring_relabel(cl, mv, mm, cpc, rank, cur, sb + (par ^ 1) * cpc,
                             spare, inc, pairs < nt - 2 ? pairs : 0);
            tany = __syncthreads_or(eigh_table(cl, L, mm, m, k + 1, true,
                                               g.tol, pub + par * 2 * cpc,
                                               all, pq));
            if constexpr (!kGmem) {
                ring_pull(cl, mv, inc, A, V, m);
                if (mv.n) __syncthreads();
            }
            par ^= 1;
        }
        ++sweeps;
        converged = !any;
    }

    // ascending eigenvalues over the cluster, ties by index
    const int* cur = sb + par * cpc;
    for (int sl = tid; sl < cpc; sl += nt) {
        const int I = ring_pos(mm, s0 + sl);
        diag[sl] = I < m ? A[(size_t)(kGmem ? I : cur[sl]) * m + I] : 0.0;
    }
    cl.sync();
    int nonfinite = 0;
    for (int sl = warp; sl < cpc; sl += nwarps) {
        const int I = ring_pos(mm, s0 + sl);
        if (I >= m) continue;
        const double d = diag[sl];
        int r = 0;
        for (int s = lane; s < mm; s += 32) {
            const int J = ring_pos(mm, s);
            if (J >= m) continue;
            const double e = *(at_rank(cl, diag, s / cpc) + s % cpc);
            r += (e < d) || (e == d && J < I);
            nonfinite |= !isfinite(e);
        }
        r = warp_sum_int(r);
        if (lane == 0) g.w[(size_t)b * m + r] = d;
        const double* vcol = V + (size_t)(kGmem ? I : cur[sl]) * m;
        double* vb = g.v + (size_t)b * m * m + r;
        for (int row = lane; row < m; row += 32) vb[(size_t)row * m] = vcol[row];
    }
    if (rotations) atomicAdd(&g.health[kRotations], rotations);
    finite = finite && __syncthreads_or(nonfinite) == 0;
    if (rank == 0 && tid == 0)
        report(g.status, g.health, b, sweeps, converged, finite, g.cap);
    cl.sync();   // no CTA leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// K5

struct SvdArgs {
    const double* a;            // W[r][c] = a[b sb + r sr + c sc]
    long long sb, sr, sc;
    double* u;                  // (B, M, K)
    double* s;                  // (B, K)
    double* vh;                 // (B, K, N)
    int* status;                // (B,)
    u64* health;                // 5
    double* work;               // route gmem: per matrix W (mm R), X and
                                // V_J (mm C each) by index; else null
    int batch, R, C, trans, mm, ctas, cap;
    double tol, dead;
};

// element (r, k) of the left factor (R x C: U, or Vh^T where trans) and of
// the right factor (C x C: Vh^T, or U where trans) of matrix b
__device__ __forceinline__ double* left_at(const SvdArgs& g, int b, int r,
                                           int k) {
    const size_t base = (size_t)b * g.R * g.C;
    return g.trans ? g.vh + base + (size_t)k * g.R + r
                   : g.u + base + (size_t)r * g.C + k;
}

__device__ __forceinline__ double* right_at(const SvdArgs& g, int b, int r,
                                            int k) {
    const size_t base = (size_t)b * g.C * g.C;
    return g.trans ? g.u + base + (size_t)r * g.C + k
                   : g.vh + base + (size_t)k * g.C + r;
}

// Shared memory per CTA (offsets in doubles, then ints): its cpc columns
// of W (R rows; columns rank cpc.. by blocks), nb = cpc + 2 slot buffers of
// X and of V_J (C rows), the staged pivot column (R; on a cluster), none
// of these on route gmem (W, X and V_J in the global workspace); (beta,
// tau, scale) of every step, the own columns' norms, the own slots'
// sigma, the warps' pivot candidates (two parities); ints: the pivots,
// the own columns' pivoted flags, the candidates' indices (two parities),
// the slot tables (two parities), the spares, the incoming columns, flags
// (three sweep flags, one more).  small_eig.py _svd_bytes mirrors
// `bytes`.
struct SvdLayout {
    int ppc, cpc, nb;
    long long W, X, V, xs, refl, nrm, sig, best, dbl;
    long long piv, done, bidx, sb, spare, inc, flag, bytes;
};

__host__ __device__ inline SvdLayout svd_layout(int R, int C, int mm,
                                                int ctas, bool gmem) {
    SvdLayout L{};
    L.ppc = mm / 2 / ctas;
    L.cpc = 2 * L.ppc;
    L.nb = gmem ? 0 : L.cpc + 2;
    long long o = 0;
    L.W = o;
    o += gmem ? 0 : (long long)R * L.cpc;
    L.X = o;
    o += (long long)L.nb * C;
    L.V = o;
    o += (long long)L.nb * C;
    L.xs = o;
    o += gmem ? 0 : R;
    L.refl = o;
    o += 3LL * C;
    L.nrm = o;
    o += L.cpc;
    L.sig = o;
    o += L.cpc;
    L.best = o;
    o += 2LL * L.ppc;
    L.dbl = o;
    long long i = 0;
    L.piv = i;
    i += C;
    L.done = i;
    i += L.cpc;
    L.bidx = i;
    i += 2LL * L.ppc;
    L.sb = i;
    i += 2LL * L.cpc;
    L.spare = i;
    i += 2;
    L.inc = i;
    i += 6;
    L.flag = i;
    i += 4;
    L.bytes = 8 * o + 4 * i;
    return L;
}

// K5's variants: one CTA (ctas = 1, its shared memory addressed as such,
// CTA barriers for the cluster's), a cluster (the ring), and route gmem: a
// cluster whose W, X and V_J lie in the global workspace, X's and V_J's
// columns by index, so the ring moves nothing; the cluster barrier orders
// a column's writes before its next owner's reads.  The steps and their
// orders are the same in all three, so route gmem's results are bitwise
// the cluster's at the same plan.
enum SvdVariant { kOneCta, kRing, kGlobal };

template <int kVar>
__global__ void __launch_bounds__(kVar == kGlobal ? 1024 : 512, 1)
    small_svd_kernel(SvdArgs g) {
    extern __shared__ double smem[];
    cg::cluster_group cl = cg::this_cluster();
    const int R = g.R, C = g.C, mm = g.mm;
    constexpr bool kSingle = kVar == kOneCta, kGmem = kVar == kGlobal;
    const SvdLayout L = svd_layout(R, C, mm, g.ctas, kGmem);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;   // warp = own pair
    const int rank = (int)cl.block_rank();
    const int b = blockIdx.x / g.ctas;
    const int ppc = L.ppc, cpc = L.cpc, c0 = rank * cpc, ctas = g.ctas;
    // X's and V_J's buffers by index (no ring) on one CTA and route gmem
    constexpr bool byidx = kVar != kRing;
    auto rank_at = [&](auto* p, int r) {
        if constexpr (kSingle) return p;
        else return at_rank(cl, p, r);
    };
    auto sync_all = [&]() {
        if constexpr (kSingle) __syncthreads();
        else cl.sync();
    };
    double* Wg = kGmem ? g.work + (size_t)b * mm * (R + 2 * C) : nullptr;
    double* W = kGmem ? Wg + (size_t)c0 * R : smem + L.W;   // own columns
    double* X = kGmem ? Wg + (size_t)mm * R : smem + L.X;
    double* V = kGmem ? X + (size_t)mm * C : smem + L.V;
    // column j of W, wherever it lies in the cluster
    auto wcol = [&](int j) -> const double* {
        if constexpr (kVar == kRing)
            return at_rank(cl, W, j / cpc) + (size_t)(j % cpc) * R;
        else return (kGmem ? Wg : W) + (size_t)j * R;
    };
    double* xst = smem + L.xs;
    double* refl = smem + L.refl;
    double* nrm = smem + L.nrm;
    double* sig = smem + L.sig;
    double* best = smem + L.best;
    int* ib = reinterpret_cast<int*>(smem + L.dbl);
    int* piv = ib + L.piv;
    int* done = ib + L.done;
    int* bidx = ib + L.bidx;
    int* sb = ib + L.sb;
    int* spare = ib + L.spare;
    int* inc = ib + L.inc;
    int* flag = ib + L.flag;
    const double* a = g.a + b * g.sb;

    // the own columns of W (zero past C), their norms
    for (int e = tid; e < cpc * R; e += nt) {
        const int jl = e / R, r = e % R, j = c0 + jl;
        W[(size_t)jl * R + r] = j < C ? a[r * g.sr + j * g.sc] : 0.0;
    }
    if (tid < cpc) done[tid] = 0;
    if (tid < 4) flag[tid] = 0;
    __syncthreads();
    {
        double bv = -1.0;
        int bj = -1;
        for (int jl = warp; jl < cpc; jl += ppc) {
            const double* w = W + (size_t)jl * R;
            double acc = 0.0;
            for (int r = lane; r < R; r += 32) acc += w[r] * w[r];
            acc = warp_sum(acc);
            if (lane == 0) nrm[jl] = acc;
            const int j = c0 + jl;
            if (j < C && (bj < 0 || acc > bv)) {
                bv = acc;
                bj = j;
            }
        }
        if (lane == 0) {
            best[warp] = bv;
            bidx[warp] = bj;
        }
    }
    sync_all();
    // ||A||_F^2 in a fixed order, the same bits in every warp
    double f2 = 0.0;
    for (int j = lane; j < C; j += 32) f2 += *(rank_at(nrm, j / cpc) + j % cpc);
    f2 = warp_sum(f2);
    const bool finite0 = isfinite(f2);
    const double dead2 = g.dead * g.dead * f2;

    // the column-pivoted Householder QR, one cluster barrier a step
    int par = 0;
    for (int k = 0; finite0 && k < C; ++k) {
        // the candidates, a lane's at once (their loads independent)
        double bv = -1.0;
        int bj = -1;
        for (int e = lane; e < ctas * ppc; e += 32) {
            const int c = e / ppc, w = e - c * ppc;
            const int j = *(rank_at(bidx, c) + par * ppc + w);
            const double v = *(rank_at(best, c) + par * ppc + w);
            if (j >= 0 && (bj < 0 || v > bv || (v == bv && j < bj))) {
                bv = v;
                bj = j;
            }
        }
        const int p = warp_argmax(bv, bj);
        if (tid == 0) piv[k] = p;
        // column p (unchanged during this step): read in place on one CTA,
        // staged from its CTA on a cluster
        const double* xs = wcol(p);
        if constexpr (kVar == kRing) {
            for (int r = k + tid; r < R; r += nt) xst[r] = xs[r];
            __syncthreads();
            xs = xst;
        }
        // ||x below k||^2 and the dot products with the warp's two own
        // columns (w, w + ppc) in one butterfly; then the reflector, the
        // same in every warp
        const int j0 = c0 + warp, j1 = j0 + ppc;
        const bool u0 = j0 < C && j0 != p && !done[warp];
        const bool u1 = j1 < C && j1 != p && !done[warp + ppc];
        double* w0 = W + (size_t)warp * R;
        double* w1 = W + (size_t)(warp + ppc) * R;
        double s2 = 0.0, d0 = 0.0, d1 = 0.0;
        for (int r = k + 1 + lane; r < R; r += 32) {
            const double x = xs[r];
            s2 += x * x;
            d0 += x * w0[r];
            d1 += x * w1[r];
        }
        warp_sum3(s2, d0, d1);
        const double alpha = xs[k];
        double beta = alpha, tau = 0.0, scale = 0.0;
        if (s2 > 0.0) {
            const double n2 = fma(alpha, alpha, s2);
            if (n2 > 1e-290 && n2 < 1e290) {   // SFU and Newton, no branches
                const double rn = rsqrt_pos(n2), nrm = n2 * rn;
                beta = alpha < 0.0 ? nrm : -nrm;
                const double rb = rcp_pos(nrm);
                tau = alpha < 0.0 ? (nrm - alpha) * rb : (alpha + nrm) * rb;
                scale = alpha < 0.0 ? -rcp_pos(nrm - alpha)
                                    : rcp_pos(alpha + nrm);
            } else {
                beta = -copysign(sqrt(n2), alpha);
                tau = (beta - alpha) / beta;
                scale = 1.0 / (alpha - beta);
            }
        }
        if (tid == 0) {
            refl[3 * k] = beta;
            refl[3 * k + 1] = tau;
            refl[3 * k + 2] = scale;
        }
        // the own unpivoted columns; the candidates of step k + 1
        const double f0 = u0 ? tau * (w0[k] + scale * d0) : 0.0;
        const double f1 = u1 ? tau * (w1[k] + scale * d1) : 0.0;
        __syncwarp();
        double n0 = 0.0, n1 = 0.0, zero = 0.0;
        for (int r = k + 1 + lane; r < R; r += 32) {
            const double v = scale * xs[r];
            const double y0 = w0[r] - f0 * v, y1 = w1[r] - f1 * v;
            if (u0) w0[r] = y0;
            if (u1) w1[r] = y1;
            n0 += y0 * y0;
            n1 += y1 * y1;
        }
        if (lane == 0) {
            if (u0) w0[k] -= f0;
            if (u1) w1[k] -= f1;
        }
        warp_sum3(n0, n1, zero);
        double cv = -1.0;
        int cj = -1;
        if (u0) {
            cv = n0;
            cj = j0;
        }
        if (u1 && (cj < 0 || n1 > cv)) {
            cv = n1;
            cj = j1;
        }
        if (lane == 0) {
            best[(par ^ 1) * ppc + warp] = cv;
            bidx[(par ^ 1) * ppc + warp] = cj;
        }
        if (tid == 0 && p / cpc == rank) done[p % cpc] = 1;
        sync_all();
        par ^= 1;
    }

    // X = R^T in the ring's round-0 slots: X[j][i] = R[i][j], V_J = I
    if (tid < cpc) sb[tid] = tid;
    if (tid < 2) spare[tid] = cpc + tid;
    for (int sl = warp; finite0 && sl < cpc; sl += ppc) {
        const int i = ring_pos(mm, c0 + sl), bf = byidx ? i : sl;
        for (int j = lane; j < C; j += 32) {
            double x = 0.0;
            if (i < C && j > i) {
                const int pj = piv[j];
                x = wcol(pj)[i];
            } else if (i < C && j == i) {
                x = refl[3 * i];
            }
            X[(size_t)bf * C + j] = x;
            V[(size_t)bf * C + j] = j == i ? 1.0 : 0.0;
        }
    }
    const Moves mv = ring_moves(mm, cpc, rank);
    __syncthreads();

    // one-sided Jacobi on X's columns, a warp per pair, one cluster
    // barrier a round; flag[s % 3] says whether sweep s rotated
    int sweeps = 0;
    u64 rotations = 0;   // this warp's, in lane 0
    bool converged = false;
    par = 0;
    while (finite0 && sweeps < g.cap && !converged) {
        if (tid == 0) flag[(sweeps + 1) % 3] = 0;
        // the warp's slots' indices, one step along the ring a round
        int Ie = ring_pos(mm, c0 + 2 * warp), Io = ring_pos(mm, c0 + 2 * warp + 1);
        for (int k = 0; k < mm - 1; ++k) {
            const int* cur = sb + par * cpc;
            const bool ep = Ie < Io, live = (ep ? Io : Ie) < C;
            const int bp = byidx ? (ep ? Ie : Io)
                                  : cur[ep ? 2 * warp : 2 * warp + 1];
            const int bq = byidx ? (ep ? Io : Ie)
                                  : cur[ep ? 2 * warp + 1 : 2 * warp];
            double* xp = X + (size_t)bp * C;
            double* xq = X + (size_t)bq * C;
            if (live) {
                double al = 0.0, be = 0.0, ga = 0.0;
                for (int r = lane; r < C; r += 32) {
                    const double x = xp[r], y = xq[r];
                    al += x * x;
                    be += y * y;
                    ga += x * y;
                }
                warp_sum3(al, be, ga);
                // (1, 1, 1) where there is nothing to rotate: no slow paths
                const bool val = al > dead2 && be > dead2 && ga != 0.0;
                const double va = val ? al : 1.0, vb = val ? be : 1.0;
                const double vg = val ? ga : 1.0;
                double c, s, t;
                rotation(va, vb, vg, c, s, t);
                if (val && off_diagonal(va, vb, vg, g.tol)) {
                    double* vp = V + (size_t)bp * C;
                    double* vq = V + (size_t)bq * C;
                    for (int r = lane; r < C; r += 32) {
                        const double x = xp[r], y = xq[r];
                        xp[r] = c * x - s * y;
                        xq[r] = s * x + c * y;
                        const double u = vp[r], w = vq[r];
                        vp[r] = c * u - s * w;
                        vq[r] = s * u + c * w;
                    }
                    if (lane == 0) {
                        ++rotations;
                        flag[sweeps % 3] = 1;
                    }
                }
            }
            sync_all();
            if constexpr (kVar == kRing) {
                ring_relabel(cl, mv, mm, cpc, rank, cur, sb + (par ^ 1) * cpc,
                             spare, inc, 0);
                __syncthreads();
                ring_pull(cl, mv, inc, X, V, C);
                if (mv.n) __syncthreads();
            }
            par ^= 1;
            Ie = Ie == 0 ? 0 : Ie == mm - 1 ? 1 : Ie + 1;
            Io = Io == 0 ? 0 : Io == mm - 1 ? 1 : Io + 1;
        }
        // the sweep's flags of every CTA, a lane each
        const int mine = lane < ctas ? *(rank_at(flag, lane) + sweeps % 3) : 0;
        ++sweeps;
        converged = !__any_sync(kFull, mine);
    }

    // sigma of the own slots (0 for a dead column), ranks over the cluster
    const int* cur = sb + par * cpc;
    for (int sl = warp; sl < cpc; sl += ppc) {
        const int i = ring_pos(mm, c0 + sl);
        const double* x = X + (size_t)(byidx ? i : cur[sl]) * C;
        double acc = 0.0;
        for (int r = lane; r < C; r += 32) acc += x[r] * x[r];
        acc = warp_sum(acc);
        if (lane == 0) sig[sl] = i < C && acc > dead2 ? sqrt(acc) : 0.0;
    }
    sync_all();
    // ranks (descending, ties by index), S and the right factor: row
    // piv[j] of column r is X[j][i] / sigma; the warp's slots w, w + ppc
    int rk[2] = {-1, -1}, bfk[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int sl = warp + h * ppc;
        const int i = ring_pos(mm, c0 + sl);
        if (!finite0 || i >= C) continue;
        const double sg = sig[sl];
        int r = 0;
        for (int s = lane; s < mm; s += 32) {
            const int J = ring_pos(mm, s);
            if (J >= C) continue;
            const double e = *(rank_at(sig, s / cpc) + s % cpc);
            r += (e > sg) || (e == sg && J < i);
        }
        r = warp_sum_int(r);
        if (lane == 0) g.s[(size_t)b * C + r] = sg;
        const int bf = byidx ? i : cur[sl];
        const double* x = X + (size_t)bf * C;
        for (int j = lane; j < C; j += 32)
            *right_at(g, b, piv[j], r) = sg > 0.0 ? x[j] / sg : 0.0;
        rk[h] = r;
        bfk[h] = bf;
    }
    // The left factor Q [V_J column; 0] of both slots, reflector C - 1
    // first, row `lane + 32 u` in lane `lane`: in registers up to 256 rows,
    // else in place in the output (the same operations in the same order).
    if (finite0 && R <= 32 * kZr) {
        double z[2][kZr];
#pragma unroll
        for (int u = 0; u < kZr; ++u) {
            const int row = lane + 32 * u;
            z[0][u] = rk[0] >= 0 && row < C ? V[(size_t)bfk[0] * C + row] : 0.0;
            z[1][u] = rk[1] >= 0 && row < C ? V[(size_t)bfk[1] * C + row] : 0.0;
        }
        for (int k = C - 1; k >= 0; --k) {
            const double tau = refl[3 * k + 1], scale = refl[3 * k + 2];
            if (tau == 0.0) continue;
            const int pk = piv[k];
            const double* xk = wcol(pk);
            double a0 = 0.0, a1 = 0.0, zero = 0.0, k0 = 0.0, k1 = 0.0;
#pragma unroll
            for (int u = 0; u < kZr; ++u) {
                const int row = lane + 32 * u;
                if (row > k && row < R) {
                    const double x = xk[row];
                    a0 += x * z[0][u];
                    a1 += x * z[1][u];
                }
                if (u == (k >> 5)) {
                    k0 = z[0][u];
                    k1 = z[1][u];
                }
            }
            warp_sum3(a0, a1, zero);
            const double f0 = tau * (__shfl_sync(kFull, k0, k & 31) + scale * a0);
            const double f1 = tau * (__shfl_sync(kFull, k1, k & 31) + scale * a1);
#pragma unroll
            for (int u = 0; u < kZr; ++u) {
                const int row = lane + 32 * u;
                if (row > k && row < R) {
                    const double v = scale * xk[row];
                    z[0][u] -= f0 * v;
                    z[1][u] -= f1 * v;
                } else if (row == k) {
                    z[0][u] -= f0;
                    z[1][u] -= f1;
                }
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int u = 0; u < kZr; ++u) {
                const int row = lane + 32 * u;
                if (rk[h] >= 0 && row < R) *left_at(g, b, row, rk[h]) = z[h][u];
            }
        }
    } else if (finite0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (rk[h] < 0) continue;
            const double* vj = V + (size_t)bfk[h] * C;
            double* z = left_at(g, b, 0, rk[h]);
            const size_t zs = g.trans ? 1 : (size_t)C;
            for (int row = lane; row < R; row += 32)
                z[row * zs] = row < C ? vj[row] : 0.0;
            __syncwarp();
            for (int k = C - 1; k >= 0; --k) {
                const double tau = refl[3 * k + 1], scale = refl[3 * k + 2];
                if (tau == 0.0) continue;
                const int pk = piv[k];
                const double* xk = wcol(pk);
                double acc = 0.0, zero = 0.0, zero2 = 0.0;
                for (int row = lane; row < R; row += 32)
                    if (row > k) acc += xk[row] * z[row * zs];
                warp_sum3(acc, zero, zero2);
                const double f = tau * (z[k * zs] + scale * acc);
                __syncwarp();
                for (int row = lane; row < R; row += 32)
                    if (row > k) z[row * zs] -= f * (scale * xk[row]);
                if (lane == 0) z[k * zs] -= f;
                __syncwarp();
            }
        }
    }
    if (rotations) atomicAdd(&g.health[kRotations], rotations);
    __threadfence();
    sync_all();

    // CTA 0: the zero sigma's completion of the right factor, one warp
    bool finite = finite0;
    if (rank == 0 && warp == 0) {
        int nonzero = 0, bad = 0;
        for (int s = lane; s < mm; s += 32) {
            if (ring_pos(mm, s) >= C) continue;
            const double e = *(rank_at(sig, s / cpc) + s % cpc);
            nonzero += e > 0.0;
            bad |= !isfinite(e);
        }
        nonzero = warp_sum_int(nonzero);
        finite = finite && !__any_sync(kFull, bad);
        double* coef = X;   // X is spent
        int trial = 0;
        for (int k = nonzero; finite && k < C; ++k) {
            bool taken = false;
            while (!taken && trial < C) {
                for (int r = lane; r < C; r += 32)
                    *right_at(g, b, r, k) = r == trial ? 1.0 : 0.0;
                __syncwarp();
                for (int pass = 0; pass < 2; ++pass) {
                    for (int j = 0; j < k; ++j) {
                        double acc = 0.0;
                        for (int r = lane; r < C; r += 32)
                            acc += *right_at(g, b, r, j) * *right_at(g, b, r, k);
                        acc = warp_sum(acc);
                        if (lane == 0) coef[j] = acc;
                    }
                    __syncwarp();
                    for (int r = lane; r < C; r += 32) {
                        double acc = *right_at(g, b, r, k);
                        for (int j = 0; j < k; ++j)
                            acc -= coef[j] * *right_at(g, b, r, j);
                        *right_at(g, b, r, k) = acc;
                    }
                    __syncwarp();
                }
                double n2 = 0.0;
                for (int r = lane; r < C; r += 32) {
                    const double z = *right_at(g, b, r, k);
                    n2 += z * z;
                }
                n2 = warp_sum(n2);
                ++trial;
                if (n2 > 0.5 / C) {
                    const double nrm2 = sqrt(n2);
                    for (int r = lane; r < C; r += 32)
                        *right_at(g, b, r, k) /= nrm2;
                    taken = true;
                }
                __syncwarp();
            }
            if (!taken) {
                finite = false;
                for (int r = lane; r < C; r += 32) *right_at(g, b, r, k) = 0.0;
            }
        }
        if (!finite0) {   // not finite: NaN factors
            const double nan = __longlong_as_double(0x7ff8000000000000LL);
            for (int e = lane; e < R * C; e += 32) *left_at(g, b, e / C, e % C) = nan;
            for (int e = lane; e < C * C; e += 32) *right_at(g, b, e / C, e % C) = nan;
            for (int e = lane; e < C; e += 32) g.s[(size_t)b * C + e] = nan;
        }
        if (lane == 0)
            report(g.status, g.health, b, sweeps, converged, finite, g.cap);
    }
    sync_all();   // no CTA leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// launches

// One launch on `stream` by cudaLaunchKernelEx: `bytes` must cover `need`
// and fit a block; a cluster (`ctas` > 1, or 1 where `cluster`) must be
// schedulable (kUnschedulable otherwise).  Raises the kernel's limits once
// per configuration.
template <typename Args>
int launch(void (*kern)(Args), const Args& a, int grid, int threads,
           int ctas, bool cluster, long long bytes, long long need,
           cudaStream_t stream) {
    if (need > bytes || bytes > kMaxSmem || threads > 1024 || ctas < 1
        || ctas > kMaxCtas || grid % ctas)
        return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = (size_t)bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster ? 1 : 0;
    // configurations checked so far: (kernel, ctas, threads, bytes)
    struct Seen { const void* k; int ctas, threads; long long bytes; };
    static Seen seen[64];
    static int nseen = 0;
    static long long raised[16][2];  // (kernel, bytes) the limit was raised to
    static int nraised = 0;
    bool known = false;
    for (int i = 0; i < nseen && !known; ++i)
        known = seen[i].k == (const void*)kern && seen[i].ctas == ctas
                && seen[i].threads == threads && seen[i].bytes == bytes;
    cudaError_t e;
    if (!known) {
        long long* lim = nullptr;
        for (int i = 0; i < nraised; ++i)
            if (raised[i][0] == (long long)(size_t)kern) lim = raised[i];
        if (lim == nullptr && nraised < 16) {
            lim = raised[nraised++];
            lim[0] = (long long)(size_t)kern;
            lim[1] = 0;
            if (cluster) {
                e = cudaFuncSetAttribute(
                    kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
                if (e != cudaSuccess) return (int)e;
            }
        }
        if (lim == nullptr) return (int)cudaErrorInvalidValue;
        if (bytes > lim[1]) {
            e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
            if (e != cudaSuccess) return (int)e;
            lim[1] = bytes;
        }
        if (cluster) {
            int clusters = 0;
            e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
            if (e != cudaSuccess) return (int)e;
            if (clusters < 1) return kUnschedulable;
        }
        if (nseen < 64) seen[nseen++] = Seen{(const void*)kern, ctas,
                                             threads, bytes};
    }
    e = cudaLaunchKernelEx(&cfg, kern, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// K4 on `batch` contiguous (m, m) float64 matrices on `stream`: w (batch,
// m) ascending, v (batch, m, m) with eigenvector k in column k, status
// (batch,), health (5 u64, accumulated).  `route` 0 (cta: mm = 4, 8, 16,
// 24 or 32 >= m, a CTA of `threads` = 64 (mm 4) or 128 per matrix), 1
// (cluster: a cluster of `ctas` CTAs of `threads` = 256 per matrix, mm a
// multiple of 2 ctas) or 2 (gmem: route cluster with A's and V's columns
// in `work`, batch 2 m m doubles; null otherwise); `smem` bytes of dynamic
// shared memory per CTA.  Allocates nothing, does not synchronize; returns
// the launch's error code (cudaErrorInvalidValue for a plan that does not
// fit the kernel, 1000 for a cluster the card cannot schedule).
extern "C" int xerus_small_eigh(const double* a, double* w, double* v,
                                int* status, u64* health, double* work,
                                int batch, int m, int route, int mm, int ctas,
                                int threads, int cap, double tol, int smem,
                                void* stream) {
    if (batch <= 0 || m <= 0) return 0;
    if (mm < m || (mm & 1) || route < 0 || route > 2
        || (route == 2) != (work != nullptr))
        return (int)cudaErrorInvalidValue;
    EighArgs g{a, w, v, status, health, work, batch, m, mm, ctas, cap, tol};
    auto st = static_cast<cudaStream_t>(stream);
    if (route == 0) {
        if (threads != 32 * cta_warps(mm) || ctas != 1)
            return (int)cudaErrorInvalidValue;
        const long long need = cta_bytes(mm);
        switch (mm) {
            case 4: return launch(small_eigh_cta_kernel<4, 2>, g, batch, threads, 1, false, smem, need, st);
            case 8: return launch(small_eigh_cta_kernel<8, 4>, g, batch, threads, 1, false, smem, need, st);
            case 16: return launch(small_eigh_cta_kernel<16, 4>, g, batch, threads, 1, false, smem, need, st);
            case 24: return launch(small_eigh_cta_kernel<24, 4>, g, batch, threads, 1, false, smem, need, st);
            case 32: return launch(small_eigh_cta_kernel<32, 4>, g, batch, threads, 1, false, smem, need, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (threads != kEighThreads || ctas < 1 || (mm / 2) % ctas)
        return (int)cudaErrorInvalidValue;
    const EighLayout L = eigh_layout(m, mm, ctas, route == 2);
    return route == 2
        ? launch(small_eigh_cluster_kernel<true>, g, batch * ctas, threads,
                 ctas, true, smem, L.bytes, st)
        : launch(small_eigh_cluster_kernel<false>, g, batch * ctas, threads,
                 ctas, true, smem, L.bytes, st);
}

// K5 on `batch` matrices W = A (trans 0) or A^T (trans 1) of R x C
// (C <= R), read at element strides (sb, sr, sc) of W: u (batch, M, C),
// s (batch, C), vh (batch, C, N) with (M, N) = (R, C) or (C, R); status
// and health as K4's.  A cluster of `ctas` CTAs per matrix, `threads` =
// 32 mm / (2 ctas) (a warp per pair; at most 512, 1024 on route gmem), mm
// = C rounded up to a multiple of 2 ctas; `gmem` 1 puts W, X and V_J in
// `work` (batch mm (R + 2 C) doubles; null otherwise).  Return code as
// K4's.
extern "C" int xerus_small_svd(const double* a, long long sb, long long sr,
                               long long sc, double* u, double* s,
                               double* vh, int* status, u64* health,
                               double* work, int batch, int R, int C,
                               int trans, int gmem, int mm, int ctas,
                               int threads, int cap, double tol, double dead,
                               int smem, void* stream) {
    if (batch <= 0 || C <= 0) return 0;
    if (C > R || mm < C || (mm & 1) || mm < 2 || ctas < 1
        || (mm / 2) % ctas || threads != 32 * (mm / 2 / ctas)
        || threads > (gmem ? 1024 : 512) || (gmem != 0) != (work != nullptr))
        return (int)cudaErrorInvalidValue;
    SvdArgs g{a, sb, sr, sc, u, s, vh, status, health, work, batch, R, C,
              trans, mm, ctas, cap, tol, dead};
    const SvdLayout L = svd_layout(R, C, mm, ctas, gmem != 0);
    auto st = static_cast<cudaStream_t>(stream);
    if (gmem)
        return launch(small_svd_kernel<kGlobal>, g, batch * ctas, threads,
                      ctas, true, smem, L.bytes, st);
    return ctas == 1 ? launch(small_svd_kernel<kOneCta>, g, batch, threads,
                              1, true, smem, L.bytes, st)
                     : launch(small_svd_kernel<kRing>, g, batch * ctas,
                              threads, ctas, true, smem, L.bytes, st);
}
