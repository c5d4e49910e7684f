// K4 and K5: the small dense eigen- and singular-value problems of the
// two-site DMRG sweeps by Jacobi rotations, float64, one launch per batch
// and no host read.
//
// - K4, small_eigh: the (B, m, m) symmetric Ritz problems of the Lanczos
//   and LOBPCG local solves (xerus_tpu_torch/ops/dmrg_kernels.py
//   _ritz_smallest; m = 24 for Lanczos, 3 for LOBPCG).  Ascending
//   eigenvalues (B, m) and orthonormal eigenvectors (B, m, m), eigenvector
//   k in column k.  Like torch.linalg.eigh, only the lower triangle is
//   read.
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
// - Pairs in parallel (round-robin) order: the indices padded to an even
//   count mm, round k of mm - 1 pairs slot 0 with the rotating slots
//   1 + (k + j - 1) mod (mm - 1); slot i meets slot mm - 1 - i, so each
//   round's mm / 2 rotations touch disjoint indices and run at once.  A
//   sweep is mm - 1 rounds; a sweep with no rotation ends the iteration.
// - The rotation annihilating g in [[a, g], [g, b]]: tau = (b - a) / 2g,
//   t = sign(tau) / (|tau| + sqrt(1 + tau^2)) (1 / 2|tau| past 1e150),
//   c = 1 / sqrt(1 + t^2), s = t c; the new diagonal a - t g, b + t g.
// - K4, cyclic two-sided Jacobi: a pair rotates where
//   |a_pq| > tol sqrt|a_pp| sqrt|a_qq| (relative, tol = m eps): the Ritz
//   matrices carry invalid directions lifted by 1e4 (max|T| + 1), and an
//   absolute test against that norm would leave the small block
//   unresolved.  A round applies J^T A J (rows, then columns, then the
//   2 x 2 blocks set to their new diagonal and 0) and V <- V J.  Entries
//   outside the 2 x 2 blocks mix only off-diagonal entries, so rounding
//   stays relative to the shrinking off-diagonal part and the relative
//   test is reachable.
// - K5, one-sided (Hestenes) Jacobi on the columns of W = A (M >= N) or
//   W = A^T (M < N), R x C with C <= R, accumulating V: a pair of columns
//   rotates where both are alive (||w||^2 > (dead ||A||_F)^2, dead = R eps)
//   and |w_p . w_q| > tol ||w_p|| ||w_q|| (tol = R eps).  Afterwards
//   sigma_j = ||w_j|| (0 for a dead column), sorted descending (ties by
//   index), Q = W V / sigma for the nonzero sigma, and for each zero one an
//   orthonormal completion: the first canonical vector e_i (i ascending
//   from the last one taken) whose part orthogonal to the columns before
//   it, projected out twice, keeps a squared norm above 1 / 2R; normalized.
//   Q is U (and V gives Vh) for M >= N, Vh^T (and V gives U) otherwise.
//
// What bounds them: latency.  A sweep is mm - 1 dependent rounds, each a
// few dot products of at most R terms per pair and a barrier; the work
// (about 12 m^3 flops per K4 sweep, 6 R C^2 + 3 C^3 per K5 sweep) is far
// below the card's FP64 rate for the time the chain of rounds takes.  The
// design keeps the operands on chip where they fit and pays a barrier per
// dependent step:
//
// - one CTA per matrix (the batch is the grid);
// - K4: a thread per pair sets up its rotation, then threads over the
//   (pair, column) and (row, pair) entries apply it: three barriers a
//   round;
// - K5: a warp per pair (warps stride over the round's pairs) reduces
//   ||w_p||^2, ||w_q||^2 and w_p . w_q with an xor-butterfly (every lane
//   gets the same bits) and rotates both columns of W and V; one barrier a
//   round.  W and V are column-major, so a warp reads a column in
//   consecutive addresses;
// - route smem: A and V (K4) or W and V (K5) in shared memory; route gmem,
//   where they do not fit (the (128, 128) split at rank 64 needs 256 KB):
//   the same code on a per-CTA slice of a global workspace (L1/L2
//   resident), only the small vectors in shared memory.  The two routes
//   run the same steps in the same order, so their results are bitwise
//   equal.
//
// Every reduction runs in a fixed order, so two launches on the same input
// are bitwise equal.  The plain versions sum in torch's order, so the two
// agree to rounding, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;   // 227 KB, the largest a block can use
constexpr double kBigTau = 1e150;  // past it, t = 1 / 2|tau| (tau^2 overflows)
enum Health { kFailures, kMaxSweeps, kTotalSweeps, kMatrices, kRotations };
typedef unsigned long long u64;

// Shared-memory layouts in bytes; xerus_tpu_torch/ops/small_eig.py
// (eigh_plan, svd_plan) sizes the launch and the launch checks that its
// size covers the layout.
//   K4: doubles pc, ps, pdp, pdq (mm / 2 each), then on route smem A and V
//       (m m each); ints pp, pq, prot (mm / 2 each), flag, rank (mm).
//   K5: doubles red (kWarps + 1), sig, coef (C each), z (R), then on route
//       smem W (R C) and V (C C); ints flag, perm (C).
__host__ __device__ inline long long eigh_bytes(int m, bool gmem) {
    const long long mm = m + (m & 1), np = mm / 2;
    return 8 * (4 * np + (gmem ? 0 : 2LL * m * m)) + 4 * (3 * np + 1 + mm);
}

__host__ __device__ inline long long svd_bytes(int R, int C, bool gmem) {
    return 8 * (kWarps + 1 + 2LL * C + R
                + (gmem ? 0 : (long long)R * C + (long long)C * C))
           + 4 * (1LL + C);
}

// slot j of round k of the round-robin over mm (even) indices
__device__ __forceinline__ int rr_slot(int mm, int k, int j) {
    return j == 0 ? 0 : 1 + (k + j - 1) % (mm - 1);
}

__device__ __forceinline__ void rr_pair(int mm, int k, int i, int& p,
                                        int& q) {
    const int a = rr_slot(mm, k, i), b = rr_slot(mm, k, mm - 1 - i);
    p = a < b ? a : b;
    q = a < b ? b : a;
}

__device__ __forceinline__ void rotation(double a, double b, double g,
                                         double& c, double& s, double& t) {
    const double tau = (b - a) / (2.0 * g);
    const double at = fabs(tau);
    const double tt = at > kBigTau ? 0.5 / at
                                   : 1.0 / (at + sqrt(1.0 + tau * tau));
    t = tau < 0.0 ? -tt : tt;
    c = 1.0 / sqrt(1.0 + t * t);
    s = t * c;
}

// sum over the warp, the same bits in every lane (addition commutes)
__device__ __forceinline__ double warp_sum(double v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
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

// ---------------------------------------------------------------------------
// K4

struct EighArgs {
    const double* a;   // (B, m, m) contiguous
    double* w;         // (B, m)
    double* v;         // (B, m, m)
    int* status;       // (B,)
    u64* health;       // 5
    double* work;      // route gmem: (B, 2 m m); else unused
    int m, gmem, cap;
    double tol;
};

__global__ void __launch_bounds__(kThreads) small_eigh_kernel(EighArgs g) {
    extern __shared__ double smem[];
    const int m = g.m, mm = m + (m & 1), np = mm / 2;
    const int tid = threadIdx.x, b = blockIdx.x;
    double* pc = smem;
    double* ps = pc + np;
    double* pdp = ps + np;
    double* pdq = pdp + np;
    double* A = g.gmem ? g.work + (size_t)b * 2 * m * m : pdq + np;
    double* V = A + (size_t)m * m;
    int* pp = reinterpret_cast<int*>(g.gmem ? pdq + np : V + (size_t)m * m);
    int* pq = pp + np;
    int* prot = pq + np;
    int* flag = prot + np;
    int* rank = flag + 1;
    const double* a = g.a + (size_t)b * m * m;

    if (tid == 0) *flag = 0;
    __syncthreads();
    for (int e = tid; e < m * m; e += kThreads) {
        const int i = e / m, j = e % m;
        const double x = i >= j ? a[e] : a[j * m + i];
        if (!isfinite(x)) *flag = 1;
        A[e] = x;
        V[e] = i == j ? 1.0 : 0.0;
    }
    __syncthreads();
    bool finite = *flag == 0;
    __syncthreads();

    int sweeps = 0;
    u64 rotations = 0;   // this thread's
    bool converged = false;
    while (finite && sweeps < g.cap && !converged) {
        if (tid == 0) *flag = 0;
        __syncthreads();
        for (int k = 0; k < mm - 1; ++k) {
            for (int i = tid; i < np; i += kThreads) {
                int p, q;
                rr_pair(mm, k, i, p, q);
                pp[i] = p;
                pq[i] = q;
                int rot = 0;
                if (q < m) {
                    const double app = A[p * m + p], aqq = A[q * m + q];
                    const double apq = A[p * m + q];
                    if (apq != 0.0 && fabs(apq) > g.tol * sqrt(fabs(app))
                                                      * sqrt(fabs(aqq))) {
                        double c, s, t;
                        rotation(app, aqq, apq, c, s, t);
                        pc[i] = c;
                        ps[i] = s;
                        pdp[i] = app - t * apq;
                        pdq[i] = aqq + t * apq;
                        rot = 1;
                        ++rotations;
                        *flag = 1;
                    }
                }
                prot[i] = rot;
            }
            __syncthreads();
            // rows p and q: A <- J^T A
            for (int e = tid; e < np * m; e += kThreads) {
                const int i = e / m, j = e % m;
                if (!prot[i]) continue;
                const int p = pp[i], q = pq[i];
                const double c = pc[i], s = ps[i];
                const double x = A[p * m + j], y = A[q * m + j];
                A[p * m + j] = c * x - s * y;
                A[q * m + j] = s * x + c * y;
            }
            __syncthreads();
            // columns p and q: A <- A J (the 2 x 2 block set to its new
            // diagonal and 0), V <- V J
            for (int e = tid; e < m * np; e += kThreads) {
                const int r = e / np, i = e % np;
                if (!prot[i]) continue;
                const int p = pp[i], q = pq[i];
                const double c = pc[i], s = ps[i];
                if (r == p) {
                    A[p * m + p] = pdp[i];
                    A[p * m + q] = 0.0;
                } else if (r == q) {
                    A[q * m + p] = 0.0;
                    A[q * m + q] = pdq[i];
                } else {
                    const double x = A[r * m + p], y = A[r * m + q];
                    A[r * m + p] = c * x - s * y;
                    A[r * m + q] = s * x + c * y;
                }
                const double x = V[r * m + p], y = V[r * m + q];
                V[r * m + p] = c * x - s * y;
                V[r * m + q] = s * x + c * y;
            }
            __syncthreads();
        }
        ++sweeps;
        converged = *flag == 0;
        __syncthreads();
    }

    // ascending eigenvalues, ties by index
    if (tid == 0) *flag = 0;
    __syncthreads();
    for (int i = tid; i < m; i += kThreads) {
        const double wi = A[i * m + i];
        if (!isfinite(wi)) *flag = 1;
        int r = 0;
        for (int j = 0; j < m; ++j) {
            const double wj = A[j * m + j];
            r += (wj < wi) || (wj == wi && j < i);
        }
        rank[i] = r;
    }
    __syncthreads();
    finite = finite && *flag == 0;
    for (int i = tid; i < m; i += kThreads)
        g.w[(size_t)b * m + rank[i]] = A[i * m + i];
    for (int e = tid; e < m * m; e += kThreads) {
        const int r = e / m, i = e % m;
        g.v[(size_t)b * m * m + (size_t)r * m + rank[i]] = V[r * m + i];
    }
    if (rotations) atomicAdd(&g.health[kRotations], rotations);
    if (tid == 0)
        report(g.status, g.health, b, sweeps, converged, finite, g.cap);
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
    double* work;               // route gmem: (B, R C + C C); else unused
    int R, C, trans, gmem, cap;
    double tol, dead;
};

// element (r, k) of the output Q (R x C: U, or Vh^T where trans) and of
// the output V factor (C x C: Vh^T, or U where trans) of matrix b
__device__ __forceinline__ double* q_at(const SvdArgs& g, int b, int r,
                                        int k) {
    const size_t base = (size_t)b * g.R * g.C;
    return g.trans ? g.vh + base + (size_t)k * g.R + r
                   : g.u + base + (size_t)r * g.C + k;
}

__device__ __forceinline__ double* v_at(const SvdArgs& g, int b, int r,
                                        int k) {
    const size_t base = (size_t)b * g.C * g.C;
    return g.trans ? g.u + base + (size_t)r * g.C + k
                   : g.vh + base + (size_t)k * g.C + r;
}

__global__ void __launch_bounds__(kThreads) small_svd_kernel(SvdArgs g) {
    extern __shared__ double smem[];
    const int R = g.R, C = g.C, cc = C + (C & 1);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x;
    double* red = smem;                  // kWarps partials, then ||A||_F^2
    double* sig = red + kWarps + 1;
    double* coef = sig + C;
    double* z = coef + C;
    double* W = g.gmem ? g.work + (size_t)b * ((size_t)R * C + (size_t)C * C)
                       : z + R;
    double* V = W + (size_t)R * C;
    int* flag = reinterpret_cast<int*>(g.gmem ? z + R : V + (size_t)C * C);
    int* perm = flag + 1;
    const double* a = g.a + b * g.sb;

    for (int e = tid; e < R * C; e += kThreads) {
        const int c = e / R, r = e % R;
        W[e] = a[r * g.sr + c * g.sc];
    }
    for (int e = tid; e < C * C; e += kThreads)
        V[e] = e / C == e % C ? 1.0 : 0.0;
    __syncthreads();
    // column norms squared, then ||A||_F^2 in column order
    for (int c = warp; c < C; c += kWarps) {
        double acc = 0.0;
        for (int r = lane; r < R; r += 32) acc += W[c * R + r] * W[c * R + r];
        acc = warp_sum(acc);
        if (lane == 0) sig[c] = acc;
    }
    __syncthreads();
    if (tid == 0) {
        double f2 = 0.0;
        for (int c = 0; c < C; ++c) f2 += sig[c];
        red[kWarps] = f2;
    }
    __syncthreads();
    const double f2 = red[kWarps];
    const double dead2 = g.dead * g.dead * f2;
    bool finite = isfinite(f2);

    int sweeps = 0;
    u64 rotations = 0;   // this warp's, in lane 0
    bool converged = false;
    while (finite && sweeps < g.cap && !converged) {
        if (tid == 0) *flag = 0;
        __syncthreads();
        for (int k = 0; k < cc - 1; ++k) {
            for (int i = warp; i < cc / 2; i += kWarps) {
                int p, q;
                rr_pair(cc, k, i, p, q);
                if (q >= C) continue;
                double* wp = W + (size_t)p * R;
                double* wq = W + (size_t)q * R;
                double al = 0.0, be = 0.0, ga = 0.0;
                for (int r = lane; r < R; r += 32) {
                    const double x = wp[r], y = wq[r];
                    al += x * x;
                    be += y * y;
                    ga += x * y;
                }
                al = warp_sum(al);
                be = warp_sum(be);
                ga = warp_sum(ga);
                if (al > dead2 && be > dead2 && ga != 0.0
                    && fabs(ga) > g.tol * sqrt(al) * sqrt(be)) {
                    double c, s, t;
                    rotation(al, be, ga, c, s, t);
                    for (int r = lane; r < R; r += 32) {
                        const double x = wp[r], y = wq[r];
                        wp[r] = c * x - s * y;
                        wq[r] = s * x + c * y;
                    }
                    double* vp = V + (size_t)p * C;
                    double* vq = V + (size_t)q * C;
                    for (int r = lane; r < C; r += 32) {
                        const double x = vp[r], y = vq[r];
                        vp[r] = c * x - s * y;
                        vq[r] = s * x + c * y;
                    }
                    if (lane == 0) {
                        ++rotations;
                        *flag = 1;
                    }
                }
            }
            __syncthreads();
        }
        ++sweeps;
        converged = *flag == 0;
        __syncthreads();
    }

    // sigma (0 for a dead column), descending, ties by index
    for (int c = warp; c < C; c += kWarps) {
        double acc = 0.0;
        for (int r = lane; r < R; r += 32) acc += W[c * R + r] * W[c * R + r];
        acc = warp_sum(acc);
        if (lane == 0) sig[c] = acc > dead2 ? sqrt(acc) : 0.0;
    }
    if (tid == 0) *flag = 0;
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
        const double sc = sig[c];
        if (!isfinite(sc)) *flag = 1;
        int r = 0;
        for (int j = 0; j < C; ++j)
            r += (sig[j] > sc) || (sig[j] == sc && j < c);
        perm[r] = c;
    }
    __syncthreads();
    finite = finite && *flag == 0;
    for (int k = tid; k < C; k += kThreads)
        g.s[(size_t)b * C + k] = sig[perm[k]];
    for (int e = tid; e < C * C; e += kThreads) {
        const int k = e / C, r = e % C;
        *v_at(g, b, r, k) = V[(size_t)perm[k] * C + r];
    }
    int nonzero = 0;
    for (int k = 0; k < C; ++k) nonzero += sig[perm[k]] > 0.0;
    for (int e = tid; e < R * nonzero; e += kThreads) {
        const int k = e / R, r = e % R;
        const int c = perm[k];
        *q_at(g, b, r, k) = W[(size_t)c * R + r] / sig[c];
    }
    __syncthreads();

    // orthonormal completion of Q for the zero sigma
    int trial = 0;
    for (int k = nonzero; k < C; ++k) {
        bool taken = false;
        while (!taken && trial < R) {
            for (int r = tid; r < R; r += kThreads)
                z[r] = r == trial ? 1.0 : 0.0;
            __syncthreads();
            for (int pass = 0; pass < 2; ++pass) {
                for (int j = warp; j < k; j += kWarps) {
                    double acc = 0.0;
                    for (int r = lane; r < R; r += 32)
                        acc += *q_at(g, b, r, j) * z[r];
                    acc = warp_sum(acc);
                    if (lane == 0) coef[j] = acc;
                }
                __syncthreads();
                for (int r = tid; r < R; r += kThreads) {
                    double acc = z[r];
                    for (int j = 0; j < k; ++j)
                        acc -= coef[j] * *q_at(g, b, r, j);
                    z[r] = acc;
                }
                __syncthreads();
            }
            double acc = 0.0;
            for (int r = tid; r < R; r += kThreads) acc += z[r] * z[r];
            acc = warp_sum(acc);
            if (lane == 0) red[warp] = acc;
            __syncthreads();
            double n2 = 0.0;
            for (int w = 0; w < kWarps; ++w) n2 += red[w];
            ++trial;
            if (n2 > 0.5 / R) {
                const double nrm = sqrt(n2);
                for (int r = tid; r < R; r += kThreads)
                    *q_at(g, b, r, k) = z[r] / nrm;
                taken = true;
            }
            __syncthreads();
        }
        if (!taken) {
            finite = false;
            for (int r = tid; r < R; r += kThreads) *q_at(g, b, r, k) = 0.0;
        }
    }
    if (rotations) atomicAdd(&g.health[kRotations], rotations);
    if (tid == 0)
        report(g.status, g.health, b, sweeps, converged, finite, g.cap);
}

// the launch's dynamic shared memory: `bytes` must cover `need` and fit a
// block; raises the kernel's limit past 48 KB once per size
template <typename Kern>
int set_smem(Kern kern, long long bytes, long long need, long long& checked) {
    if (need > bytes || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
    if (bytes > checked) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
        checked = bytes;
    }
    return 0;
}

}  // namespace

// K4 on `batch` contiguous (m, m) float64 matrices on `stream`: w (batch,
// m) ascending, v (batch, m, m) with eigenvector k in column k, status
// (batch,), health (5 u64, accumulated); route smem (gmem 0) or gmem
// (work: batch 2 m m doubles), `smem` bytes of dynamic shared memory.
// Allocates nothing, does not synchronize; returns the launch's error code
// (cudaErrorInvalidValue for a size that does not cover the layout).
extern "C" int xerus_small_eigh(const double* a, double* w, double* v,
                                int* status, u64* health, double* work,
                                int batch, int m, int gmem, int cap,
                                double tol, int smem, void* stream) {
    if (batch <= 0 || m <= 0) return 0;
    if (gmem && work == nullptr) return (int)cudaErrorInvalidValue;
    static long long checked = 0;
    int rc = set_smem(small_eigh_kernel, smem, eigh_bytes(m, gmem != 0),
                      checked);
    if (rc != 0) return rc;
    EighArgs g{a, w, v, status, health, work, m, gmem, cap, tol};
    small_eigh_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(g);
    return (int)cudaGetLastError();
}

// K5 on `batch` matrices W = A (trans 0) or A^T (trans 1) of R x C
// (C <= R), read at element strides (sb, sr, sc) of W: u (batch, M, C),
// s (batch, C), vh (batch, C, N) with (M, N) = (R, C) or (C, R); status,
// health, routes and return code as K4's (work: batch (R C + C C)
// doubles).
extern "C" int xerus_small_svd(const double* a, long long sb, long long sr,
                               long long sc, double* u, double* s,
                               double* vh, int* status, u64* health,
                               double* work, int batch, int R, int C,
                               int trans, int gmem, int cap, double tol,
                               double dead, int smem, void* stream) {
    if (batch <= 0 || C <= 0) return 0;
    if (C > R || (gmem && work == nullptr)) return (int)cudaErrorInvalidValue;
    static long long checked = 0;
    int rc = set_smem(small_svd_kernel, smem, svd_bytes(R, C, gmem != 0),
                      checked);
    if (rc != 0) return rc;
    SvdArgs g{a, sb, sr, sc, u, s, vh, status, health, work,
              R, C, trans, gmem, cap, tol, dead};
    small_svd_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(g);
    return (int)cudaGetLastError();
}
