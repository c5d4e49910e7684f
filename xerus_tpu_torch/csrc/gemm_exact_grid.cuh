// K2's grid route: one cooperative persistent launch per truncation, one
// block per SM, every operand in global memory (L2), grid.sync() between
// phases.  It takes the shapes whose state does not fit one cluster's
// shared memory (gemm_exact.cu chooses the route from the shape before
// the launch).
//
// A tiled SIMT FFMA GEMM (32 x 32 output tiles through shared memory,
// tiles dealt to blocks by index, ragged edges masked) runs every
// product.  Every block reads the same reduced scalars after each sync
// and takes the same branch, so loop exits are uniform: a block that left
// a loop alone would deadlock the next grid.sync().  Reductions are
// fixed-order two-stage trees (one partial per block, folded by every
// block in block order; no float atomics), and the grid is the SM count,
// so two launches on one card give bitwise equal outputs.
#pragma once

#include <cooperative_groups.h>

#include "gemm_exact_common.cuh"

namespace gemm_exact {
namespace grid {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // output tile edge
constexpr int kChunk = 32;      // inner-dimension chunk
constexpr int kMaxGrid = 1024;  // partial slots per reduction buffer

template <typename T> struct Smem {
    T a[kTile][kChunk + 1];
    T b[kChunk][kTile + 1];
    T red[kWarps + 1];
};

// Fixed-order block reduction; every thread of the block gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T ident, Smem<T>& sm) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = op(v, __shfl_down_sync(0xffffffffu, v, off));
    __syncthreads();
    if (lane == 0) sm.red[w] = v;
    __syncthreads();
    if (w == 0) {
        T r = lane < kWarps ? sm.red[lane] : ident;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            r = op(r, __shfl_down_sync(0xffffffffu, r, off));
        if (lane == 0) sm.red[kWarps] = r;
    }
    __syncthreads();
    return sm.red[kWarps];
}

template <typename T> struct Params {
    Args<T> a;
    T *G, *Gn, *V, *X1, *X2, *GV, *W, *Y1, *P, *Yb, *part, *colvec;
};

enum Epi { kStore, kStoreMaxAbs, kNsGram, kTau, kCheb };

template <typename T> struct Gemm {
    int m, n, k;
    const T* A; int lda; bool ta;   // op(A)[i][k] = ta ? A[k*lda+i] : A[i*lda+k]
    const T* B; int ldb; bool tb;   // op(B)[k][j] = tb ? B[j*ldb+k] : B[k*ldb+j]
    T* C; int ldc;
    Epi epi;
    int keep;                       // kNsGram: target = diag(j < keep)
    const T* E1; const T* E2;       // kTau: V; kCheb: Y1, V (leading dim ldc)
    T c;                            // kCheb coefficient
};

// C = op(A) op(B) with the epilogue `epi`, tiles dealt to blocks by index.
// Returns this block's partial (max for kStoreMaxAbs/kNsGram, sum for
// kTau, in tile order), the same value in every thread of the block.
template <typename T>
__device__ T gemm(const Gemm<T>& g, Smem<T>& sm) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int tiles_n = (g.n + kTile - 1) / kTile;
    const int tiles = ((g.m + kTile - 1) / kTile) * tiles_n;
    T part = T(0);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int i0 = (t / tiles_n) * kTile, j0 = (t % tiles_n) * kTile;
        T acc[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
        for (int k0 = 0; k0 < g.k; k0 += kChunk) {
            for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
                int r, c;   // r: row of op(A), c: inner index
                if (g.ta) { r = e % kTile; c = e / kTile; }
                else { r = e / kChunk; c = e % kChunk; }
                const int gi = i0 + r, gk = k0 + c;
                T v = T(0);
                if (gi < g.m && gk < g.k)
                    v = g.ta ? g.A[(size_t)gk * g.lda + gi]
                             : g.A[(size_t)gi * g.lda + gk];
                sm.a[r][c] = v;
            }
            for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
                int r, c;   // r: inner index, c: column of op(B)
                if (g.tb) { r = e % kChunk; c = e / kChunk; }
                else { r = e / kTile; c = e % kTile; }
                const int gk = k0 + r, gj = j0 + c;
                T v = T(0);
                if (gk < g.k && gj < g.n)
                    v = g.tb ? g.B[(size_t)gj * g.ldb + gk]
                             : g.B[(size_t)gk * g.ldb + gj];
                sm.b[r][c] = v;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < kChunk; ++kk) {
                const T a0 = sm.a[ty][kk], a1 = sm.a[ty + 16][kk];
                const T b0 = sm.b[kk][tx], b1 = sm.b[kk][tx + 16];
                acc[0][0] = Num<T>::mad(a0, b0, acc[0][0]);
                acc[0][1] = Num<T>::mad(a0, b1, acc[0][1]);
                acc[1][0] = Num<T>::mad(a1, b0, acc[1][0]);
                acc[1][1] = Num<T>::mad(a1, b1, acc[1][1]);
            }
            __syncthreads();
        }
        T tpart = T(0);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * b;
                if (i >= g.m || j >= g.n) continue;
                const T s = acc[a][b];
                const size_t at = (size_t)i * g.ldc + j;
                switch (g.epi) {
                case kStore:
                    g.C[at] = s;
                    break;
                case kStoreMaxAbs:
                    g.C[at] = s;
                    tpart = nmax(tpart, Num<T>::abs(s));
                    break;
                case kNsGram: {
                    const T tgt = (i == j && j < g.keep) ? T(1) : T(0);
                    tpart = nmax(tpart, Num<T>::abs(s - tgt));
                    g.C[at] = (i == j ? T(1.5) : T(0)) - T(0.5) * s;
                    break;
                }
                case kTau:
                    tpart += g.E1[at] * s;
                    break;
                case kCheb:
                    g.C[at] = T(2) * (g.c * s - g.E1[at]) - g.E2[at];
                    break;
                }
            }
        }
        if (g.epi == kTau) {
            part += block_reduce(tpart, SumOp(), T(0), sm);
        } else if (g.epi == kStoreMaxAbs || g.epi == kNsGram) {
            part = nmax(part, block_reduce(tpart, MaxOp(), T(0), sm));
        }
    }
    return part;
}

template <typename T> struct Ctx {
    cg::grid_group grid;
    Smem<T>& sm;
    const Params<T>& p;
    int rnd;        // reduction round: picks one of the two partial buffers
    int ns_total;   // Newton-Schulz iterations, all calls
    int ns_rows;    // of which the row polar's
    int syncs;      // grid barriers

    __device__ void sync() {
        grid.sync();
        ++syncs;
    }

    // publish this block's partial, sync, fold all partials in block order
    template <typename Op>
    __device__ T all_reduce(T blockpart, Op op, T ident) {
        T* buf = p.part + (rnd & 1) * kMaxGrid;
        ++rnd;
        if (threadIdx.x == 0) buf[blockIdx.x] = blockpart;
        sync();
        T v = ident;
        for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
            v = op(v, buf[b]);
        return block_reduce(v, op, ident, sm);
    }

    // fold n values of a vector every block can read, in index order
    template <typename Op>
    __device__ T fold(const T* v, int n, Op op, T ident) {
        T a = ident;
        for (int i = threadIdx.x; i < n; i += kThreads) a = op(a, v[i]);
        return block_reduce(a, op, ident, sm);
    }

    __device__ size_t gtid() const {
        return (size_t)blockIdx.x * kThreads + threadIdx.x;
    }
    __device__ size_t gstride() const { return (size_t)gridDim.x * kThreads; }
};

// Newton-Schulz iteration on X (cols: B x K, X <- X (1.5 I - 0.5 X^T X);
// rows: K x M, Y <- (1.5 I - 0.5 Y Y^T) Y) until max|S - diag(mask)| <=
// 64 eps or max_ns steps.  X starts in `x`; `y` is the other buffer.
// Returns the buffer holding the result; `ok` = err <= tol.
template <typename T>
__device__ T* ns_iterate(Ctx<T>& cx, bool rows, int nr, int nc, T* x, T* y,
                         bool& ok) {
    const Params<T>& p = cx.p;
    const T tol = T(64.0 * Num<T>::eps);
    Gemm<T> gs{};   // the Gram S = X^T X (cols) or Y Y^T (rows) -> P
    gs.m = p.a.K; gs.n = p.a.K; gs.k = rows ? nc : nr;
    gs.C = p.P; gs.ldc = p.a.K; gs.epi = kNsGram; gs.keep = p.a.keep;
    Gemm<T> gu{};   // the update into y
    gu.epi = kStore;
    int it = 0;
    T err;
    for (;;) {
        if (rows) {
            gs.A = x; gs.lda = nc; gs.ta = false;
            gs.B = x; gs.ldb = nc; gs.tb = true;
        } else {
            gs.A = x; gs.lda = nc; gs.ta = true;
            gs.B = x; gs.ldb = nc; gs.tb = false;
        }
        err = cx.all_reduce(gemm(gs, cx.sm), MaxOp(), T(0));
        if (!(err > tol) || it >= p.a.max_ns) break;
        if (rows) {   // y = P x, (K, K) (K, M)
            gu.m = nr; gu.n = nc; gu.k = nr;
            gu.A = p.P; gu.lda = p.a.K; gu.ta = false;
            gu.B = x; gu.ldb = nc; gu.tb = false;
        } else {      // y = x P, (B, K) (K, K)
            gu.m = nr; gu.n = nc; gu.k = nc;
            gu.A = x; gu.lda = nc; gu.ta = false;
            gu.B = p.P; gu.ldb = p.a.K; gu.tb = false;
        }
        gu.C = y; gu.ldc = nc;
        gemm(gu, cx.sm);
        cx.sync();
        T* t = x; x = y; y = t;
        ++it;
    }
    cx.ns_total += it;
    if (rows) cx.ns_rows += it;
    ok = err <= tol;
    return x;
}

// orth(W): column balancing, mask, Frobenius prescale, Newton-Schulz.
// Writes into x / y (B x K); returns the buffer holding Q.
template <typename T>
__device__ T* orth(Ctx<T>& cx, const T* w, T* x, T* y, bool& ok) {
    const Params<T>& p = cx.p;
    const T tiny = T(1e-30);
    const int B = p.a.B, K = p.a.K;
    for (int j = blockIdx.x; j < K; j += gridDim.x) {
        T s = T(0);
        for (int i = threadIdx.x; i < B; i += kThreads) {
            const T v = w[(size_t)i * K + j];
            s += v * v;
        }
        const T nrm = nmax(Num<T>::sqrt(block_reduce(s, SumOp(), T(0), cx.sm)),
                           tiny);
        const T mj = mask_of<T>(j, p.a.keep);
        T q = T(0);
        for (int i = threadIdx.x; i < B; i += kThreads) {
            const T v = (w[(size_t)i * K + j] / nrm) * mj;
            x[(size_t)i * K + j] = v;
            q += v * v;
        }
        q = block_reduce(q, SumOp(), T(0), cx.sm);
        if (threadIdx.x == 0) p.colvec[j] = q;
    }
    cx.sync();
    const T alpha = Num<T>::sqrt(cx.fold(p.colvec, K, SumOp(), T(0))) + tiny;
    for (size_t e = cx.gtid(); e < (size_t)B * K; e += cx.gstride())
        x[e] = x[e] / alpha;
    cx.sync();
    return ns_iterate(cx, false, B, K, x, y, ok);
}

// tau = sum(V * (G V)) without storing G V
template <typename T>
__device__ T tau_of(Ctx<T>& cx, const T* v) {
    const Params<T>& p = cx.p;
    Gemm<T> g{};
    g.m = p.a.B; g.n = p.a.K; g.k = p.a.B;
    g.A = p.G; g.lda = p.a.B; g.ta = false;
    g.B = v; g.ldb = p.a.K; g.tb = false;
    g.C = nullptr; g.ldc = p.a.K; g.epi = kTau; g.E1 = v;
    return cx.all_reduce(gemm(g, cx.sm), SumOp(), T(0));
}

// C (B x K) = Gn @ src
template <typename T>
__device__ void gn_times(Ctx<T>& cx, const T* src, T* dst) {
    const Params<T>& p = cx.p;
    Gemm<T> g{};
    g.m = p.a.B; g.n = p.a.K; g.k = p.a.B;
    g.A = p.Gn; g.lda = p.a.B; g.ta = false;
    g.B = src; g.ldb = p.a.K; g.tb = false;
    g.C = dst; g.ldc = p.a.K; g.epi = kStore;
    gemm(g, cx.sm);
    cx.sync();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
kernel(Params<T> p) {
    __shared__ Smem<T> sm;
    Ctx<T> cx{cg::this_grid(), sm, p, 0, 0, 0, 0};
    const Args<T>& a = p.a;
    const int B = a.B, M = a.M, K = a.K;
    const T tiny = T(1e-30);
    const T eps = T(Num<T>::eps);
    const T stag_tol = T(8.0 * Num<T>::eps);
    const T noise_floor = T(4.0 * Num<T>::eps);
    const T cap_tol = T(16.0 * Num<T>::eps);

    // ---- G = cur cur^T and its scalars ----
    T gmax;
    {
        Gemm<T> g{};
        g.m = B; g.n = B; g.k = M;
        g.A = a.cur; g.lda = M; g.ta = false;
        g.B = a.cur; g.ldb = M; g.tb = true;
        g.C = p.G; g.ldc = B; g.epi = kStoreMaxAbs;
        gmax = cx.all_reduce(gemm(g, sm), MaxOp(), T(0)) + tiny;
    }
    T trG = T(0), live = T(0);
    {
        T s = T(0), c = T(0);
        for (int i = threadIdx.x; i < B; i += kThreads) {
            const T gii = p.G[(size_t)i * B + i];
            s += gii;
            c += gii > T(0) ? T(1) : T(0);
        }
        trG = block_reduce(s, SumOp(), T(0), sm);
        live = block_reduce(c, SumOp(), T(0), sm);
    }
    const T keep_f = nmax(T(a.keep < 0 ? 0 : (a.keep < K ? a.keep : K)), T(1));
    const T gscale = trG + tiny;

    // Gn = G / gscale; start basis W = (G[:, :K] + 1e-3 gmax hash) * mask
    {
        const T hscale = T(1e-3) * gmax;
        for (size_t e = cx.gtid(); e < (size_t)B * B; e += cx.gstride()) {
            p.Gn[e] = p.G[e] / gscale;
            const int i = (int)(e / B), j = (int)(e % B);
            if (j < K)
                p.W[(size_t)i * K + j] = (p.G[e] + hscale * start_hash<T>(i, j))
                                         * mask_of<T>(j, a.keep);
        }
        cx.sync();
    }

    // basis pool: V and two free buffers for orth's ping-pong
    T* V = p.V;
    T* F1 = p.X1;
    T* F2 = p.X2;
    bool ok;
    {
        T* q = orth(cx, p.W, F1, F2, ok);
        T* other = q == F1 ? F2 : F1;
        F1 = V; F2 = other; V = q;
    }
    T tau = tau_of(cx, V);

    // ---- outer loop: power / Chebyshev steps, certificates ----
    const T big = T(Num<T>::big);
    T I_prev = big, I_pprev = big;
    int stall = 0, it = 0;
    while (stall < a.stall_need && it < a.max_outer) {
        const bool power = (it % 2) == 0;
        gn_times(cx, V, p.GV);
        if (power) {
            gn_times(cx, p.GV, p.W);
        } else {
            // column Rayleigh quotients of V (dead columns: +inf)
            for (int j = blockIdx.x; j < K; j += gridDim.x) {
                T s = T(0);
                for (int i = threadIdx.x; i < B; i += kThreads) {
                    const size_t at = (size_t)i * K + j;
                    s += V[at] * p.GV[at];
                }
                s = block_reduce(s, SumOp(), T(0), sm) * gscale;
                if (threadIdx.x == 0)
                    p.colvec[j] = j < a.keep ? s : Num<T>::inf();
            }
            cx.sync();
            const T rmin = cx.fold(p.colvec, K, MinOp(), Num<T>::inf());
            const T resid = nmax(trG - tau, T(0));
            const T b_floor = T(0.5) * resid / nmax(live - keep_f, T(1))
                              + eps * trG + tiny;
            const T b = nmax(T(0.9) * rmin, b_floor);
            const T c = T(2) * gscale / b;
            for (size_t e = cx.gtid(); e < (size_t)B * K; e += cx.gstride())
                p.Y1[e] = c * p.GV[e] - V[e];
            cx.sync();
            Gemm<T> g{};
            g.m = B; g.n = K; g.k = B;
            g.A = p.Gn; g.lda = B; g.ta = false;
            g.B = p.Y1; g.ldb = K; g.tb = false;
            g.C = p.W; g.ldc = K; g.epi = kCheb;
            g.E1 = p.Y1; g.E2 = V; g.c = c;
            gemm(g, sm);
            cx.sync();
        }
        T* q = orth(cx, p.W, F1, F2, ok);
        T tau2 = tau_of(cx, q);
        const bool better = tau2 >= tau;
        if (better) {
            T* other = q == F1 ? F2 : F1;
            F1 = V; F2 = other; V = q;
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
        gn_times(cx, V, p.GV);
        gn_times(cx, p.GV, p.W);
        bool ok2;
        T* q = orth(cx, p.W, F1, F2, ok2);
        const T tau2 = tau_of(cx, q);
        if (ok2 && tau2 >= tau * (T(1) - stag_tol)) {
            T* other = q == F1 ? F2 : F1;
            F1 = V; F2 = other; V = q;
            tau = tau2;
        }
    }

    // ---- vt_raw = V^T cur, row balancing, Newton-Schulz row polar ----
    {
        Gemm<T> g{};
        g.m = K; g.n = M; g.k = B;
        g.A = V; g.lda = K; g.ta = true;
        g.B = a.cur; g.ldb = M; g.tb = false;
        g.C = p.Yb; g.ldc = M; g.epi = kStore;
        gemm(g, sm);
        cx.sync();
    }
    for (int i = blockIdx.x; i < K; i += gridDim.x) {
        const T* row = p.Yb + (size_t)i * M;
        T s = T(0);
        for (int j = threadIdx.x; j < M; j += kThreads) s += row[j] * row[j];
        const T rn = nmax(Num<T>::sqrt(block_reduce(s, SumOp(), T(0), sm)),
                          tiny);
        T q = T(0);
        for (int j = threadIdx.x; j < M; j += kThreads) {
            const T v = row[j] / rn;
            a.vt_bal[(size_t)i * M + j] = v;
            q += v * v;
        }
        q = block_reduce(q, SumOp(), T(0), sm);
        if (threadIdx.x == 0) p.colvec[i] = q;
    }
    cx.sync();
    const T alpha = Num<T>::sqrt(cx.fold(p.colvec, K, SumOp(), T(0))) + tiny;
    for (size_t e = cx.gtid(); e < (size_t)K * M; e += cx.gstride())
        a.vt0[e] = a.vt_bal[e] / alpha;
    cx.sync();
    bool okp;
    const T* y = ns_iterate(cx, true, K, M, a.vt0, p.Yb, okp);
    if (y != a.vt0) {
        for (size_t e = cx.gtid(); e < (size_t)K * M; e += cx.gstride())
            a.vt0[e] = y[e];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        a.flags[kOkp] = okp ? 1 : 0;
        a.flags[kConverged] = converged ? 1 : 0;
        a.flags[kOuter] = it;
        a.flags[kNs] = cx.ns_total;
        a.flags[kBarriers] = cx.syncs;
        a.flags[kClusterCtas] = 0;
        a.flags[kNsRows] = cx.ns_rows;
    }
}

// workspace layout (elements), each buffer aligned to 64 elements
struct Layout {
    size_t G, Gn, V, X1, X2, GV, W, Y1, P, Yb, part, colvec, total;
};

inline size_t up64(size_t n) { return (n + 63) / 64 * 64; }

inline Layout layout(int B, int M, int K) {
    Layout l;
    size_t o = 0;
    const size_t bb = (size_t)B * B, bk = (size_t)B * K;
    l.G = o; o += up64(bb);
    l.Gn = o; o += up64(bb);
    l.V = o; o += up64(bk);
    l.X1 = o; o += up64(bk);
    l.X2 = o; o += up64(bk);
    l.GV = o; o += up64(bk);
    l.W = o; o += up64(bk);
    l.Y1 = o; o += up64(bk);
    l.P = o; o += up64((size_t)K * K);
    l.Yb = o; o += up64((size_t)K * M);
    l.part = o; o += up64(2 * (size_t)kMaxGrid);
    l.colvec = o; o += up64((size_t)(B > K ? B : K));
    l.total = o;
    return l;
}

template <typename T>
int launch(const Args<T>& a, void* ws, cudaStream_t stream) {
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel<T>,
                                                      kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    const int grid = sms < kMaxGrid ? sms : kMaxGrid;

    const Layout l = layout(a.B, a.M, a.K);
    T* w = static_cast<T*>(ws);
    Params<T> p;
    p.a = a;
    p.G = w + l.G; p.Gn = w + l.Gn; p.V = w + l.V; p.X1 = w + l.X1;
    p.X2 = w + l.X2; p.GV = w + l.GV; p.W = w + l.W; p.Y1 = w + l.Y1;
    p.P = w + l.P; p.Yb = w + l.Yb; p.part = w + l.part;
    p.colvec = w + l.colvec;
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel((const void*)kernel<T>, dim3(grid),
                                    dim3(kThreads), args, 0, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace grid
}  // namespace gemm_exact
