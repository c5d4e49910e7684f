// K2's grid route: one cooperative persistent launch per truncation, one
// CTA per SM, the state in global memory (L2), for the shapes whose state
// does not fit one cluster's shared memory (gemm_exact.cu chooses the
// route from the shape before the launch): the rank-512 -> 256 rounding's
// bonds at (512, 512) keep 256 and the rank-1024 -> 512 rounding's at
// (1024, 1024) keep 512, the shapes the TPU kernel it replaces,
// xerus_tpu/ops/tt_kernels.py:1232 _gemm_exact_pallas_call, ran (its
// gate, _gemm_exact_pallas_ok, admits B*M*4 and B*B*4 up to 4 MB).  It
// computes what _gemm_exact_body computes, with the cluster route's
// steps, certificates and flags (gemm_exact.cu's header).
//
// Bound at (512, 512) keep 256, float32: operations.  A Newton-Schulz
// step is the (256, 256, 512) Gram, of which only the half on and above
// the diagonal is needed, and the (512, 256, 256) update: 0.101 GFLOP,
// 1.5 us at the H100's 67 TFLOP/s of FP32 FFMA; the rank-512 rounding's
// middle bond runs 19 outer and 673 Newton-Schulz steps, 79.2 GFLOP by
// gemm_exact_flops, 1.18 ms.  Inputs and outputs (3 MB)
// take 1 us at 3.35 TB/s.  What bounds it in fact is latency: every step
// is two dependent products, each small for 132 SMs, with a decision
// between them that every CTA must read.  Measured there (NVIDIA H100
// 80GB HBM3, 700 W; the stamps below, CTA 0's clock): 38% of the time
// waiting at grid barriers, 27% in the products' k loops, 11% filling the
// first staged slice of a tile, 11% in the tiles' folds and epilogues.
//
// The design:
//   * Barriers: two grid barriers a Newton-Schulz step, one after the Gram
//     and one after the update, and nothing else.  The Gram's epilogue
//     builds P = 1.5 I - 0.5 S and each tile's max |S - diag(mask)| where
//     the tile is finished; after the barrier every CTA folds the tiles'
//     maxima (one value a tile, in tile order) and takes the same branch.
//     A reduction never costs a barrier of its own: it rides the barrier
//     that publishes its product.
//   * Products: every product is 32 x 32 output tiles over k slices of 64,
//     staged global -> shared by cp.async in a ring of three slices, so
//     the loads of slice s + 2 fly while slice s is computed.  A CTA's 256
//     threads are four groups of 64, each a quarter of every slice; the
//     four quarters are folded in order.  float32: each thread a 4 x 4
//     register block of FFMA (two 16-byte shared loads a k step for 16
//     FFMA); float64: each warp sixteen rows as four m16n8k4 tiles on the
//     FP64 tensor cores (mma.sync), as the cluster route's f64 design.
//     Operands stay in their global orientation in shared memory
//     (k-contiguous rows padded to 68, else rows of 32): no transposes.
//     The shared memory is addressed through a named array (grid_smem):
//     a pointer carried through a struct compiled to generic loads.
//   * Idle SMs: the symmetric products (G, both Newton-Schulz Grams) run
//     only the tiles on and above the diagonal and store each tile and its
//     mirror.  A product with fewer tiles than CTAs splits k (split_of,
//     planned on the host once a launch: the Gram at K = 256 is 36 tiles
//     x 3 slices of k = 108 CTAs busy); the CTA that takes a tile's last
//     ticket (an integer atomic, no float atomics) folds the slices'
//     partials in slice order and runs the epilogue.
//   * Every dimension is padded to a multiple of 64 in the workspace
//     (zero rows and columns, which stay zero), so no load is masked and
//     every row is 16-byte aligned.
//
// Determinism: every sum runs in one order fixed by the shape and the
// grid (the SM count): a tile's k slices in order, the groups in order,
// split partials in order, tile maxima and tau's tile sums in tile order.
// Whichever CTA finishes a tile last, the fold is the same, so two
// launches on one card give bitwise equal outputs.  Every CTA reads the
// same folded scalars after each barrier and takes the same branch, so
// loop exits are uniform.  Products keep full FP32 (FFMA) or FP64 (DMMA)
// arithmetic: no TF32.  Data that another CTA wrote is read through L2
// only (cp.async.cg, __ldcg).
#pragma once

#include <cooperative_groups.h>
#include <type_traits>

#include "gemm_exact_common.cuh"

namespace gemm_exact {
namespace grid {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // output tile edge
constexpr int kGroups = 4;                 // k quarters, 64 threads each
constexpr int kStageK = 64;                // k depth of one staged slice
constexpr int kStages = 3;                 // cp.async ring
constexpr int kLdK = kStageK + 4;          // k-contiguous operand rows
constexpr int kLdT = kTile + 1;            // folded tile rows
constexpr int kStageElems = 2 * kTile * kLdK;
constexpr int kSmTile = kStages * kStageElems;
constexpr int kSmRed = kSmTile + kTile * kLdT;
constexpr int kSmElems = kSmRed + 16;
constexpr int kMaxGrid = 1024;
constexpr int kMaxItems = 1024;            // split-K partial tiles
constexpr int kMaxSplit = 16;
constexpr int kPad = 64;                   // every dimension's multiple

static_assert(kGroups * kTile * kLdT <= kSmTile, "fold inside the ring");

// The launch's dynamic shared memory (kSmElems elements): the cp.async
// ring, the folded tile, the reduction scratch.  Named here, so that every
// access compiles to shared-memory loads and stores (LDS); a pointer
// carried through Ctx into a called function compiles to generic ones.
extern __shared__ __align__(16) unsigned char grid_smem[];
template <typename T> __device__ __forceinline__ T* smem() {
    return reinterpret_cast<T*>(grid_smem);
}

inline int pad(int n) {
    return (n + kPad - 1) / kPad * kPad;
}

// CTAs of the launch on a card with `sms` SMs
inline int ctas(int sms) {
    return sms < kMaxGrid ? sms : kMaxGrid;
}

// k slices a product with `tiles` output tiles and `units` slices of k
// splits into on `grid` CTAs: the least rounds x (slices + 1) of a CTA,
// in quarters, plus the fold's cost, split partials within kMaxItems.
// The host plans each product once a launch (its 64-bit divisions cost a
// CTA microseconds).
inline int split_of(int tiles, int units, int grid) {
    int best = 1;
    long best_cost = -1;
    const int smax = units < kMaxSplit ? units : kMaxSplit;
    for (int s = 1; s <= smax; ++s) {
        if (s > 1 && (long)tiles * s > kMaxItems) break;
        const long rounds = ((long)tiles * s + grid - 1) / grid;
        const long cost = 4 * rounds * ((units + s - 1) / s + 1) + s;
        if (best_cost < 0 || cost < best_cost) {
            best = s;
            best_cost = cost;
        }
    }
    return best;
}

// Fixed-order block reduction; every thread of the block gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T ident, T* red) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = op(v, __shfl_down_sync(0xffffffffu, v, off));
    __syncthreads();
    if (lane == 0) red[w] = v;
    __syncthreads();
    if (w == 0) {
        T r = lane < kWarps ? red[lane] : ident;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            r = op(r, __shfl_down_sync(0xffffffffu, r, off));
        if (lane == 0) red[kWarps] = r;
    }
    __syncthreads();
    return red[kWarps];
}

// the products of one launch, each planned once (Params::split)
enum Prod { kProdG, kProdColGram, kProdColUpdate, kProdBK, kProdVtCur,
            kProdRowGram, kProdRowUpdate, kProds };

template <typename T> struct Params {
    Args<T> a;
    int Bp, Kp, Mp, slot_n;
    int split[kProds];   // k slices of each product (split_of)
    T *curp, *G, *Gn, *V, *X1, *X2, *GV, *W, *Y1, *P, *Ya, *Yb, *part,
        *slots, *colvec;
    int* tickets;
    unsigned long long* stamps;   // Stamp's cycles, or nullptr
};

enum Epi { kStore, kStoreMaxAbs, kNsGram, kTau, kCheb };

template <typename T> struct Gemm {
    Prod kind;
    int m, n, k;                    // m, n multiples of kTile, k of kStageK
    const T* A; int lda; bool ak;   // ak: op(A)[i][k] = A[i*lda+k], else A[k*lda+i]
    const T* B; int ldb; bool bk;   // bk: op(B)[k][j] = B[j*ldb+k], else B[k*ldb+j]
    T* C; int ldc;
    Epi epi;
    bool sym;                       // C symmetric: tiles ti <= tj, mirrored
    int keep;                       // kNsGram: target diag(j < keep)
    const T* E1; const T* E2;       // kTau: V; kCheb: Y1, V (leading dim ldc)
    T c;                            // kCheb coefficient
};

// Params::stamps, in a profiling build with XERUS_GRID_STAMPS (its entry
// xerus_gemm_exact_grid_stamped_*, examples/k2_grid.py --stamps): CTA 0's
// clock64 cycles in all and in each part of the work, and the k slices it
// computed.  Without the macro the route carries no stamp code.
#ifdef XERUS_GRID_STAMPS
constexpr bool kStampsBuilt = true;
#else
constexpr bool kStampsBuilt = false;
#endif
enum Stamp { kCycles, kBarrierWait, kProducts, kFolds, kItemFill, kKLoops,
             kFoldEpilogue, kSlices, kStamps };

template <typename T> struct Ctx {
    cg::grid_group grid;
    int* last;      // this CTA finished a split tile's last slice
    const Params<T>& p;
    int rnd;        // reduction round: picks one of the two slot sets
    int ns_total;   // Newton-Schulz iterations, all calls
    int ns_rows;    // of which the row polar's
    int syncs;      // grid barriers
    bool rec;       // this thread keeps the stamps
    long long st[kStamps];

    __device__ long long now() const {
        if constexpr (kStampsBuilt) return rec ? clock64() : 0;
        return 0;
    }
    __device__ void add(Stamp k, long long since) {
        if constexpr (kStampsBuilt)
            if (rec) st[k] += clock64() - since;
    }
    __device__ void sync() {
        const long long c0 = now();
        grid.sync();
        add(kBarrierWait, c0);
        ++syncs;
    }
    __device__ T* slots() const { return p.slots + (rnd & 1) * p.slot_n; }
    // fold n values another CTA may have written, in index order
    template <typename Op>
    __device__ T fold(const T* v, int n, Op op, T ident) {
        const long long c0 = now();
        T a = ident;
        for (int i = threadIdx.x; i < n; i += kThreads) a = op(a, __ldcg(v + i));
        a = block_reduce(a, op, ident, smem<T>() + kSmRed);
        add(kFolds, c0);
        return a;
    }
    // after the barrier that follows a product: fold its n tile slots
    template <typename Op>
    __device__ T reduce(int n, Op op, T ident) {
        const T v = fold(slots(), n, op, ident);
        ++rnd;
        return v;
    }
    __device__ size_t gtid() const {
        return (size_t)blockIdx.x * kThreads + threadIdx.x;
    }
    __device__ size_t gstride() const { return (size_t)gridDim.x * kThreads; }
};

__device__ __forceinline__ void cp16(void* s, const void* g) {
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(g)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// rows x cols block (cols a multiple of 16 bytes) global -> shared
template <typename T>
__device__ __forceinline__ void stage_copy(T* s, int sld, const T* g,
                                           size_t gld, int rows, int cols) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = cols / E;
    for (int c = threadIdx.x; c < rows * cpr; c += kThreads) {
        const int r = c / cpr, q = c - r * cpr;
        cp16(s + r * sld + q * E, g + r * gld + q * E);
    }
}

// the A and B slices of k [k0, k0 + kStageK) of the tile at (i0, j0)
template <typename T, bool AK, bool BK>
__device__ __forceinline__ void load_stage(const Gemm<T>& g, int i0, int j0,
                                           int k0, T* st) {
    T* As = st;
    T* Bs = st + kTile * kLdK;
    if constexpr (AK)
        stage_copy(As, kLdK, g.A + (size_t)i0 * g.lda + k0, g.lda, kTile,
                   kStageK);
    else
        stage_copy(As, kTile, g.A + (size_t)k0 * g.lda + i0, g.lda, kStageK,
                   kTile);
    if constexpr (BK)
        stage_copy(Bs, kLdK, g.B + (size_t)j0 * g.ldb + k0, g.ldb, kTile,
                   kStageK);
    else
        stage_copy(Bs, kTile, g.B + (size_t)k0 * g.ldb + j0, g.ldb, kStageK,
                   kTile);
}

// A thread's rows and columns of the tile: 4 strided (k-contiguous
// operand, 16-byte loads along k) or 4 adjacent (16-byte loads along the
// row / column), so that a warp's loads hit distinct banks or broadcast.
template <bool AK> __device__ __forceinline__ int row_of(int ty, int r) {
    return AK ? ty + 8 * r : 4 * ty + r;
}
template <bool BK> __device__ __forceinline__ int col_of(int tx, int c) {
    return BK ? tx + 8 * c : 4 * tx + c;
}

// float32: group q's quarter of one staged slice into its 4 x 4 register
// block
template <typename T, bool AK, bool BK>
__device__ __forceinline__ void compute_stage(const T* st, int q, int tx,
                                              int ty, T (&acc)[4][4]) {
    const T* As = st;
    const T* Bs = st + kTile * kLdK;
#pragma unroll
    for (int kq = 0; kq < kStageK / kGroups / 4; ++kq) {
        const int k = q * (kStageK / kGroups) + 4 * kq;
        T a[4][4], b[4][4];   // a[r][kk], b[kk][c]
        if constexpr (AK) {
#pragma unroll
            for (int r = 0; r < 4; ++r) ld4(As + row_of<AK>(ty, r) * kLdK + k, a[r]);
        } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                T t[4];
                ld4(As + (k + kk) * kTile + 4 * ty, t);
#pragma unroll
                for (int r = 0; r < 4; ++r) a[r][kk] = t[r];
            }
        }
        if constexpr (BK) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                T t[4];
                ld4(Bs + col_of<BK>(tx, c) * kLdK + k, t);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) b[kk][c] = t[kk];
            }
        } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) ld4(Bs + (k + kk) * kTile + 4 * tx, b[kk]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[r][c] = Num<T>::mad(a[r][kk], b[kk][c], acc[r][c]);
    }
}

// D += A B on the FP64 tensor cores, one m16n8k4 tile: lane (g, t) =
// (lane / 4, lane % 4) holds a0 = A[g][t], a1 = A[g + 8][t], b = B[t][g]
// and d = C[g][2t], C[g][2t + 1], C[g + 8][2t], C[g + 8][2t + 1]
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double b) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(b));
}

// float64: group q's quarter of one staged slice on the FP64 tensor cores.
// Warp w of the group owns rows [16 w, 16 w + 16) and all 32 columns as
// four m16n8 tiles, acc[cb] the fragment of tile cb (columns 8 cb ..);
// every output sums its k in order, four at a time.
template <bool AK, bool BK>
__device__ __forceinline__ void compute_stage_dmma(const double* st, int q,
                                                   int w, int lane,
                                                   double (&acc)[4][4]) {
    const double* As = st;
    const double* Bs = st + kTile * kLdK;
    const int g = lane >> 2, r0 = 16 * w + g;
#pragma unroll
    for (int kq = 0; kq < kStageK / kGroups / 4; ++kq) {
        const int k = q * (kStageK / kGroups) + 4 * kq + (lane & 3);
        const double a0 = AK ? As[r0 * kLdK + k] : As[k * kTile + r0];
        const double a1 = AK ? As[(r0 + 8) * kLdK + k]
                             : As[k * kTile + r0 + 8];
#pragma unroll
        for (int cb = 0; cb < 4; ++cb) {
            const int c = 8 * cb + g;
            dmma(acc[cb], a0, a1, BK ? Bs[c * kLdK + k] : Bs[k * kTile + c]);
        }
    }
}

// the tile element that accumulator acc[a][b] of thread lt (of its
// group) holds: the SIMT 4 x 4 block in float32, the m16n8 fragments in
// float64
template <typename T, bool AK, bool BK>
__device__ __forceinline__ void acc_at(int lt, int a, int b, int& r, int& c) {
    if constexpr (std::is_same<T, double>::value) {
        const int lane = lt & 31;
        r = 16 * (lt >> 5) + (lane >> 2) + 8 * (b >> 1);
        c = 8 * a + 2 * (lane & 3) + (b & 1);
    } else {
        r = row_of<AK>(lt >> 3, a);
        c = col_of<BK>(lt & 7, b);
    }
}

// tile t of a product with nt tile columns: row-major over all tiles, or
// over the tiles on and above the diagonal
__device__ __forceinline__ void tile_ij(int t, int nt, bool sym, int& ti,
                                        int& tj) {
    if (!sym) {
        ti = t / nt;
        tj = t - ti * nt;
        return;
    }
    int i = 0, row = nt;
    while (t >= row) {
        t -= row;
        ++i;
        --row;
    }
    ti = i;
    tj = i + t;
}

// the epilogue of one finished tile (in shared memory, rows kLdT apart):
// store, mirror, and the tile's reduction into its slot
template <typename T>
__device__ __forceinline__ void epilogue(const Gemm<T>& g, const T* ts, int i0,
                                          int j0, bool mirror, T* slot) {
    T part = T(0);
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int li = e / kTile, lj = e - li * kTile;
        const int i = i0 + li, j = j0 + lj;
        const T v = ts[li * kLdT + lj];
        const size_t at = (size_t)i * g.ldc + j;
        switch (g.epi) {
        case kStore:
            g.C[at] = v;
            break;
        case kStoreMaxAbs:
            g.C[at] = v;
            part = nmax(part, Num<T>::abs(v));
            break;
        case kNsGram: {
            const T tgt = (i == j && j < g.keep) ? T(1) : T(0);
            part = nmax(part, Num<T>::abs(v - tgt));
            g.C[at] = (i == j ? T(1.5) : T(0)) - T(0.5) * v;
            break;
        }
        case kTau:
            part += __ldcg(g.E1 + at) * v;
            break;
        case kCheb:
            g.C[at] = T(2) * (g.c * v - __ldcg(g.E1 + at)) - __ldcg(g.E2 + at);
            break;
        }
        if (mirror) {   // element (j0 + li, i0 + lj), off the diagonal
            const T w = ts[lj * kLdT + li];
            g.C[(size_t)(j0 + li) * g.ldc + i0 + lj] =
                g.epi == kNsGram ? T(0) - T(0.5) * w : w;
        }
    }
    if (g.epi == kStoreMaxAbs || g.epi == kNsGram)
        part = block_reduce(part, MaxOp(), T(0), smem<T>() + kSmRed);
    else if (g.epi == kTau)
        part = block_reduce(part, SumOp(), T(0), smem<T>() + kSmRed);
    else
        return;
    if (threadIdx.x == 0) *slot = part;
}

template <typename T, bool AK, bool BK>
__device__ void items(Ctx<T>& cx, const Gemm<T>& g, int nt, int tiles,
                      int s, int units) {
    T* sm = smem<T>();
    T* ts = sm + kSmTile;
    T* slots = cx.slots();
    const int tid = threadIdx.x, q = tid >> 6, lt = tid & 63;
    const int tx = lt & 7, ty = lt >> 3;
    for (int item = blockIdx.x; item < tiles * s; item += gridDim.x) {
        const int t = item / s, r = item - t * s;
        int ti, tj;
        tile_ij(t, nt, g.sym, ti, tj);
        const int i0 = ti * kTile, j0 = tj * kTile;
        const int u0 = r * units / s, n_st = (r + 1) * units / s - u0;
        long long c_fill = cx.now(), c_loop = c_fill;
        T acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = T(0);
        for (int st = 0; st < kStages - 1; ++st) {
            if (st < n_st)
                load_stage<T, AK, BK>(g, i0, j0, (u0 + st) * kStageK,
                                      sm + st * kStageElems);
            cp_commit();
        }
        for (int st = 0; st < n_st; ++st) {
            const int nx = st + kStages - 1;
            if (nx < n_st)
                load_stage<T, AK, BK>(g, i0, j0, (u0 + nx) * kStageK,
                                      sm + (nx % kStages) * kStageElems);
            cp_commit();
            cp_wait<kStages - 1>();
            __syncthreads();
            if (st == 0) {
                cx.add(kItemFill, c_fill);
                c_loop = cx.now();
            }
            if constexpr (std::is_same<T, double>::value)
                compute_stage_dmma<AK, BK>(sm + (st % kStages) * kStageElems,
                                           q, lt >> 5, lt & 31, acc);
            else
                compute_stage<T, AK, BK>(sm + (st % kStages) * kStageElems,
                                         q, tx, ty, acc);
            __syncthreads();
        }
        cx.add(kKLoops, c_loop);
        if (kStampsBuilt && cx.rec) cx.st[kSlices] += n_st;
        const long long c_epi = cx.now();
        // fold the four k quarters in order (over the idle ring)
        T* red = sm;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                int r, c;
                acc_at<T, AK, BK>(lt, a, b, r, c);
                red[(q * kTile + r) * kLdT + c] = acc[a][b];
            }
        __syncthreads();
        for (int e = tid; e < kTile * kTile; e += kThreads) {
            const int li = e / kTile, lj = e - li * kTile;
            T v = red[li * kLdT + lj];
#pragma unroll
            for (int gq = 1; gq < kGroups; ++gq)
                v += red[(gq * kTile + li) * kLdT + lj];
            ts[li * kLdT + lj] = v;
        }
        __syncthreads();
        if (s > 1) {
            // publish this slice's partial; the CTA that takes the tile's
            // last ticket folds all slices in order
            T* mine = cx.p.part + (size_t)item * kTile * kTile;
            for (int e = tid; e < kTile * kTile; e += kThreads)
                mine[e] = ts[(e / kTile) * kLdT + e % kTile];
            __syncthreads();
            if (tid == 0) {   // release the CTA's stores, take a ticket
                __threadfence();
                *cx.last = atomicAdd(cx.p.tickets + t, 1) == s - 1;
                if (*cx.last) __threadfence();   // acquire the others'
            }
            __syncthreads();
            if (!*cx.last) {
                cx.add(kFoldEpilogue, c_epi);
                continue;
            }
            const T* base = cx.p.part + (size_t)t * s * kTile * kTile;
            for (int e = tid; e < kTile * kTile; e += kThreads) {
                T v = __ldcg(base + e);
                for (int rr = 1; rr < s; ++rr)
                    v += __ldcg(base + (size_t)rr * kTile * kTile + e);
                ts[(e / kTile) * kLdT + e % kTile] = v;
            }
            if (tid == 0) cx.p.tickets[t] = 0;
            __syncthreads();
        }
        epilogue(g, ts, i0, j0, g.sym && ti != tj, slots + t);
        __syncthreads();
        cx.add(kFoldEpilogue, c_epi);
    }
}

// C = op(A) op(B) with g's epilogue over the whole grid; returns the
// number of tiles (the slots a reduction wrote).  The caller syncs.
template <typename T>
__device__ int product(Ctx<T>& cx, const Gemm<T>& g) {
    const int mt = g.m / kTile, nt = g.n / kTile;
    const int tiles = g.sym ? nt * (nt + 1) / 2 : mt * nt;
    const int units = g.k / kStageK;
    const int s = cx.p.split[g.kind];
    const long long c0 = cx.now();
    if (g.ak) {
        if (g.bk) items<T, true, true>(cx, g, nt, tiles, s, units);
        else items<T, true, false>(cx, g, nt, tiles, s, units);
    } else {
        if (g.bk) items<T, false, true>(cx, g, nt, tiles, s, units);
        else items<T, false, false>(cx, g, nt, tiles, s, units);
    }
    cx.add(kProducts, c0);
    return tiles;
}

// Newton-Schulz iteration on X (cols: (Bp, Kp), X <- X (1.5 I - 0.5 X^T X);
// rows: (Kp, Mp), Y <- (1.5 I - 0.5 Y Y^T) Y) until max|S - diag(mask)| <=
// 64 eps or max_ns steps.  X starts in `x`; `y` is the other buffer.
// Returns the buffer holding the result; `ok` = err <= tol.
template <typename T>
__device__ T* ns_iterate(Ctx<T>& cx, bool rows, T* x, T* y, bool& ok) {
    const Params<T>& p = cx.p;
    const int Kp = p.Kp, L = rows ? p.Mp : p.Bp;
    const T tol = T(64.0 * Num<T>::eps);
    Gemm<T> gs{};   // S = X^T X (cols) or Y Y^T (rows) -> P and the error
    gs.kind = rows ? kProdRowGram : kProdColGram;
    gs.m = Kp; gs.n = Kp; gs.k = L;
    gs.C = p.P; gs.ldc = Kp; gs.epi = kNsGram; gs.sym = true;
    gs.keep = p.a.keep;
    Gemm<T> gu{};   // the update into y
    gu.kind = rows ? kProdRowUpdate : kProdColUpdate;
    gu.epi = kStore;
    int it = 0;
    T err;
    for (;;) {
        gs.A = x; gs.B = x;
        if (rows) {
            gs.lda = L; gs.ak = true; gs.ldb = L; gs.bk = true;
        } else {
            gs.lda = Kp; gs.ak = false; gs.ldb = Kp; gs.bk = false;
        }
        const int nt = product(cx, gs);
        cx.sync();
        err = cx.reduce(nt, MaxOp(), T(0));
        if (!(err > tol) || it >= p.a.max_ns) break;
        if (rows) {   // y = P x, (Kp, Kp) (Kp, Mp)
            gu.m = Kp; gu.n = L; gu.k = Kp;
            gu.A = p.P; gu.lda = Kp; gu.ak = true;
            gu.B = x; gu.ldb = L; gu.bk = false;
            gu.ldc = L;
        } else {      // y = x P, (Bp, Kp) (Kp, Kp)
            gu.m = L; gu.n = Kp; gu.k = Kp;
            gu.A = x; gu.lda = Kp; gu.ak = true;
            gu.B = p.P; gu.ldb = Kp; gu.bk = false;
            gu.ldc = Kp;
        }
        gu.C = y;
        product(cx, gu);
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
// Writes into x / y (Bp x Kp); returns the buffer holding Q.
template <typename T>
__device__ T* orth(Ctx<T>& cx, const T* w, T* x, T* y, bool& ok) {
    const Params<T>& p = cx.p;
    const T tiny = T(1e-30);
    const int Bp = p.Bp, Kp = p.Kp;
    T* red = smem<T>() + kSmRed;
    for (int j = blockIdx.x; j < Kp; j += gridDim.x) {
        T s = T(0);
        for (int i = threadIdx.x; i < Bp; i += kThreads) {
            const T v = __ldcg(w + (size_t)i * Kp + j);
            s += v * v;
        }
        const T nrm = nmax(Num<T>::sqrt(block_reduce(s, SumOp(), T(0), red)),
                           tiny);
        const T mj = mask_of<T>(j, p.a.keep);
        T q = T(0);
        for (int i = threadIdx.x; i < Bp; i += kThreads) {
            const T v = (__ldcg(w + (size_t)i * Kp + j) / nrm) * mj;
            x[(size_t)i * Kp + j] = v;
            q += v * v;
        }
        q = block_reduce(q, SumOp(), T(0), red);
        if (threadIdx.x == 0) p.colvec[j] = q;
    }
    cx.sync();
    const T alpha = Num<T>::sqrt(cx.fold(p.colvec, Kp, SumOp(), T(0))) + tiny;
    for (size_t e = cx.gtid(); e < (size_t)Bp * Kp; e += cx.gstride())
        x[e] = __ldcg(x + e) / alpha;
    cx.sync();
    return ns_iterate(cx, false, x, y, ok);
}

// tau = sum(V * (G V)) without storing G V
template <typename T>
__device__ T tau_of(Ctx<T>& cx, const T* v) {
    const Params<T>& p = cx.p;
    Gemm<T> g{};
    g.kind = kProdBK;
    g.m = p.Bp; g.n = p.Kp; g.k = p.Bp;
    g.A = p.G; g.lda = p.Bp; g.ak = true;
    g.B = v; g.ldb = p.Kp; g.bk = false;
    g.ldc = p.Kp; g.epi = kTau; g.E1 = v;
    const int nt = product(cx, g);
    cx.sync();
    return cx.reduce(nt, SumOp(), T(0));
}

// dst (Bp x Kp) = Gn @ src
template <typename T>
__device__ void gn_times(Ctx<T>& cx, const T* src, T* dst) {
    const Params<T>& p = cx.p;
    Gemm<T> g{};
    g.kind = kProdBK;
    g.m = p.Bp; g.n = p.Kp; g.k = p.Bp;
    g.A = p.Gn; g.lda = p.Bp; g.ak = true;
    g.B = src; g.ldb = p.Kp; g.bk = false;
    g.C = dst; g.ldc = p.Kp; g.epi = kStore;
    product(cx, g);
    cx.sync();
}

// Q = orth(W), the orthonormalization of an outer or polish step's image
// in p.W (GV = Gn V in p.GV).  With `retry` (two_stage<T>) a power step's
// that ends at max_ns is taken again from the same V in two stages,
// Q1 = orth(GV), then orth(Gn Q1) (ok: the second's; ++retries).  A first
// stage that ends at the cap too stops the retry: the step keeps its
// one-stage Q (ok false) and `retry` is false for the rest of the launch
// (++stops).  The first stage works in the free basis and Y1 (which only
// Chebyshev steps use), so the one-stage Q stays; Gn Q1 reads Q1 into W
// before the second stage writes f1 and f2.  Every stage runs through
// the one orth call: with a second inlined copy of the Newton-Schulz loop
// the float32 kernel spilled registers, and bonds that never retry took
// 5-7% longer on an H100.
template <typename T>
__device__ __forceinline__ T* step_orth(Ctx<T>& cx, bool power, bool& retry,
                                        T* f1, T* f2, bool& ok,
                                        int& retries, int& stops) {
    const Params<T>& p = cx.p;
    const T* w = p.W;
    T *x = f1, *y = f2, *q0 = nullptr;
    for (int stage = 0;; ++stage) {
        T* q = orth(cx, w, x, y, ok);
        if (!(two_stage<T> && power && retry) || stage == 2
            || (stage == 0 && ok))
            return q;
        if (stage == 0) {   // retry: Q1 = orth(GV), beside Q
            ++retries;
            q0 = q;
            w = p.GV;
            x = q == f1 ? f2 : f1;
            y = p.Y1;
        } else if (!ok) {   // the first stage ended at the cap too
            ++stops;
            retry = false;
            return q0;
        } else {            // then orth(Gn Q1)
            gn_times(cx, q, p.W);
            w = p.W;
            x = f1;
            y = f2;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
kernel(Params<T> p) {
    __shared__ int last;
    T* red = smem<T>() + kSmRed;
    Ctx<T> cx{cg::this_grid(), &last, p, 0, 0, 0, 0,
              p.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0,
              {}};
    const long long c_start = cx.now();
    const Args<T>& a = p.a;
    const int B = a.B, M = a.M, K = a.K;
    const int Bp = p.Bp, Kp = p.Kp, Mp = p.Mp;
    const T tiny = T(1e-30);
    const T eps = T(Num<T>::eps);
    const T stag_tol = T(8.0 * Num<T>::eps);
    const T noise_floor = T(4.0 * Num<T>::eps);
    const T cap_tol = T(16.0 * Num<T>::eps);

    // ---- cur into its zero-padded copy; tickets to zero ----
    for (size_t e = cx.gtid(); e < (size_t)Bp * Mp; e += cx.gstride()) {
        const int i = (int)(e / Mp), j = (int)(e % Mp);
        p.curp[e] = (i < B && j < M) ? a.cur[(size_t)i * M + j] : T(0);
    }
    for (size_t e = cx.gtid(); e < (size_t)kMaxItems; e += cx.gstride())
        p.tickets[e] = 0;
    cx.sync();

    // ---- G = cur cur^T and its scalars ----
    T gmax;
    {
        Gemm<T> g{};
        g.kind = kProdG;
        g.m = Bp; g.n = Bp; g.k = Mp;
        g.A = p.curp; g.lda = Mp; g.ak = true;
        g.B = p.curp; g.ldb = Mp; g.bk = true;
        g.C = p.G; g.ldc = Bp; g.epi = kStoreMaxAbs; g.sym = true;
        const int nt = product(cx, g);
        cx.sync();
        gmax = cx.reduce(nt, MaxOp(), T(0)) + tiny;
    }
    T trG, live;
    {
        T s = T(0), c = T(0);
        for (int i = threadIdx.x; i < B; i += kThreads) {
            const T gii = __ldcg(p.G + (size_t)i * Bp + i);
            s += gii;
            c += gii > T(0) ? T(1) : T(0);
        }
        trG = block_reduce(s, SumOp(), T(0), red);
        live = block_reduce(c, SumOp(), T(0), red);
    }
    const T keep_f = nmax(T(a.keep < 0 ? 0 : (a.keep < K ? a.keep : K)), T(1));
    const T gscale = trG + tiny;

    // Gn = G / gscale; start basis W = (G[:, :K] + 1e-3 gmax hash) * mask
    {
        const T hscale = T(1e-3) * gmax;
        for (size_t e = cx.gtid(); e < (size_t)Bp * Bp; e += cx.gstride())
            p.Gn[e] = __ldcg(p.G + e) / gscale;
        for (size_t e = cx.gtid(); e < (size_t)Bp * Kp; e += cx.gstride()) {
            const int i = (int)(e / Kp), j = (int)(e % Kp);
            p.W[e] = (i < B && j < K)
                         ? (__ldcg(p.G + (size_t)i * Bp + j)
                            + hscale * start_hash<T>(i, j)) * mask_of<T>(j, a.keep)
                         : T(0);
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
    int stall = 0, it = 0, retries = 0, stops = 0;
    bool retry = two_stage<T>;
    while (stall < a.stall_need && it < a.max_outer) {
        const bool power = (it % 2) == 0;
        gn_times(cx, V, p.GV);
        if (power) {
            gn_times(cx, p.GV, p.W);
        } else {
            // column Rayleigh quotients of V (dead columns: +inf)
            for (int j = blockIdx.x; j < Kp; j += gridDim.x) {
                T s = T(0);
                for (int i = threadIdx.x; i < Bp; i += kThreads) {
                    const size_t at = (size_t)i * Kp + j;
                    s += __ldcg(V + at) * __ldcg(p.GV + at);
                }
                s = block_reduce(s, SumOp(), T(0), red) * gscale;
                if (threadIdx.x == 0)
                    p.colvec[j] = j < a.keep ? s : Num<T>::inf();
            }
            cx.sync();
            const T rmin = cx.fold(p.colvec, Kp, MinOp(), Num<T>::inf());
            const T resid = nmax(trG - tau, T(0));
            const T b_floor = T(0.5) * resid / nmax(live - keep_f, T(1))
                              + eps * trG + tiny;
            const T b = nmax(T(0.9) * rmin, b_floor);
            const T c = T(2) * gscale / b;
            for (size_t e = cx.gtid(); e < (size_t)Bp * Kp; e += cx.gstride())
                p.Y1[e] = c * __ldcg(p.GV + e) - __ldcg(V + e);
            cx.sync();
            Gemm<T> g{};
            g.kind = kProdBK;
            g.m = Bp; g.n = Kp; g.k = Bp;
            g.A = p.Gn; g.lda = Bp; g.ak = true;
            g.B = p.Y1; g.ldb = Kp; g.bk = false;
            g.C = p.W; g.ldc = Kp; g.epi = kCheb;
            g.E1 = p.Y1; g.E2 = V; g.c = c;
            product(cx, g);
            cx.sync();
        }
        T* q = step_orth(cx, power, retry, F1, F2, ok, retries, stops);
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
        T* q = step_orth(cx, true, retry, F1, F2, ok2, retries, stops);
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
        g.kind = kProdVtCur;
        g.m = Kp; g.n = Mp; g.k = Bp;
        g.A = V; g.lda = Kp; g.ak = false;
        g.B = p.curp; g.ldb = Mp; g.bk = false;
        g.C = p.Ya; g.ldc = Mp; g.epi = kStore;
        product(cx, g);
        cx.sync();
    }
    for (int i = blockIdx.x; i < Kp; i += gridDim.x) {
        T* row = p.Ya + (size_t)i * Mp;
        T s = T(0);
        for (int j = threadIdx.x; j < Mp; j += kThreads) {
            const T v = __ldcg(row + j);
            s += v * v;
        }
        const T rn = nmax(Num<T>::sqrt(block_reduce(s, SumOp(), T(0), red)),
                          tiny);
        T q = T(0);
        for (int j = threadIdx.x; j < Mp; j += kThreads) {
            const T v = __ldcg(row + j) / rn;
            row[j] = v;
            if (i < K && j < M) a.vt_bal[(size_t)i * M + j] = v;
            q += v * v;
        }
        q = block_reduce(q, SumOp(), T(0), red);
        if (threadIdx.x == 0) p.colvec[i] = q;
    }
    cx.sync();
    const T alpha = Num<T>::sqrt(cx.fold(p.colvec, Kp, SumOp(), T(0))) + tiny;
    for (size_t e = cx.gtid(); e < (size_t)Kp * Mp; e += cx.gstride())
        p.Ya[e] = __ldcg(p.Ya + e) / alpha;
    cx.sync();
    bool okp;
    const T* y = ns_iterate(cx, true, p.Ya, p.Yb, okp);
    for (size_t e = cx.gtid(); e < (size_t)K * M; e += cx.gstride())
        a.vt0[e] = __ldcg(y + (e / M) * Mp + e % M);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        a.flags[kOkp] = okp ? 1 : 0;
        a.flags[kConverged] = converged ? 1 : 0;
        a.flags[kOuter] = it;
        a.flags[kNs] = cx.ns_total;
        a.flags[kBarriers] = cx.syncs;
        a.flags[kClusterCtas] = 0;
        a.flags[kNsRows] = cx.ns_rows;
        a.flags[kRetries] = retries;
        a.flags[kRetryStops] = stops;
    }
    if (kStampsBuilt && cx.rec) {
        cx.add(kCycles, c_start);
        for (int k = 0; k < kStamps; ++k) p.stamps[k] = cx.st[k];
    }
}

// workspace layout (elements), each buffer a multiple of 64 elements;
// ops/gemm_exact.py grid_layout mirrors it (a card test holds the two
// together through xerus_gemm_exact_workspace_bytes)
struct Layout {
    int Bp, Kp, Mp, slot_n;
    size_t curp, G, Gn, V, X1, X2, GV, W, Y1, P, Ya, Yb, part, slots, colvec,
        tickets, total;
};

inline size_t up64(size_t n) { return (n + 63) / 64 * 64; }

inline Layout layout(int B, int M, int K) {
    Layout l;
    l.Bp = pad(B); l.Kp = pad(K); l.Mp = pad(M);
    const size_t bp = l.Bp, kp = l.Kp, mp = l.Mp;
    size_t tiles = bp * bp;
    if (bp * kp > tiles) tiles = bp * kp;
    if (kp * mp > tiles) tiles = kp * mp;
    l.slot_n = (int)(tiles / (kTile * kTile));
    size_t o = 0;
    l.curp = o; o += up64(bp * mp);
    l.G = o; o += up64(bp * bp);
    l.Gn = o; o += up64(bp * bp);
    l.V = o; o += up64(bp * kp);
    l.X1 = o; o += up64(bp * kp);
    l.X2 = o; o += up64(bp * kp);
    l.GV = o; o += up64(bp * kp);
    l.W = o; o += up64(bp * kp);
    l.Y1 = o; o += up64(bp * kp);
    l.P = o; o += up64(kp * kp);
    l.Ya = o; o += up64(kp * mp);
    l.Yb = o; o += up64(kp * mp);
    l.part = o; o += up64((size_t)kMaxItems * kTile * kTile);
    l.slots = o; o += up64(2 * (size_t)l.slot_n);
    l.colvec = o; o += up64(bp > kp ? bp : kp);
    l.tickets = o; o += up64((size_t)kMaxItems);
    l.total = o;
    return l;
}

// each product's (m, n, k, symmetric) at the padded sizes, in Prod
// order, and its k splits (ops/gemm_exact.py grid_plan mirrors both and
// tile_ij for the CPU tests)
inline void products(const Layout& l, int (*mnks)[4]) {
    const int B = l.Bp, K = l.Kp, M = l.Mp;
    const int t[kProds][4] = {{B, B, M, 1}, {K, K, B, 1}, {B, K, K, 0},
                              {B, K, B, 0}, {K, M, B, 0}, {K, K, M, 1},
                              {K, M, K, 0}};
    for (int i = 0; i < kProds; ++i)
        for (int j = 0; j < 4; ++j) mnks[i][j] = t[i][j];
}

inline void plan(const Layout& l, int grid, int* split) {
    int mnks[kProds][4];
    products(l, mnks);
    for (int i = 0; i < kProds; ++i) {
        const int mt = mnks[i][0] / kTile, nt = mnks[i][1] / kTile;
        const int tiles = mnks[i][3] ? nt * (nt + 1) / 2 : mt * nt;
        split[i] = split_of(tiles, mnks[i][2] / kStageK, grid);
    }
}

template <typename T>
int launch(const Args<T>& a, void* ws, cudaStream_t stream,
           unsigned long long* stamps) {
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return (int)e;
    if (!coop) return (int)cudaErrorNotSupported;
    const size_t smem = (size_t)kSmElems * sizeof(T);
    e = cudaFuncSetAttribute(kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel<T>,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;

    const Layout l = layout(a.B, a.M, a.K);
    T* w = static_cast<T*>(ws);
    Params<T> p;
    p.a = a;
    p.Bp = l.Bp; p.Kp = l.Kp; p.Mp = l.Mp; p.slot_n = l.slot_n;
    plan(l, ctas(sms), p.split);
    p.curp = w + l.curp; p.G = w + l.G; p.Gn = w + l.Gn; p.V = w + l.V;
    p.X1 = w + l.X1; p.X2 = w + l.X2; p.GV = w + l.GV; p.W = w + l.W;
    p.Y1 = w + l.Y1; p.P = w + l.P; p.Ya = w + l.Ya; p.Yb = w + l.Yb;
    p.part = w + l.part; p.slots = w + l.slots; p.colvec = w + l.colvec;
    p.tickets = reinterpret_cast<int*>(w + l.tickets);
    p.stamps = stamps;
    void* args[] = {&p};
    e = cudaLaunchCooperativeKernel((const void*)kernel<T>, dim3(ctas(sms)),
                                    dim3(kThreads), args, smem, stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace grid
}  // namespace gemm_exact
