// K3: evaluate a tensor train at M index tuples on Hopper.
//
// Replaces the Pallas TPU kernel xerus_tpu/ops/pallas_tt_eval.py
// (_tt_eval_kernel, entry tt_eval_at_points_pallas).  Input: the cores at
// their true shapes (rl, n, rr), each through its address and strides (any
// layout, nothing copied or padded), and the positions, an (M, d) row-major
// int64 array.  Output: values[m] = C_0[:, i_m0, :] C_1[:, i_m1, :] ...
// C_{d-1}[:, i_m(d-1), :], entry [0, 0].  Callers: the measurement layer
// (measure, test) and IHT, through ops/tt_eval.py tt_eval_at_points.
//
// What bounds it: the shared-memory load path first, then the position
// stream; not its FMAs.  examples/smem_probe.cu times the loads on the
// card: a warp-load whose lanes read one address takes 1 cycle
// (64-bit) or 2 (128-bit); one whose lanes read from 4 different core slices
// takes 2 or 4, whether or not the slices share banks' rows, the same as 32
// different addresses: the SM hands its lanes 128 bytes a cycle, and wider
// loads or a bank-spread layout do not change that.  One thread per
// measurement gathering its own (r, r) slice at every site therefore pays
// d r^2 loaded elements per entry however they are laid out: 456 at the
// completion slice's shape, 0.10 to 0.12 ms over 4^10 entries in f64 (the
// first version of this kernel, padded to 640 loads with a 2-way bank
// conflict, took 0.15 ms).  The way below that is to read fewer core
// elements per entry, so the kernel works in two phases:
//
// 1. Tables.  The host's plan (ops/tt_eval.py tt_eval_plan) splits the
//    sites into runs.  The block stages every core once (all sites in one
//    pass, four loads in flight per thread) and multiplies each run's cores
//    into one table in its shared memory, T[j] = C_k0[:, i_k0, :] ...
//    C_k1[:, i_k1, :] for the run's combined index j, one site of every run
//    per level, through two intermediate buffers per run; a run of one site
//    is staged straight into its table.  The last run keeps column 0 only,
//    as one row per j (a dot product).  Columns are zero-padded to the width
//    class of the step that reads them (R, R/2 or R/4 of the instantiation's
//    frontier capacity R, at least one 16-byte vector); slices are an odd
//    number of 16-byte units apart.  Every offset, pitch, step variant and
//    build step comes from the plan, whose plain model the CPU tests check.
// 2. Measurements.  The block's working warps are workers of their own:
//    each walks tiles of 32 measurements (tile t to warp t mod all working
//    warps, blocks first), lane 0 brings a tile's positions (one contiguous
//    run of 32 d 8 bytes) into the warp's buffer in shared memory with one
//    cp.async.bulk that completes on the warp's mbarrier, the first one
//    already under phase 1 when the plan found room for the buffers beside
//    the build's scratch.  A warp holds one tile at a time and asks for the
//    next when it is done with this one; the block's other warps (up to 32)
//    cover the copy, and a ring of two or three tiles per warp measured no
//    faster than one.  Each lane then takes its row
//    in 16-byte loads (even d; 8-byte for odd d), forms each run's combined
//    index, and multiplies its frontier, held in registers, by the slice:
//    compile-time row and column bounds, 16-byte loads, one FMA per loaded
//    element and no per-element predicate.  At the slice's shape and 4^10
//    entries the plan merges the ten sites into runs of 4 + 3 + 3, 80
//    elements per entry instead of 456; blocks with fewer measurements than
//    the plan's threshold keep one run per site, because a table is paid for
//    once per block.
//    A tile whose bytes are not a multiple of 16 (the last, partial one) or
//    positions that do not start on a 16-byte boundary are copied by the
//    warp's plain loads instead; nothing is read past the array's end.
//
// Shapes the tables do not take (ranks above 32, more than 24 sites, tables
// past the 227 KB a block can opt in to) go to tt_eval_generic: one thread
// per measurement, cores and positions through the read-only cache, the
// frontier in registers for ranks up to 32 and in a (2, r, M) scratch in
// device memory, 8 outputs at a time, above.
// Streaming the cores site by site through shared memory would serve those
// better and is not done here.
//
// f64 stays f64 (the TPU ran f64 input in f32); f32 and f64 are two
// instantiations.  No atomics on floating point: a measurement's value
// depends on the plan alone, not on the warp or block that took it, so two
// launches are bitwise equal.
// Safety: an index outside [0, n_k) of its own site is never dereferenced
// (the measurement reads slice 0 instead).  Its value becomes NaN and it
// is counted (an integer atomic in shared memory, one count per block
// written out, so the total is exact and the caller zeroes nothing); the
// wrapper reads the counts and raises.  This includes an index in
// [n_k, max n) of a ragged site, which the padded stack of the first
// version read as zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSites = 24;
constexpr int kTile = 32;

struct Site {
    const void* ptr;
    long long s0, s1, s2;   // strides of [a, i, b] in elements
    int rl, n, rr;
    int ccode;              // step variant for (rl, rr)
    int dst, dpitch, drow;  // staged at dst: slices dpitch apart, rows drow
    int dot;                // 1: staged as rows [i][a] of column 0
    int estart;             // elements staged before this site
    int pad;
};

struct Group {          // what a measurement needs of a run
    int last;           // the run's last site
    int off, pitch, rowpitch, code, rl;
};

// One product of the build: rows [j][a] at src, times a staged core, into
// rows [j * n_k + i][a] at dst (ops/tt_eval.py StepPlan, field for field).
struct Step {
    int src, src_pitch, src_row;
    int core, core_pitch, core_row, ccode, rl_k, n_k;
    int dst, dst_pitch, dst_row;
    int rows, rl_g, dot, start, sync;
};

struct Table {
    int d, ngroups, nsteps, stage_bytes, ring_off, bar_off;
    int stage_total, bulk, early;
    int work_warps;        // warps of a block that take measurements
    Site sites[kMaxSites];
    Group groups[kMaxSites];
    Step steps[kMaxSites];
};

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
    return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
    return __longlong_as_double(0x7ff8000000000000LL);
}

// one 16-byte load: 2 doubles or 4 floats
__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
    const double2 c = *reinterpret_cast<const double2*>(p);
    v[0] = c.x;
    v[1] = c.y;
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
    const float4 c = *reinterpret_cast<const float4*>(p);
    v[0] = c.x;
    v[1] = c.y;
    v[2] = c.z;
    v[3] = c.w;
}

__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// F <- F S for a slice S of at most RW rows (rl of them used) and CW
// zero-padded columns at p, rows rowpitch apart.
template <typename T, int R, int RW, int CW>
__device__ __forceinline__ void step(T (&F)[R], const T* __restrict__ p,
                                     int rl, int rowpitch) {
    constexpr int V = 16 / sizeof(T);
    if constexpr (CW >= V) {
        T G[CW];
#pragma unroll
        for (int b = 0; b < CW; ++b) G[b] = T(0);
#pragma unroll
        for (int a = 0; a < RW; ++a) {
            if (RW == 1 || a < rl) {
                const T fa = F[a];
                const T* row = p + a * rowpitch;
#pragma unroll
                for (int b = 0; b < CW; b += V) {
                    T c[V];
                    load_vec(row + b, c);
#pragma unroll
                    for (int v = 0; v < V; ++v) {
                        G[b + v] = fma(fa, c[v], G[b + v]);
                    }
                }
            }
        }
#pragma unroll
        for (int b = 0; b < CW; ++b) F[b] = G[b];
    }
}

// F[0] <- F . row for the last run's one row per slice
template <typename T, int R>
__device__ __forceinline__ void dot(T (&F)[R], const T* __restrict__ p,
                                    int rl) {
    constexpr int V = 16 / sizeof(T);
    T acc = T(0);
#pragma unroll
    for (int a = 0; a < R; a += V) {
        if (a < rl) {
            T c[V];
            load_vec(p + a, c);
#pragma unroll
            for (int v = 0; v < V; ++v) {
                acc = fma(a + v < rl ? F[a + v] : T(0), c[v], acc);
            }
        }
    }
    F[0] = acc;
}

template <typename T, int R>
__device__ __forceinline__ void apply(T (&F)[R], const T* __restrict__ p,
                                      int code, int rl, int rowpitch) {
    switch (code) {
        case 0: step<T, R, R, R>(F, p, rl, rowpitch); break;
        case 1: step<T, R, R, R / 2>(F, p, rl, rowpitch); break;
        case 2: step<T, R, R, R / 4>(F, p, rl, rowpitch); break;
        case 3: step<T, R, R / 2, R>(F, p, rl, rowpitch); break;
        case 4: step<T, R, R / 2, R / 2>(F, p, rl, rowpitch); break;
        case 5: step<T, R, R / 2, R / 4>(F, p, rl, rowpitch); break;
        case 6: step<T, R, 1, R>(F, p, rl, rowpitch); break;
        case 7: step<T, R, 1, R / 2>(F, p, rl, rowpitch); break;
        case 8: step<T, R, 1, R / 4>(F, p, rl, rowpitch); break;
        default: dot<T, R>(F, p, rl); break;
    }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// n / d for 0 <= n < 2^24, 1 <= d < 2^24: a float quotient, corrected
__device__ __forceinline__ int fast_div(int n, int d) {
    int q = __float2int_rz(__fdividef(static_cast<float>(n),
                                      static_cast<float>(d)));
    const int r = n - q * d;
    if (r < 0) {
        --q;
    } else if (r >= d) {
        ++q;
    }
    return q;
}

template <typename T, int R, int THREADS, bool MERGE>
__global__ void __launch_bounds__(THREADS)
tt_eval_tables(const __grid_constant__ Table tab,
               const long long* __restrict__ pos, T* __restrict__ out,
               int* __restrict__ bad, long long M,
               unsigned long long* __restrict__ stamps) {
    extern __shared__ __align__(128) unsigned char raw[];
    T* smem = reinterpret_cast<T*>(raw);
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int d = tab.d;
    if (stamps != nullptr && tid == 0) stamps[blockIdx.x * 4] = global_ns();
    // measurements of this block with an index out of range; no global
    // counter, so the caller zeroes nothing before the launch
    __shared__ int block_bad;
    if (tid == 0) block_bad = 0;

    // every warp is its own worker in phase 2: its ring, its barriers
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int nwarps = tab.work_warps;
    const bool works = warp < nwarps;
    uint64_t* bar = reinterpret_cast<uint64_t*>(raw + tab.bar_off) + warp;
    unsigned char* ring = raw + tab.ring_off
        + static_cast<size_t>(warp) * tab.stage_bytes;
    const long long tiles = (M + kTile - 1) / kTile;
    const long long first =
        static_cast<long long>(warp) * gridDim.x + blockIdx.x;
    const long long stride = static_cast<long long>(nwarps) * gridDim.x;

    auto tile_bytes = [&](long long t) -> int {
        const long long left = M - t * kTile;
        return static_cast<int>(left < kTile ? left : kTile) * d * 8;
    };
    auto is_bulk = [&](long long t) -> bool {
        return tab.bulk && (tile_bytes(t) & 15) == 0;
    };
    auto fetch = [&](long long t) {
        const int bytes = tile_bytes(t);
        const long long* src = pos + t * kTile * d;
        unsigned char* dst = ring;
        if (is_bulk(t)) {
            if (lane == 0) {
                const uint32_t b = smem_u32(bar);
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                asm volatile(
                    "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                    :: "r"(b), "r"(bytes) : "memory");
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::"
                    "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                    :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(b)
                    : "memory");
            }
        } else {
            long long* dst64 = reinterpret_cast<long long*>(dst);
            for (int e = lane; e < bytes / 8; e += 32) {
                dst64[e] = __ldg(src + e);
            }
            __syncwarp();
        }
    };
    auto prefetch_first = [&]() {
        if (!works) return;
        if (lane == 0) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                         :: "r"(smem_u32(bar)), "r"(1) : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncwarp();
        if (first < tiles) fetch(first);
    };
    // phase 1a: stage every core where the plan says, four loads in flight
    // per thread and all sites in one pass (one memory latency, not d)
    for (int base = 0; base < tab.stage_total; base += nthreads * 4) {
        T v[4];
        int at[4];
        int k = 0;   // the thread's elements ascend, so its site only advances
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int e = base + u * nthreads + tid;
            at[u] = -1;
            v[u] = T(0);
            if (e < tab.stage_total) {
                while (k + 1 < d && e >= tab.sites[k + 1].estart) ++k;
                const Site& s = tab.sites[k];
                const T* src = static_cast<const T*>(s.ptr);
                const int le = e - s.estart;
                if (s.dot) {
                    const int i = fast_div(le, s.drow);
                    const int a = le - i * s.drow;
                    at[u] = s.dst + i * s.dpitch + a;
                    if (a < s.rl) v[u] = __ldg(src + a * s.s0 + i * s.s1);
                } else {
                    const int ia = fast_div(le, s.drow);   // i * rl + a
                    const int b = le - ia * s.drow;
                    const int i = fast_div(ia, s.rl);
                    const int a = ia - i * s.rl;
                    at[u] = s.dst + i * s.dpitch + a * s.drow + b;
                    if (b < s.rr) {
                        v[u] = __ldg(src + a * s.s0 + i * s.s1 + b * s.s2);
                    }
                }
            }
        }
        // the first tile's copy goes out behind the staging loads, not ahead
        // of them; the ring is the build's scratch unless the plan found
        // room for both
        if (base == 0 && tab.early) prefetch_first();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (at[u] >= 0) smem[at[u]] = v[u];
        }
    }
    if (tab.stage_total <= 0 && tab.early) prefetch_first();   // empty cores
    __syncthreads();
    if (stamps != nullptr && tid == 0) stamps[blockIdx.x * 4 + 1] = global_ns();

    // phase 1b: multiply the runs' cores into their tables, step by step as
    // the plan lists them (one site of every run per level; the runs of a
    // level start on different threads and proceed side by side)
    if constexpr (MERGE) {
        constexpr int V = 16 / sizeof(T);
        for (int q = 0; q < tab.nsteps; ++q) {
            const Step& S = tab.steps[q];
            int row = tid - S.start;
            if (row < 0) row += nthreads;
            // a warp's lanes share the site's index i and differ in (j, a), so
            // the core's loads are broadcasts
            const int per_i = fast_div(S.rows, S.n_k);   // prefix * rl_g
            for (; row < S.rows; row += nthreads) {
                const int i = fast_div(row, per_i);
                const int ja = row - i * per_i;
                const int j = fast_div(ja, S.rl_g);
                const int a = ja - j * S.rl_g;
                const int jn = j * S.n_k + i;
                const T* srow = smem + S.src + j * S.src_pitch + a * S.src_row;
                T F[R];
#pragma unroll
                for (int c = 0; c < R; c += V) {
                    T v[V];
#pragma unroll
                    for (int u = 0; u < V; ++u) v[u] = T(0);
                    if (c < S.src_row) load_vec(srow + c, v);
#pragma unroll
                    for (int u = 0; u < V; ++u) F[c + u] = v[u];
                }
                apply<T, R>(F, smem + S.core + i * S.core_pitch, S.ccode,
                            S.rl_k, S.core_row);
                if (S.dot) {
                    T* drow = smem + S.dst + jn * S.dst_pitch;
                    drow[a] = F[0];
                    if (a == 0) {   // the dot row's zero padding
                        for (int c = S.rl_g; c < S.dst_row; ++c) drow[c] = T(0);
                    }
                } else {
                    T* drow = smem + S.dst + jn * S.dst_pitch + a * S.dst_row;
#pragma unroll
                    for (int b = 0; b < R; b += V) {
                        if (b < S.dst_row) {
                            T v[V];
#pragma unroll
                            for (int u = 0; u < V; ++u) v[u] = F[b + u];
                            store_vec(drow + b, v);
                        }
                    }
                }
            }
            if (S.sync) __syncthreads();
        }
    }
    if (!tab.early) {
        __syncthreads();   // the scratch is free: it becomes the ring
        prefetch_first();
    }
    if (stamps != nullptr && tid == 0) stamps[blockIdx.x * 4 + 2] = global_ns();

    // phase 2: the measurements
    const bool vec = (d & 1) == 0;
    uint32_t parity = 0;
    for (long long t = works ? first : tiles; t < tiles; t += stride) {
        if (is_bulk(t)) {
            mbar_wait(smem_u32(bar), parity);
            parity ^= 1u;
        }
        const long long m = t * kTile + lane;
        if (m < M) {
            const unsigned char* rowp =
                ring + static_cast<size_t>(lane) * d * 8;
            T F[R];
#pragma unroll
            for (int a = 0; a < R; ++a) F[a] = a == 0 ? T(1) : T(0);
            bool ok = true;
            int k = 0;
            longlong2 pair = make_longlong2(0, 0);
            for (int g = 0; g < tab.ngroups; ++g) {
                const Group& G = tab.groups[g];
                int j = 0;
                for (; k <= G.last; ++k) {
                    long long i;
                    if (vec) {
                        if ((k & 1) == 0) {
                            pair = *reinterpret_cast<const longlong2*>(
                                rowp + k * 8);
                        }
                        i = (k & 1) ? pair.y : pair.x;
                    } else {
                        i = *reinterpret_cast<const long long*>(rowp + k * 8);
                    }
                    const int n = tab.sites[k].n;
                    const bool valid = static_cast<unsigned long long>(i)
                                       < static_cast<unsigned long long>(n);
                    ok = ok && valid;
                    j = j * n + (valid ? static_cast<int>(i) : 0);
                }
                apply<T, R>(F,
                            smem + G.off + static_cast<long long>(j) * G.pitch,
                            G.code, G.rl, G.rowpitch);
            }
            if (ok) {
                out[m] = F[0];
            } else {
                out[m] = quiet_nan<T>();
                atomicAdd(&block_bad, 1);
            }
        }
        __syncwarp();
        // one buffer per warp: the next tile after this one's use; the other
        // warps' arithmetic covers the copy
        if (t + stride < tiles) fetch(t + stride);
    }
    if (stamps != nullptr && tid == 0) stamps[blockIdx.x * 4 + 3] = global_ns();
    __syncthreads();
    if (tid == 0) bad[blockIdx.x] = block_bad;
}

// Shapes the tables do not take.  table: d rows of 7 int64 (address, three
// strides, rl, n, rr).  RT > 0: ranks up to RT, the frontier in registers.
// RT == 0: any rank, the frontier in scratch, two (r, M) buffers laid out so
// that neighbouring threads touch neighbouring addresses, 8 outputs at a time.
template <typename T, int RT>
__global__ void __launch_bounds__(256)
tt_eval_generic(const long long* __restrict__ table,
                const long long* __restrict__ pos, T* __restrict__ out,
                T* __restrict__ scratch, int* __restrict__ bad, int d, int r,
                long long M, bool staged_table) {
    constexpr int W = RT > 0 ? RT : 8;
    // the table in shared memory when the launch gave it room (48 KB: 877
    // sites), so that its reads do not queue with the cores' and positions'
    extern __shared__ __align__(16) long long staged[];
    if (staged_table) {
        for (int e = threadIdx.x; e < d * 7; e += blockDim.x) {
            staged[e] = __ldg(table + e);
        }
        __syncthreads();
        table = staged;
    }
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long m = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         m < M; m += stride) {
        T F[W];
        T* Fo = scratch;
        T* Fn = scratch + static_cast<long long>(r) * M;
        if constexpr (RT > 0) {
#pragma unroll
            for (int a = 0; a < RT; ++a) F[a] = a == 0 ? T(1) : T(0);
        } else {
            for (int a = 0; a < r; ++a) Fo[a * M + m] = a == 0 ? T(1) : T(0);
        }
        bool ok = true;
        for (int k = 0; k < d; ++k) {
            const long long* row = table + k * 7;
            const T* core = reinterpret_cast<const T*>(row[0]);
            const long long s0 = row[1], s1 = row[2], s2 = row[3];
            const int rl = static_cast<int>(row[4]);
            const long long n = row[5];
            const int rr = static_cast<int>(row[6]);
            const long long i = __ldg(pos + m * d + k);
            if (i < 0 || i >= n) {
                ok = false;
                break;
            }
            const T* slice = core + i * s1;
            if constexpr (RT > 0) {
                T G[RT];
#pragma unroll
                for (int b = 0; b < RT; ++b) G[b] = T(0);
#pragma unroll
                for (int a = 0; a < RT; ++a) {
                    if (a < rl) {
                        const T fa = F[a];
                        const T* ca = slice + a * s0;
#pragma unroll
                        for (int b = 0; b < RT; ++b) {
                            if (b < rr) {
                                G[b] = fma(fa, __ldg(ca + b * s2), G[b]);
                            }
                        }
                    }
                }
#pragma unroll
                for (int b = 0; b < RT; ++b) F[b] = G[b];
            } else {
                for (int b0 = 0; b0 < rr; b0 += W) {
#pragma unroll
                    for (int b = 0; b < W; ++b) F[b] = T(0);
                    for (int a = 0; a < rl; ++a) {
                        const T fa = Fo[a * M + m];
                        const T* ca = slice + a * s0 + b0 * s2;
#pragma unroll
                        for (int b = 0; b < W; ++b) {
                            if (b0 + b < rr) {
                                F[b] = fma(fa, __ldg(ca + b * s2), F[b]);
                            }
                        }
                    }
#pragma unroll
                    for (int b = 0; b < W; ++b) {
                        if (b0 + b < rr) Fn[(b0 + b) * M + m] = F[b];
                    }
                }
                T* t = Fo;
                Fo = Fn;
                Fn = t;
            }
        }
        if (ok) {
            out[m] = RT > 0 ? F[0] : Fo[m];
        } else {
            out[m] = quiet_nan<T>();
            atomicAdd(bad, 1);
        }
    }
}

template <typename T, int R, int THREADS, bool MERGE>
int launch_as(const Table* tab, const long long* pos, T* out, int* bad,
              long long M, int threads, int blocks, int smem,
              unsigned long long* stamps, cudaStream_t stream) {
    auto kernel = tt_eval_tables<T, R, THREADS, MERGE>;
    if (threads > THREADS) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, threads, smem, stream>>>(*tab, pos, out, bad, M, stamps);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Table* tab, const long long* pos, T* out, int* bad,
           long long M, int R, int threads, int blocks, int smem,
           unsigned long long* stamps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 8:
            return launch_as<T, 8, 1024, true>(tab, pos, out, bad, M, threads,
                                               blocks, smem, stamps, s);
        case 16:
            return launch_as<T, 16, 512, true>(tab, pos, out, bad, M, threads,
                                               blocks, smem, stamps, s);
        case 32:
            return launch_as<T, 32, 256, false>(tab, pos, out, bad, M, threads,
                                                blocks, smem, stamps, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename T>
int launch_generic(const long long* table, const long long* pos, T* out,
                   T* scratch, int* bad, int d, int r, long long M,
                   int blocks, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t bytes = static_cast<size_t>(d) * 7 * sizeof(long long);
    const bool staged = bytes <= 48 * 1024;
    const size_t smem = staged ? bytes : 0;
    if (r <= 8) {
        tt_eval_generic<T, 8><<<blocks, 256, smem, s>>>(
            table, pos, out, scratch, bad, d, r, M, staged);
    } else if (r <= 32) {
        tt_eval_generic<T, 32><<<blocks, 256, smem, s>>>(
            table, pos, out, scratch, bad, d, r, M, staged);
    } else {
        tt_eval_generic<T, 0><<<blocks, 256, smem, s>>>(
            table, pos, out, scratch, bad, d, r, M, staged);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values = TT(positions) by the plan in *tab (host memory, passed to the
// kernel by value), launched on `stream` of the current device: pos (M, d)
// int64 contiguous, out (M,), bad one int per block, written (not added to)
// by the launch: the block's measurements with an index outside its site's
// mode size.  R, threads,
// blocks and smem (bytes of dynamic shared memory) are the plan's.  stamps,
// if not null, takes 4 global-timer readings (ns) per block, by its thread
// 0: at the start, after staging, after the tables, after warp 0's last tile.
// Allocates nothing, does not synchronize; returns the launch's
// cudaGetLastError() code (0 on success).
extern "C" int xerus_tt_eval_f32(const void* tab, const long long* pos,
                                 float* out, int* bad, long long M, int R,
                                 int threads, int blocks, int smem,
                                 unsigned long long* stamps, void* stream) {
    return launch<float>(static_cast<const Table*>(tab), pos, out, bad, M, R,
                      threads, blocks, smem, stamps, stream);
}

extern "C" int xerus_tt_eval_f64(const void* tab, const long long* pos,
                                 double* out, int* bad, long long M, int R,
                                 int threads, int blocks, int smem,
                                 unsigned long long* stamps, void* stream) {
    return launch<double>(static_cast<const Table*>(tab), pos, out, bad, M, R,
                      threads, blocks, smem, stamps, stream);
}

// The device-memory route: table (d, 7) int64 on the device, r the largest
// rank, scratch 2 * r * M elements for r > 32 (else unused: the frontier
// stays in registers), `blocks` blocks of 256 threads.
extern "C" int xerus_tt_eval_generic_f32(const long long* table,
                                         const long long* pos, float* out,
                                         float* scratch, int* bad, int d,
                                         int r, long long M, int blocks,
                                         void* stream) {
    return launch_generic<float>(table, pos, out, scratch, bad, d, r, M,
                                 blocks, stream);
}

extern "C" int xerus_tt_eval_generic_f64(const long long* table,
                                         const long long* pos, double* out,
                                         double* scratch, int* bad, int d,
                                         int r, long long M, int blocks,
                                         void* stream) {
    return launch_generic<double>(table, pos, out, scratch, bad, d, r, M,
                                  blocks, stream);
}
