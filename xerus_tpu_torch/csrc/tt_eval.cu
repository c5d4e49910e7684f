// K3: evaluate a tensor train at M index tuples on Hopper.
//
// Replaces the Pallas TPU kernel xerus_tpu/ops/pallas_tt_eval.py
// (_tt_eval_kernel, entry tt_eval_at_points_pallas).  Input: the cores
// zero-padded to one (d, r, n, r) stack (ops/stacking.py pad_cores) and
// the positions, an (M, d) row-major int64 array.  Output: values[m] =
// C_0[:, i_m0, :] C_1[:, i_m1, :] ... C_{d-1}[:, i_m(d-1), :], read from
// frontier slot 0: the frontier F (length r) starts at e_0 and at each site
// becomes F <- F C_k[:, i_mk, :].  Callers: the measurement layer
// (measure, test) and IHT, through ops/tt_eval.py tt_eval_at_points.
//
// What bounds it: the gathers.  At the slice's shape (d=10, r=8, n=4, f64)
// a measurement does d r^2 = 640 FMAs, each on one element of a randomly
// selected (r, r) slice; the stack is 20 KB, so the work is loads from
// on-chip memory, not device-memory traffic (positions 80 B and one value
// per measurement).  The TPU kernel turned the gather into a one-hot
// matmul over ranks padded to 128 lanes, because the TPU has no fast
// scattered loads; here the slice is read directly and nothing is padded
// past the largest rank:
// - one thread per measurement, in a grid-stride loop over a grid capped
//   at 8 blocks per SM, so each block fills its shared-memory copy of the
//   stack once and then reuses it;
// - the stack goes to shared memory when it fits the default 48 KB of
//   dynamic shared memory, otherwise it is read through the read-only
//   cache (__ldg);
// - the frontier sits in registers for r <= 32 (compile-time bounds 8
//   and 32); for larger r the same kernel runs a rank-tiled loop: 32
//   outputs at a time in registers, the frontier in a (2, r, M) scratch in
//   device memory, laid out so that neighbouring threads read neighbouring
//   addresses.  There is no rank limit and no plain-version route.
// - f64 stays f64 (the TPU ran f64 input in f32); f32 and f64 are two
//   instantiations.
// Safety: an index outside [0, n) of the padded stack is never
// dereferenced.  The measurement's value becomes NaN and *bad is
// incremented (an integer atomic, so the count is exact); the wrapper
// reads *bad and raises.  Indices in [n_k, n) of a ragged site read the
// zero padding; the measurement sets validate positions against the true
// mode sizes on the host before they reach the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr long long kSmemStackBytes = 48 * 1024;
constexpr int kSmallRanks = 8;   // register frontier, r <= 8
constexpr int kRegRanks = 32;    // register frontier, r <= 32; tiled above

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
    return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
    return __longlong_as_double(0x7ff8000000000000LL);
}

template <bool kSmem, typename T>
__device__ __forceinline__ T load(const T* p) {
    if constexpr (kSmem) {
        return *p;
    } else {
        return __ldg(p);
    }
}

// RT: frontier entries a thread holds in registers.  r <= RT: the whole
// frontier lives in registers.  r > RT: tiles of RT outputs, frontier in
// `scratch` (two (r, M) buffers).
template <typename T, int RT, bool kSmem>
__global__ void __launch_bounds__(kThreads)
tt_eval_kernel(const T* __restrict__ stack, const long long* __restrict__ pos,
               T* __restrict__ out, T* __restrict__ scratch,
               int* __restrict__ bad, int d, int r, int n, long long M) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const long long site = static_cast<long long>(r) * n * r;
    const long long row = static_cast<long long>(n) * r;
    const T* S = stack;
    if constexpr (kSmem) {
        T* smem = reinterpret_cast<T*>(smem_raw);
        const long long total = site * d;
        for (long long e = threadIdx.x; e < total; e += blockDim.x) {
            smem[e] = __ldg(stack + e);
        }
        __syncthreads();
        S = smem;
    }
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long m = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         m < M; m += stride) {
        const long long* pm = pos + m * d;
        bool ok = true;
        T value;
        if (r <= RT) {
            T F[RT];
#pragma unroll
            for (int a = 0; a < RT; ++a) F[a] = (a == 0) ? T(1) : T(0);
            for (int k = 0; k < d; ++k) {
                const long long i = __ldg(pm + k);
                if (i < 0 || i >= n) {
                    ok = false;
                    break;
                }
                const T* C = S + k * site + i * r;   // C[a * row + b]
                T G[RT];
#pragma unroll
                for (int b = 0; b < RT; ++b) G[b] = T(0);
#pragma unroll
                for (int a = 0; a < RT; ++a) {
                    if (a < r) {
                        const T fa = F[a];
                        const T* Ca = C + a * row;
#pragma unroll
                        for (int b = 0; b < RT; ++b) {
                            if (b < r) G[b] = fma(fa, load<kSmem>(Ca + b), G[b]);
                        }
                    }
                }
#pragma unroll
                for (int b = 0; b < RT; ++b) F[b] = G[b];
            }
            value = F[0];
        } else {
            T* Fo = scratch;
            T* Fn = scratch + static_cast<long long>(r) * M;
            for (int a = 0; a < r; ++a) Fo[a * M + m] = (a == 0) ? T(1) : T(0);
            for (int k = 0; k < d; ++k) {
                const long long i = __ldg(pm + k);
                if (i < 0 || i >= n) {
                    ok = false;
                    break;
                }
                const T* C = S + k * site + i * r;
                for (int b0 = 0; b0 < r; b0 += RT) {
                    T G[RT];
#pragma unroll
                    for (int b = 0; b < RT; ++b) G[b] = T(0);
                    for (int a = 0; a < r; ++a) {
                        const T fa = Fo[a * M + m];
                        const T* Ca = C + a * row + b0;
#pragma unroll
                        for (int b = 0; b < RT; ++b) {
                            if (b0 + b < r) {
                                G[b] = fma(fa, load<kSmem>(Ca + b), G[b]);
                            }
                        }
                    }
#pragma unroll
                    for (int b = 0; b < RT; ++b) {
                        if (b0 + b < r) Fn[(b0 + b) * M + m] = G[b];
                    }
                }
                T* t = Fo;
                Fo = Fn;
                Fn = t;
            }
            value = Fo[m];
        }
        if (ok) {
            out[m] = value;
        } else {
            out[m] = quiet_nan<T>();
            atomicAdd(bad, 1);
        }
    }
}

template <typename T, int RT>
void launch_rt(bool smem, int blocks, size_t shmem, cudaStream_t stream,
               const T* stack, const long long* pos, T* out, T* scratch,
               int* bad, int d, int r, int n, long long M) {
    if (smem) {
        tt_eval_kernel<T, RT, true><<<blocks, kThreads, shmem, stream>>>(
            stack, pos, out, scratch, bad, d, r, n, M);
    } else {
        tt_eval_kernel<T, RT, false><<<blocks, kThreads, 0, stream>>>(
            stack, pos, out, scratch, bad, d, r, n, M);
    }
}

template <typename T>
int launch(const T* stack, const long long* pos, T* out, T* scratch, int* bad,
           int d, int r, int n, long long M, void* stream) {
    int dev = 0;
    int sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (M + kThreads - 1) / kThreads;
    const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;   // M = 0 still launches; no thread works
    const long long bytes = static_cast<long long>(d) * r * n * r * sizeof(T);
    const bool smem = bytes <= kSmemStackBytes;
    const size_t shmem = smem ? static_cast<size_t>(bytes) : 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (r <= kSmallRanks) {
        launch_rt<T, kSmallRanks>(smem, static_cast<int>(blocks), shmem, s,
                                  stack, pos, out, scratch, bad, d, r, n, M);
    } else {
        launch_rt<T, kRegRanks>(smem, static_cast<int>(blocks), shmem, s,
                                stack, pos, out, scratch, bad, d, r, n, M);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Elements of frontier scratch one launch needs: 0 while the frontier fits
// in registers (r <= 32), else two (r, M) buffers.
extern "C" long long xerus_tt_eval_scratch_elems(int r, long long M) {
    return r > kRegRanks ? 2LL * r * M : 0LL;
}

// values = TT(positions) for contiguous buffers on the current device,
// launched on `stream`: stack (d, r, n, r), pos (M, d) int64, out (M,),
// scratch as xerus_tt_eval_scratch_elems says (may be null when that is 0),
// bad one int, zeroed by the caller, counting indices outside [0, n).
// Allocates nothing, does not synchronize; returns the launch's
// cudaGetLastError() code (0 on success).
extern "C" int xerus_tt_eval_f32(const float* stack, const long long* pos,
                                 float* out, float* scratch, int* bad, int d,
                                 int r, int n, long long M, void* stream) {
    return launch<float>(stack, pos, out, scratch, bad, d, r, n, M, stream);
}

extern "C" int xerus_tt_eval_f64(const double* stack, const long long* pos,
                                 double* out, double* scratch, int* bad, int d,
                                 int r, int n, long long M, void* stream) {
    return launch<double>(stack, pos, out, scratch, bad, d, r, n, M, stream);
}
