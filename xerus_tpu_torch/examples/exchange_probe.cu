// Exchange probe for K2's float64 design (not a kernel of any path).
//
// A Newton-Schulz step of gemm_exact.cu's f64 cluster route moves about
// 140 KB per CTA between the 16 CTAs of its cluster.  What that costs
// decides the step's floor, so this probe times one 16-CTA cluster of 256
// threads per CTA repeating `iters` times:
//   mode 0: each CTA pushes `push` doubles into the 16 CTAs' shared memory
//           (16-byte stores, destinations staggered by rank, as the kernel
//           pushes), then one cluster barrier;
//   mode 1: each CTA writes `push` doubles to global memory, a cluster
//           barrier, reads `pull` doubles of the other CTAs' parts through
//           L2 (ld.global.cg, 16 bytes), a cluster barrier; reads that miss
//           the values just written are counted.
// The caller times the launch with CUDA events.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;
constexpr int kCtas = 16, kThreads = 256, kSlots = 16384;

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 1)
probe(int mode, int iters, int push, int pull, double* ws,
      unsigned long long* stale) {
    extern __shared__ double sm[];
    cg::cluster_group cl = cg::this_cluster();
    const int cr = (int)cl.block_rank();
    unsigned long long miss = 0;
    for (int it = 0; it < iters; ++it) {
        if (mode == 0) {
            for (int e = threadIdx.x; 2 * e < push; e += kThreads) {
                double* dst = cl.map_shared_rank(sm + (2 * e) % kSlots,
                                                 (e + cr) % kCtas);
                *reinterpret_cast<double2*>(dst) = make_double2(it, e);
            }
            cl.sync();
            continue;
        }
        double* buf = ws + (size_t)(it & 1) * kCtas * push;
        for (int e = 2 * threadIdx.x; e < push; e += 2 * kThreads)
            *reinterpret_cast<double2*>(buf + (size_t)cr * push + e) =
                make_double2(it * 1e6 + cr * 1e4 + e, 0.0);
        cl.sync();
        for (int e = 2 * threadIdx.x; e < pull; e += 2 * kThreads) {
            const int src = (e / push + cr + 1) % kCtas, off = e % push;
            const double2 v = __ldcg(reinterpret_cast<const double2*>(
                buf + (size_t)src * push + off));
            miss += v.x != it * 1e6 + src * 1e4 + off;
            sm[(e / 2) % kSlots] = v.x;
        }
        cl.sync();
    }
    if (miss) atomicAdd(stale, miss);
}

}  // namespace

// Launches the probe once on `stream`; returns the CUDA error code.
// `ws` holds 2 * 16 * push doubles (mode 1); `stale` one counter.
extern "C" int xerus_exchange_probe(int mode, int iters, int push, int pull,
                                    void* ws, void* stale, void* stream) {
    const size_t bytes = kSlots * sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(
        probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            probe, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    probe<<<kCtas, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        mode, iters, push, pull, static_cast<double*>(ws),
        static_cast<unsigned long long*>(stale));
    return (int)cudaGetLastError();
}
