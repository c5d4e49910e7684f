// Shared-memory load probe for K3's design (not a kernel of any path).
//
// K3 (tt_eval.cu) gives every thread of a warp one measurement, and at each
// (row, column pair) of a site the warp's 32 threads read from at most n
// different core slices.  What such a load costs decides the kernel's
// floor, so this probe times it: one block of `threads` threads per SM,
// every warp issuing `iters` x 16 loads of `width` bits whose addresses
// follow one of four patterns, and the block's clock64() span written out.
//   pattern 0: all lanes one address (pure broadcast)
//   pattern 1: lane & 3 picks one of 4 slices 33 x 16 bytes apart, so the
//              4 addresses lie in different banks
//   pattern 2: the 4 slices 512 bytes apart: same banks, a 4-way conflict
//   pattern 3: every lane its own consecutive address
// cycles x SMs-worth is read as cycles per warp-load on one SM:
// cycles / (iters * 16 * warps per block).

#include <cuda_runtime.h>

namespace {

template <int W>
__device__ __forceinline__ unsigned load_word(unsigned addr);

template <>
__device__ __forceinline__ unsigned load_word<64>(unsigned addr) {
    unsigned x, y;
    asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(x), "=r"(y) : "r"(addr));
    return x;
}

template <>
__device__ __forceinline__ unsigned load_word<128>(unsigned addr) {
    unsigned x, y, z, w;
    asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(x), "=r"(y), "=r"(z), "=r"(w) : "r"(addr));
    return x;
}

template <int W>
__global__ void __launch_bounds__(1024)
probe_kernel(long long* cycles, unsigned* sink, int pattern, int iters) {
    extern __shared__ __align__(16) unsigned char raw[];
    unsigned* words = reinterpret_cast<unsigned*>(raw);
    for (int e = threadIdx.x; e < 4096; e += blockDim.x) words[e] = e;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    unsigned off = 0;
    if (pattern == 1) off = (lane & 3) * 33 * 16;
    if (pattern == 2) off = (lane & 3) * 512;
    if (pattern == 3) off = lane * (W / 8);
    const unsigned base =
        static_cast<unsigned>(__cvta_generic_to_shared(raw)) + off;
    unsigned acc = 0;
    __syncthreads();
    const long long t0 = clock64();
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            // 16 loads inside one 256-byte (W=128) or 128-byte window
            acc ^= load_word<W>(base + j * (W / 8) * (pattern == 3 ? 32 : 1));
        }
    }
    __syncthreads();
    const long long t1 = clock64();
    if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
    if (acc == 0x9e3779b9u) sink[0] = acc;   // keeps the loads' results live
}

}  // namespace

// One block of `threads` threads per SM; cycles[block] = the block's span.
// width is 64 or 128, pattern 0..3 as in the header.  Returns the launch's
// cudaGetLastError() code.
extern "C" int xerus_smem_probe(int width, int pattern, int iters, int threads,
                                int blocks, long long* cycles, unsigned* sink,
                                void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t shmem = 32 * 1024;
    if (width == 64) {
        probe_kernel<64><<<blocks, threads, shmem, s>>>(cycles, sink, pattern,
                                                        iters);
    } else {
        probe_kernel<128><<<blocks, threads, shmem, s>>>(cycles, sink, pattern,
                                                         iters);
    }
    return static_cast<int>(cudaGetLastError());
}
