// A yardstick for the NeRF kernels, launched only by chip_smoke.py: the
// card's rate of random float4 gathers and of random float4 atomicAdds over
// a buffer of n float4 (a NeRF grid's voxels: 128^3 of them are 33.5 MB and
// stay in the 50 MB L2).  Build as the other libraries:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libuivr_probe.so l2_probe.cu
//
// It replaces no TPU kernel.  Each thread runs `rounds` rounds of 8
// independent accesses at indices from a per-thread generator (no index
// array: the buffer is the only traffic), as a NeRF query reads 8 corners;
// the gathers' sum is stored so that no load is dropped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ inline uint32_t next_index(uint32_t& x, uint32_t n) {
  x = x * 1664525u + 1013904223u;                 // LCG step
  return __umulhi(x ^ (x >> 15), n);              // into [0, n)
}

__global__ void __launch_bounds__(kThreads) l2_gather_kernel(const float4* buf, uint32_t n,
                                                            int rounds, uint32_t seed,
                                                            float* out) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x = seed ^ (t * 2654435761u);
  float acc = 0.0f;
  for (int r = 0; r < rounds; ++r) {
    float4 v[8];
    for (int k = 0; k < 8; ++k) v[k] = buf[next_index(x, n)];
    for (int k = 0; k < 8; ++k) acc += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
  out[t] = acc;
}

__global__ void __launch_bounds__(kThreads) l2_atomic_kernel(float4* buf, uint32_t n,
                                                            int rounds, uint32_t seed) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x = seed ^ (t * 2654435761u);
  const float4 one = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  for (int r = 0; r < rounds; ++r)
    for (int k = 0; k < 8; ++k) atomicAdd(buf + next_index(x, n), one);
}

}  // namespace

extern "C" {

// blocks x 128 threads x rounds x 8 gathers; out: (blocks x 128) floats.
int l2_gather_launch(const void* buf, int64_t n, int rounds, int blocks, void* out,
                     void* stream) {
  l2_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)buf, (uint32_t)n, rounds, 12345u, (float*)out);
  return (int)cudaGetLastError();
}

// blocks x 128 threads x rounds x 8 float4 atomicAdds into buf.
int l2_atomic_launch(void* buf, int64_t n, int rounds, int blocks, void* stream) {
  l2_atomic_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((float4*)buf, (uint32_t)n,
                                                                  rounds, 54321u);
  return (int)cudaGetLastError();
}

}  // extern "C"
