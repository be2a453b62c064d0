// Hopper kernels of the delayed DRT term, with plain C launchers for ctypes.
// Build (sm_90a, no contraction beyond explicit fmaf):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libuivr_drt.so volpath_drt.cu
//
// They replace uivr_tpu/integrators/volpath_flat.py:_drt_backward_flat
// (:672-729), which the TPU runs as XLA wavefront loops around the Pallas
// kernel: tracking/trackers.py:drt_distance (:201-254), the NEE of
// integrators/volpathsimple.py:_nee_primal (:95) with its ratio-tracking
// transmittance (trackers.py:138-198), the phase sampling of the recursive
// path, the recursive path itself (sample_primal_pallas with path_state)
// and the sigma/albedo scatter (:720-728).  The wavefront counter's maxima
// K_A and K_B pass between launches in device memory (volpath_drt.cuh).
//
// What bounds them: the walks are the same divergent, latency-bound
// majorant tracking as the primal (one 128-B corner read per collision plus
// a majorant cell per step), and every draw costs two TEA hashes (4 + 8
// rounds) instead of one.  The design runs each walk to its end in
// registers instead of one launch per majorant collision of the longest
// walk (the plain version's schedule), so the cost is the sum of the walks,
// not the longest walk times the wavefront.
//
// The walking kernels are persistent (persistent.cuh): of a janga truth
// step's 524,288 vertices about half are inactive and end at once, and the
// walks of the rest are short with a long tail, so one thread per vertex
// left most lanes of a warp idle; here the grid fills the card once and a
// lane takes the next vertex from a work counter as soon as its walk ends,
// and a warp's lanes that finish together raise K_A or K_B with one
// atomicMax.
//
// drt_walk_kernel (DrtWalkTask): a trip is a majorant cell fetch, then at
// a collision 8 corner fetches, beside two draws of 12 TEA rounds each.
// The 4-round pre-hash of a draw depends on its counter only, so each
// block hashes the first kDrtPreTrips trips' pre-hashes once into shared
// memory (1 KB) and a trip hashes only against its vertex (8 rounds a
// draw); one probe on an H100 put the saving at about 4%, no more than
// that probe's own spread (PERF.md).  What bounds
// it is the latency of the fetches more than the throughput of the
// hashes: fewer lanes made it slower at once.  Its grid is occupancy x
// SMs (68 registers, 7 blocks a SM: 118,272 lanes), the fastest of three
// on an H100 at 700 W: on truth-shaped reservoirs of janga-smoke,
// dust-devil and janga XML, grids of 1/2 and 1/4 of it took 0.390 / 0.548
// / 0.677 and 0.636 / 0.792 / 1.167 ms where it took 0.32 / 0.52-0.53 /
// 0.61 (in turns); a bound of 8 blocks a SM (64 registers) moved it by
// less than the noise (PERF.md).
//
// drt_scatter_kernel: per vertex that found a point, the factor from the
// recursive path's radiance (volpath_primal_state_kernel's) and the sigma
// and albedo the walk kept at the point (no corner fetch), then 32 atomic
// adds to its 8 corners; consecutive vertices scatter to nearby voxels, so
// a warp's atomics tend to share sectors.
//
// For comparison only (nothing on the main path launches them): the
// one-thread-per-vertex walk and NEE kernels, each lane hashing every draw
// in full and raising its maximum alone (which = 5 and 4).
#include <cuda_runtime.h>

#include "volpath_drt.cuh"
#include "persistent.cuh"

namespace {

constexpr int kThreads = 128;

unsigned int n_blocks(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

__global__ void __launch_bounds__(kThreads)
drt_walk_kernel(const uivr::DrtParams d, unsigned long long* counter, long long* util) {
  __shared__ uint32_t pre[uivr::kDrtPreDims];
  for (uint32_t j = threadIdx.x; j < uivr::kDrtPreDims; j += blockDim.x)
    pre[j] = uivr::wavefront_pre(d.drt_seed, j);
  __syncthreads();
  uivr::DrtWalkTask t(d, pre, uivr::kDrtPreDims);
  uivr::run_persistent(t, d.P.n, counter, util);
}

__global__ void __launch_bounds__(kThreads) drt_walk_direct_kernel(const uivr::DrtParams d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < d.P.n) uivr::drt_walk_lane(d, i);
}

__global__ void __launch_bounds__(kThreads)
drt_nee_kernel(const uivr::DrtParams d, unsigned long long* counter) {
  uivr::DrtNeeTask t(d);
  uivr::run_persistent(t, d.P.n, counter, nullptr);
}

__global__ void __launch_bounds__(kThreads) drt_nee_direct_kernel(const uivr::DrtParams d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < d.P.n) uivr::drt_nee_lane(d, i);
}

__global__ void __launch_bounds__(kThreads) drt_phase_kernel(const uivr::DrtParams d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < d.P.n) uivr::drt_phase_lane(d, i);
}

__global__ void __launch_bounds__(kThreads)
drt_scatter_kernel(const uivr::DrtParams d, int use_drt_mis) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < d.P.n) uivr::drt_scatter_lane(d, i, use_drt_mis);
}

// zero the work counter on the stream
int zero(unsigned long long* counter, cudaStream_t s) {
  return (int)cudaMemsetAsync(counter, 0, sizeof(unsigned long long), s);
}

int launch_walk(const uivr::DrtParams& d, unsigned long long* counter, long long* util,
                cudaStream_t s) {
  static int per_sm = 0;
  if (int e = zero(counter, s)) return e;
  drt_walk_kernel<<<uivr::persistent_grid(drt_walk_kernel, kThreads, d.P.n, per_sm), kThreads,
                    0, s>>>(d, counter, util);
  return (int)cudaGetLastError();
}

int launch_nee(const uivr::DrtParams& d, unsigned long long* counter, cudaStream_t s) {
  static int per_sm = 0;
  if (int e = zero(counter, s)) return e;
  drt_nee_kernel<<<uivr::persistent_grid(drt_nee_kernel, kThreads, d.P.n, per_sm), kThreads, 0,
                   s>>>(d, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// which: 0 walk (persistent), 1 nee (persistent), 2 phase, 3 scatter, 4
// nee and 5 walk one thread per vertex (comparison only).  counter: 8
// bytes of scratch for the persistent kernels, zeroed here on the stream;
// util: the walk's (warps, 2) int64 utilization counters, or null.
int volpath_drt_launch(const uivr::DrtParams* params, int which, int use_drt_mis,
                       void* counter, void* util, void* stream) {
  const int64_t n = params->P.n;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)counter;
  if (n > 0) {
    switch (which) {
      case 0: return launch_walk(*params, c, (long long*)util, s);
      case 1: return launch_nee(*params, c, s);
      case 2: drt_phase_kernel<<<n_blocks(n), kThreads, 0, s>>>(*params); break;
      case 3: drt_scatter_kernel<<<n_blocks(n), kThreads, 0, s>>>(*params, use_drt_mis); break;
      case 4: drt_nee_direct_kernel<<<n_blocks(n), kThreads, 0, s>>>(*params); break;
      case 5: drt_walk_direct_kernel<<<n_blocks(n), kThreads, 0, s>>>(*params); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

int drt_params_size() { return (int)sizeof(uivr::DrtParams); }

}  // extern "C"
