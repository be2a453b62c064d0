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
// path and the sigma/albedo scatter (:720-728).  The recursive path itself
// runs volpath_primal_state_kernel.  One thread per reservoir vertex; the
// wavefront counter's maxima K_A and K_B pass between launches in device
// memory (volpath_drt.cuh).
//
// What bounds them: the walks are the same divergent, latency-bound
// majorant tracking as the primal (one 128-B corner read per collision plus
// a majorant cell per step), and every draw costs two TEA hashes (4 + 8
// rounds) instead of one.  The design runs each walk to its end in
// registers instead of one launch per majorant collision of the longest
// walk (the plain version's schedule), so the cost is the sum of the walks,
// not the longest walk times the wavefront.
#include <cuda_runtime.h>

#include "volpath_drt.cuh"

namespace {

constexpr int kThreads = 128;

unsigned int n_blocks(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

__global__ void __launch_bounds__(kThreads) drt_walk_kernel(const uivr::DrtParams d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < d.P.n) uivr::drt_walk_lane(d, i);
}

__global__ void __launch_bounds__(kThreads) drt_nee_kernel(const uivr::DrtParams d) {
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

}  // namespace

extern "C" {

// which: 0 walk, 1 nee, 2 phase, 3 scatter
int volpath_drt_launch(const uivr::DrtParams* params, int which, int use_drt_mis,
                       void* stream) {
  const int64_t n = params->P.n;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    switch (which) {
      case 0: drt_walk_kernel<<<n_blocks(n), kThreads, 0, s>>>(*params); break;
      case 1: drt_nee_kernel<<<n_blocks(n), kThreads, 0, s>>>(*params); break;
      case 2: drt_phase_kernel<<<n_blocks(n), kThreads, 0, s>>>(*params); break;
      case 3: drt_scatter_kernel<<<n_blocks(n), kThreads, 0, s>>>(*params, use_drt_mis); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

int drt_params_size() { return (int)sizeof(uivr::DrtParams); }

}  // extern "C"
