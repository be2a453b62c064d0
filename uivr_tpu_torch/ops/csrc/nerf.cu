// Hopper kernels of the NeRF bootstrap stage, with plain C launchers for
// ctypes.  Build (sm_90a, no contraction beyond explicit fmaf):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libuivr_nerf.so nerf.cu
//
// They replace no TPU kernel: the reference runs the march as XLA
// (uivr_tpu/integrators/nerf.py:61 sample_primal, :95 sample_adjoint, a
// 128-step fori_loop over the wavefront).  In torch ops that loop is
// several thousand small launches per pass, three passes a training step
// (forward, replay, adjoint), so each pass is one kernel here.
//
// What bounds them: every step reads the 8 float4 corners (128 B) of the
// interleaved [sigma, emission] grid at a scattered point, and the adjoint
// adds a float4 into each of the 8 corners of the gradient grid.  The grid
// of a 128^3 stage (33.5 MB) stays in the 50 MB L2, so the reads' latency
// and the atomics' contention on the voxels neighbouring rays share bound
// them, not device-memory bytes or arithmetic.  The design is the simplest
// that is right: one thread per ray, 128 steps in registers, no shared
// memory; rays that miss the medium write the background and skip the
// march.
#include <cuda_runtime.h>

#include "nerf.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) nerf_primal_kernel(const uivr::NerfParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.P.n) uivr::nerf_primal_lane(p, i);
}

__global__ void __launch_bounds__(kThreads) nerf_adjoint_kernel(const uivr::NerfParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.P.n) uivr::nerf_adjoint_lane(p, i);
}

unsigned int grid_of(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// The primal march: P.L (n, 3) and valid (n,).
int nerf_primal_launch(const uivr::NerfParams* params, void* stream) {
  if (params->P.n > 0)
    nerf_primal_kernel<<<grid_of(params->P.n), kThreads, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

// The adjoint march: adds into g_grid, which the caller zeroes.
int nerf_adjoint_launch(const uivr::NerfParams* params, void* stream) {
  if (params->P.n > 0)
    nerf_adjoint_kernel<<<grid_of(params->P.n), kThreads, 0, (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

int nerf_params_size() { return (int)sizeof(uivr::NerfParams); }

}  // extern "C"
