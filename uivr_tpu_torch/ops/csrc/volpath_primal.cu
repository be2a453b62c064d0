// Hopper kernels of the primal volumetric render, with plain C launchers
// for ctypes.  Build (sm_90a, no contraction beyond explicit fmaf):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libuivr_primal.so volpath_primal.cu
//
// volpath_primal_kernel replaces uivr_tpu/ops/volpath_step.py:_step_kernel
// (adjoint=False, k_cand=1; constant-emitter and envmap NEE branches, the
// subcell classification of PRE :892-907 (K6), plus the escape MIS of
// _finish) together with the persistent/compacted host loops around it.
// The in-kernel escape (:908-950) and the cross_steps unroll need no
// counterpart: a lane here resolves escapes and crossings in its own loop.  One thread traces one ray to completion, keyed by its
// ray index, so a lane walks the same path as in the plain twin.
//
// What bounds it: every tracking event reads the 8 float4 corners of the
// sigma+albedo grid (128 B) at a data-dependent point, plus one majorant
// cell; NEE setups read one alias row and one radiance row.  Those reads
// are scattered and divergent across a warp, so the kernel is bound by
// memory latency and by the bytes each event pulls through L2, not by
// arithmetic.  The design keeps all per-ray state in registers for the
// whole path (no state planes in device memory, unlike the TPU kernel's
// per-event round trips), reads each corner as one 16-byte load, and skips
// the grid read for events that cannot collide.  K6 skips it also for the
// candidates that the subcell bound table (16 KB at 16^3, read from global
// memory, mostly from L1/L2) decides: a MAIN candidate with
// u * sigma_maj >= hi is null, a SHADOW candidate in a cell with hi == 0
// passes with ratio 1.  Persistent scheduling, shared-memory majorants and
// subcell tables, and warp-level compaction are later work.
//
// volpath_primal_state_kernel is the same lane started from a PathState
// (K2's path_state entry): the recursive detached Li of the delayed DRT term
// (uivr_tpu/integrators/volpath_flat.py:712-718, sample_primal_pallas with
// path_state).
//
// tea_kernel (K1) exposes the inlined TEA hash for a bit-exact check.
#include <cuda_runtime.h>

#include "volpath_lane.cuh"

namespace {

__global__ void __launch_bounds__(128)
volpath_primal_kernel(const uivr::PrimalParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) uivr::primal_lane(p, i, false);
}

__global__ void __launch_bounds__(128)
volpath_primal_state_kernel(const uivr::PrimalParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) uivr::primal_lane(p, i, true);
}

__global__ void tea_kernel(const uint32_t* __restrict__ v0,
                           const uint32_t* __restrict__ v1,
                           uint32_t* __restrict__ o0, uint32_t* __restrict__ o1,
                           int64_t n, int rounds) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a = v0[i], b = v1[i];
  uivr::tea(a, b, rounds);
  o0[i] = a;
  o1[i] = b;
}

constexpr int kThreads = 128;

unsigned int n_blocks(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int volpath_primal_launch(const uivr::PrimalParams* params, void* stream) {
  if (params->n > 0) {
    volpath_primal_kernel<<<n_blocks(params->n), kThreads, 0,
                            (cudaStream_t)stream>>>(*params);
  }
  return (int)cudaGetLastError();
}

int volpath_primal_state_launch(const uivr::PrimalParams* params, void* stream) {
  if (params->n > 0) {
    volpath_primal_state_kernel<<<n_blocks(params->n), kThreads, 0,
                                  (cudaStream_t)stream>>>(*params);
  }
  return (int)cudaGetLastError();
}

int tea_launch(const void* v0, const void* v1, void* o0, void* o1, int64_t n,
               int rounds, void* stream) {
  if (n > 0) {
    tea_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)v0, (const uint32_t*)v1, (uint32_t*)o0, (uint32_t*)o1,
        n, rounds);
  }
  return (int)cudaGetLastError();
}

const char* uivr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int primal_params_size() { return (int)sizeof(uivr::PrimalParams); }

}  // extern "C"
