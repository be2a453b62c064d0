// Hopper kernel of the path-replay adjoint, with a plain C launcher for
// ctypes.  Build (sm_90a, no contraction beyond explicit fmaf):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libuivr_adjoint.so volpath_adjoint.cu
//
// volpath_adjoint_kernel replaces uivr_tpu/ops/volpath_step.py:_step_kernel
// with adjoint=True (:673-800) and the host step _make_adj_step (:1603-1696),
// the XLA row scatter-adds of the cotangents there (:1650-1690), and the
// adjoint half of the persistent wavefront (sample_adjoint_persistent
// :1811-2078: per-ray keying, reservoir collection), and the subcell
// classification (K6) the adjoint step runs on its MAIN and SHADOW events
// (never on REPLAY, whose cotangent needs sigma at every collision).  One thread runs one
// ray's MAIN / SHADOW / REPLAY walks to completion (at most 3 * max_steps
// events), keyed by its ray index, and writes its DRT reservoir at the end:
// there is no eviction machinery.
//
// What bounds it: as in the primal, each tracking event reads 8 scattered
// float4 corners (128 B) and one majorant cell; on top, every real
// collision adds 32 float atomics (128 B) into the gradient grids, every
// transmittance-gradient sample and every replay collision 8 (32 B).  The
// atomics land on few hot voxels of a dense medium, so contention and the
// latency of the scattered reads bound it, not arithmetic.  The design keeps
// the whole state (about 30 floats beyond the primal lane's) in registers,
// shares the tracking step with the primal lane (trace_lane<AdjointHooks>),
// and adds each corner directly with atomicAdd instead of staging rows.
// Warp-aggregated or shared-memory atomics and persistent scheduling are
// later work.
#include <cuda_runtime.h>

#include "volpath_adjoint.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
volpath_adjoint_kernel(const uivr::AdjParams a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.P.n) uivr::adjoint_lane(a, i);
}

}  // namespace

extern "C" {

int volpath_adjoint_launch(const uivr::AdjParams* params, void* stream) {
  const int64_t n = params->P.n;
  if (n > 0) {
    volpath_adjoint_kernel<<<(unsigned int)((n + kThreads - 1) / kThreads), kThreads, 0,
                             (cudaStream_t)stream>>>(*params);
  }
  return (int)cudaGetLastError();
}

int adj_params_size() { return (int)sizeof(uivr::AdjParams); }

}  // extern "C"
