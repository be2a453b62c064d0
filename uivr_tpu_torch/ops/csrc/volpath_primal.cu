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
// counterpart: a lane here resolves escapes and crossings in its own loop.
// A lane traces one ray to completion, keyed by its ray index, so it walks
// the same path as in the plain twin.
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
// passes with ratio 1.
//
// The kernel is persistent (persistent.cuh): the grid fills the card once
// (occupancy x SMs, taken once per library load), and each lane takes rays
// from a work counter that the launcher zeroes, a new one as soon as its
// ray ends, so a warp no longer waits on its longest path while its other
// lanes idle (lane utilization, the busy share of a warp's lane-iterations,
// is 0.17 one ray per thread on janga-smoke's training forward, 0.48
// persistent).  The minimum-blocks bound UIVR_MIN_BLOCKS caps the registers
// at 65536 / (128 B) a thread: B = 5 (96 registers, no spills) ran a janga
// training forward chunk 9% faster than B = 4 (115) on an H100; B = 6
// (80, 120 B spilled) 13%, B = 3 as B = 4 (PERF.md; `chip_smoke.py
// --sweep` builds and times each B).  A block that kept the majorant
// supergrid and the subcell table in shared memory saved nothing
// measurable, nor did a warp that waited for 8 or 16 idle lanes before
// it refilled (PERF.md), so a lane refills as soon as its ray ends and
// every table is read from global memory.
//
// volpath_primal_direct_launch keeps the one-ray-per-thread kernels, for
// comparison only: nothing on the main path launches them.
//
// volpath_primal_k_kernel<KMAX> is the primal lane with K-candidate batches
// (K7, k_cand in 2..KMAX; instantiated for KMAX 2, 4 and 8), which replaces
// the reference's k_cand > 1 specialisation (_step_kernel POST phase 0
// :366-432, PRE :846-940) and its K-row sigma gather (_make_step
// :1277-1291).  Its bound is the same as K2's: the batch only reorders the
// fetches, and adds those of the candidates past a terminal event.  The
// batch goes at the latency of one dependent 128-B corner fetch per event:
// its fetches are issued back to back, up to KMAX x 8 16-B loads in flight
// per lane, before any of them is used.  It runs on the persistent
// scheduler (PrimalKTask: one dispatch, lane_step_k, per warp iteration),
// its loads in registers under a minimum-blocks bound per instantiation
// (kK7MinBlocks) that spills: 72 / 96 / 128 registers, 570 / 466 / 556 B
// of spill stores at K = 2 / 4 / 8, which keeps 20-28 warps a SM.  On an
// H100 (700 W, janga-smoke's 2^20-ray render chunk; PERF.md) that ran
// 13.5-14.0, 15.6-16.2 and 21.2 ms, faster than a variant that issued the
// loads as cp.async copies into a per-lane shared-memory slab (KMAX x
// 128 B a thread, no register in flight, 7 to 14 warps a SM): 14.3, 18.7
// and 28.1 ms for its best shapes.
// The one-ray-per-thread K7 kernel stays as
// volpath_primal_k_direct_kernel (register loads, no minimum-blocks bound:
// 128, 182 and 255 registers), for comparison only: 23.0, 37.1 and 50.3 ms
// at K = 2, 4, 8, where the persistent K=1 kernel takes 10.3 ms.
//
// With from_state, the same lane starts from a PathState (K2's path_state
// entry, volpath_primal_state in the wrappers' counts): the recursive detached Li of the delayed DRT term
// (uivr_tpu/integrators/volpath_flat.py:712-718, sample_primal_pallas with
// path_state).
//
// tea_kernel (K1) exposes the inlined TEA hash for a bit-exact check.
#include <cuda_runtime.h>

#include "persistent.cuh"

#ifndef UIVR_MIN_BLOCKS
#define UIVR_MIN_BLOCKS 5
#endif
namespace {

constexpr int kThreads = 128;

template <bool kState>
__global__ void __launch_bounds__(kThreads, UIVR_MIN_BLOCKS)
volpath_primal_kernel(const uivr::PrimalParams p, unsigned long long* counter,
                      long long* util) {
  uivr::PrimalTask t(p, kState);
  uivr::run_persistent(t, p.n, counter, util);
}

// one thread, one ray: the kernels before persistent scheduling
__global__ void __launch_bounds__(kThreads)
volpath_primal_direct_kernel(const uivr::PrimalParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) uivr::primal_lane(p, i, false);
}

__global__ void __launch_bounds__(kThreads)
volpath_primal_state_direct_kernel(const uivr::PrimalParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) uivr::primal_lane(p, i, true);
}

// K7's minimum-blocks bound of __launch_bounds__ per instantiation, at
// kThreads a block (PERF.md: the fastest of a sweep on the card).
template <int KMAX>
constexpr int kK7MinBlocks = KMAX == 2 ? 7 : (KMAX == 4 ? 5 : 4);

template <int KMAX>
__global__ void __launch_bounds__(kThreads, kK7MinBlocks<KMAX>)
volpath_primal_k_kernel(const uivr::PrimalParams p, unsigned long long* counter,
                        long long* util) {
  uivr::PrimalKTask<KMAX> t(p);
  uivr::run_persistent(t, p.n, counter, util);
}

// one thread, one ray, loads in registers: the K7 kernel before persistent
// scheduling
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
volpath_primal_k_direct_kernel(const uivr::PrimalParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.n) uivr::primal_lane_k<KMAX>(p, i);
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

unsigned int n_blocks(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

template <bool kState>
int launch_persistent(const uivr::PrimalParams& p, unsigned long long* counter,
                      long long* util, cudaStream_t st) {
  static int per_sm = 0;
  auto kernel = volpath_primal_kernel<kState>;
  kernel<<<uivr::persistent_grid(kernel, kThreads, p.n, per_sm), kThreads, 0, st>>>(
      p, counter, util);
  return (int)cudaGetLastError();
}

template <int KMAX>
int launch_k(const uivr::PrimalParams& p, unsigned long long* counter, long long* util,
             cudaStream_t st) {
  static int per_sm = 0;
  auto kernel = volpath_primal_k_kernel<KMAX>;
  kernel<<<uivr::persistent_grid(kernel, kThreads, p.n, per_sm), kThreads, 0, st>>>(
      p, counter, util);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The persistent primal kernel: world rays, or a PathState with
// from_state.  counter: 8 bytes of scratch, zeroed here on the stream.
// util: (warps, 2) int64 utilization counters, or null.
int volpath_primal_launch(const uivr::PrimalParams* params, int from_state, void* counter,
                          void* util, void* stream) {
  if (params->n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)counter;
  long long* u = (long long*)util;
  cudaError_t e = cudaMemsetAsync(c, 0, sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  return from_state ? launch_persistent<true>(*params, c, u, st)
                    : launch_persistent<false>(*params, c, u, st);
}

// The minimum-blocks bound of the persistent kernels' __launch_bounds__.
int min_blocks() { return UIVR_MIN_BLOCKS; }

// Warps a persistent launch can hold at most: the rows its util needs.
int persistent_max_warps() { return uivr::sm_count() * 64; }

// The one-ray-per-thread kernels (comparison only).
int volpath_primal_direct_launch(const uivr::PrimalParams* params, int from_state,
                                 void* stream) {
  if (params->n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (from_state) {
      volpath_primal_state_direct_kernel<<<n_blocks(params->n), kThreads, 0, st>>>(*params);
    } else {
      volpath_primal_direct_kernel<<<n_blocks(params->n), kThreads, 0, st>>>(*params);
    }
  }
  return (int)cudaGetLastError();
}

// K7, persistent: kmax is the instantiation (2, 4 or 8), params->k_cand <=
// kmax; counter and util as volpath_primal_launch's.
int volpath_primal_k_launch(const uivr::PrimalParams* params, int kmax, void* counter,
                            void* util, void* stream) {
  if (params->k_cand < 2 || params->k_cand > kmax) return (int)cudaErrorInvalidValue;
  if (params->n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)counter;
  long long* u = (long long*)util;
  cudaError_t e = cudaMemsetAsync(c, 0, sizeof(unsigned long long), st);
  if (e != cudaSuccess) return (int)e;
  switch (kmax) {
    case 2: return launch_k<2>(*params, c, u, st);
    case 4: return launch_k<4>(*params, c, u, st);
    case 8: return launch_k<8>(*params, c, u, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7, one ray per thread (comparison only).
int volpath_primal_k_direct_launch(const uivr::PrimalParams* params, int kmax, void* stream) {
  if (params->k_cand < 2 || params->k_cand > kmax) return (int)cudaErrorInvalidValue;
  if (params->n <= 0) return (int)cudaGetLastError();
  const dim3 grid(n_blocks(params->n)), block(kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kmax) {
    case 2: volpath_primal_k_direct_kernel<2><<<grid, block, 0, st>>>(*params); break;
    case 4: volpath_primal_k_direct_kernel<4><<<grid, block, 0, st>>>(*params); break;
    case 8: volpath_primal_k_direct_kernel<8><<<grid, block, 0, st>>>(*params); break;
    default: return (int)cudaErrorInvalidValue;
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
