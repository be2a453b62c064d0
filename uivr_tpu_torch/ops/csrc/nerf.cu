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
// (forward, replay, adjoint), so each pass is one launcher call here.
//
// What bounds them: every query reads the 8 float4 corners (128 B) of the
// interleaved [sigma, emission] grid at a scattered point, and the adjoint
// adds a float4 into each of the 8 corners of the gradient grid.  The grid
// of a 128^3 stage (33.5 MB) stays in the 50 MB L2, so the reads' latency,
// the lanes that idle and the atomics, which pile up on few voxels at the
// stage's coarse grids (a 8^3 grid has 512), bound them, not device-memory
// bytes or arithmetic.  The design (PERF.md §6 has each lever's times):
//
// - nerf_compact_kernel lists the rays that enter the medium's box (a
//   warp's in lane order, so a pixel's rays stay neighbours), and the
//   primal writes the others' background at once: a third of a training
//   batch's rays miss the box, and in a one-ray-per-thread launch their
//   lanes idle through their warp's whole march;
// - the march kernels run one listed ray a thread, every ray's 128 queries
//   in one loop (threads past the list's end exit at once), so every lane
//   of a warp marches and the compiler overlaps one query's loads with the
//   query before;
// - a query in the cell of the query before reads its corners from
//   registers (NerfPrimalTask, NerfAdjointTask in nerf.cuh);
// - the adjoint sums a ray's cotangents in registers while its queries stay
//   in one cell and, when they move to a neighbouring cell, adds only the 4
//   corners they leave, one float4 atomic a nonzero corner.
// Persistent lanes that claim rays from a work counter (persistent.cuh),
// loading the next query's corners ahead of compositing, aggregating the
// atomics across a warp and a block-private gradient grid in shared memory
// were slower and went.
//
// The march kernels come in two instantiations of their index type Idx:
// int32_t, and int64_t for grids of 2^29 voxels and more, whose float
// offsets pass 2^31 (nerf_needs_index64), or where the caller asks for it
// (NerfParams::index64).  The int32_t one keeps the narrower registers of
// the grids the stage runs.
//
// The one-ray-per-thread kernels they replaced (nerf_*_direct_kernel) run
// only where a caller compares the two.  The adjoints' counting builds
// (NerfParams::atomics set) count the global atomics they issue; the
// direct adjoint's float64 build (NerfParams::g_grid64 set) sums its terms
// in double, the reference both float32 kernels' sums are held against.
#include <cuda_runtime.h>

#include "nerf.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) nerf_primal_direct_kernel(const uivr::NerfParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p.P.n) uivr::nerf_primal_lane(p, i);
}

template <bool kCount, bool kF64>
__global__ void __launch_bounds__(kThreads) nerf_adjoint_direct_kernel(const uivr::NerfParams p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long adds = 0;
  if (i < p.P.n) uivr::nerf_adjoint_lane<kF64>(p, i, kCount ? &adds : nullptr);
  if (kCount && adds) atomicAdd(p.atomics, adds);
}

// The rays inside the box into p.order (each warp's with one atomicAdd on
// p.listed, in lane order); the primal writes the others.
__global__ void __launch_bounds__(kThreads) nerf_compact_kernel(const uivr::NerfParams p,
                                                               bool primal) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool hit = i < p.P.n && uivr::nerf_compact_lane(p, i, primal);
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if (hits == 0u) return;
  const unsigned lane = threadIdx.x & 31u;
  const int leader = __ffs(hits) - 1;
  unsigned long long base = 0;
  if ((int)lane == leader) base = atomicAdd(p.listed, (unsigned long long)__popc(hits));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (hit) p.order[base + __popc(hits & ((1u << lane) - 1u))] = (int32_t)i;
}

// A task over the listed rays, one a thread; threads past the list's end
// exit.
template <class Task>
__device__ inline void run_listed(Task& t, const uivr::NerfParams& p) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (int64_t)*p.listed) return;
  t.begin(k);
  while (!t.finished()) t.step();
  t.end();
}

template <class Idx>
__global__ void __launch_bounds__(kThreads) nerf_primal_kernel(const uivr::NerfParams p) {
  uivr::NerfPrimalTask<Idx> t(p);
  run_listed(t, p);
}

template <bool kCount, class Idx>
__global__ void __launch_bounds__(kThreads) nerf_adjoint_kernel(const uivr::NerfParams p) {
  uivr::NerfAdjointTask<kCount, Idx> t(p);
  run_listed(t, p);
  if (kCount && t.adds) atomicAdd(p.atomics, t.adds);
}

// Whether the march kernels run in int64_t offsets.
bool index64(const uivr::NerfParams& p) { return p.index64 || uivr::nerf_needs_index64(p.P); }

unsigned int grid_of(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

// Zero the count and list the rays inside the box.
cudaError_t compact(const uivr::NerfParams& p, bool primal, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(p.listed, 0, sizeof(unsigned long long), st);
  if (e != cudaSuccess) return e;
  nerf_compact_kernel<<<grid_of(p.P.n), kThreads, 0, st>>>(p, primal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The primal march: P.L (n, 3) and valid (n,); order and listed scratch.
int nerf_primal_launch(const uivr::NerfParams* params, void* stream) {
  const uivr::NerfParams& p = *params;
  if (p.P.n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = compact(p, true, st);
  if (e != cudaSuccess) return (int)e;
  if (index64(p)) {
    nerf_primal_kernel<int64_t><<<grid_of(p.P.n), kThreads, 0, st>>>(p);
  } else {
    nerf_primal_kernel<int32_t><<<grid_of(p.P.n), kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// The adjoint march: adds into g_grid, which the caller zeroes; counts its
// atomics into params->atomics when that is set.
int nerf_adjoint_launch(const uivr::NerfParams* params, void* stream) {
  const uivr::NerfParams& p = *params;
  if (p.P.n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = compact(p, false, st);
  if (e != cudaSuccess) return (int)e;
  const unsigned int blocks = grid_of(p.P.n);
  if (index64(p)) {
    if (p.atomics) {
      nerf_adjoint_kernel<true, int64_t><<<blocks, kThreads, 0, st>>>(p);
    } else {
      nerf_adjoint_kernel<false, int64_t><<<blocks, kThreads, 0, st>>>(p);
    }
  } else if (p.atomics) {
    nerf_adjoint_kernel<true, int32_t><<<blocks, kThreads, 0, st>>>(p);
  } else {
    nerf_adjoint_kernel<false, int32_t><<<blocks, kThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// The one-ray-per-thread kernels (comparison only); the adjoint counts its
// atomics into params->atomics when that is set, and adds its terms into
// the float64 sums params->g_grid64 instead of g_grid when that is set.
int nerf_primal_direct_launch(const uivr::NerfParams* params, void* stream) {
  if (params->P.n > 0)
    nerf_primal_direct_kernel<<<grid_of(params->P.n), kThreads, 0, (cudaStream_t)stream>>>(
        *params);
  return (int)cudaGetLastError();
}

int nerf_adjoint_direct_launch(const uivr::NerfParams* params, void* stream) {
  if (params->P.n > 0) {
    const unsigned int blocks = grid_of(params->P.n);
    cudaStream_t st = (cudaStream_t)stream;
    if (params->g_grid64) {
      nerf_adjoint_direct_kernel<false, true><<<blocks, kThreads, 0, st>>>(*params);
    } else if (params->atomics) {
      nerf_adjoint_direct_kernel<true, false><<<blocks, kThreads, 0, st>>>(*params);
    } else {
      nerf_adjoint_direct_kernel<false, false><<<blocks, kThreads, 0, st>>>(*params);
    }
  }
  return (int)cudaGetLastError();
}

int nerf_params_size() { return (int)sizeof(uivr::NerfParams); }

}  // extern "C"
