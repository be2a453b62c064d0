// Persistent scheduling of the walking kernels: a grid that fills the card
// once, whose lanes take rays from a work counter and take a new one as
// soon as theirs ends.
//
// A one-ray-per-thread launch holds a warp's registers until its longest
// path ends; path lengths have a long tail (janga-smoke's training forward:
// median 6 tracking events, p99 552), so most of the lane-iterations such
// a warp issues belong to lanes that finished and wait.  Here a lane whose
// ray ends writes that ray's outputs and claims the next index, so a warp
// keeps stepping as long as the counter holds rays.
//
// Each lane is keyed by its ray index (the LaneRng of init_from_ray and
// init_from_state, the outputs at that index), so a ray walks the same
// path, draws the same numbers and writes the same outputs whichever lane
// takes it and when: only the order in which rays occupy lanes changes.
//
// A task is one lane's work: begin(i) starts ray i, finished() says its
// walk is over, step() runs one tracking event (lane_step), end(i) writes
// its outputs.  The tasks are host and device code; the host tests drive
// them through an emulation of the scheduler below.
#pragma once
#include "volpath_adjoint.cuh"

namespace uivr {

// The primal lane (volpath_primal_kernel): a world ray or a PathState.
struct PrimalTask {
  const PrimalParams& P;
  bool from_state;
  LaneState s;
  PrimalHooks h;

  __host__ __device__ PrimalTask(const PrimalParams& p, bool state)
      : P(p), from_state(state), h{p.max_steps} {}
  __host__ __device__ void begin(int64_t i) { primal_begin(P, i, from_state, s); }
  __host__ __device__ bool finished() const { return lane_finished(s, h); }
  __host__ __device__ void step() { lane_step(P, s, h); }
  __host__ __device__ void end(int64_t i) const { write_primal(P, i, s); }
};

// The adjoint lane (volpath_adjoint_kernel): begin() also resets the
// hooks' per-ray state.
struct AdjointTask {
  const AdjParams& A;
  LaneState s;
  AdjointHooks h;

  __host__ __device__ explicit AdjointTask(const AdjParams& a) : A(a), h(a) {}
  __host__ __device__ void begin(int64_t i) { adjoint_begin(A, i, s, h); }
  __host__ __device__ bool finished() const { return lane_finished(s, h); }
  __host__ __device__ void step() { lane_step(A.P, s, h); }
  __host__ __device__ void end(int64_t i) const { adjoint_end(A, i, s, h); }
};

constexpr int kUtilCounters = 2;   // per warp: lane-steps, warp iterations

#ifdef __CUDACC__
// The scheduler of one warp; every lane of the warp calls it (the block
// holds whole warps).  A lane is busy while it walks a ray.  While the warp
// has idle lanes and the counter holds rays, the idle lanes claim
// consecutive indices with one atomicAdd by the lowest idle lane, in lane
// order, and start them.  Then every busy lane runs one event, and a lane
// whose walk is over writes its ray and becomes idle.  The warp stops
// claiming once a claim reaches n, and exits when it holds no ray.
// util (or null): per warp, the busy lanes' events and the iterations.
template <class Task>
__device__ inline void run_persistent(Task& t, int64_t n, unsigned long long* counter,
                                      long long* util) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  bool busy = false, more = true;   // more: warp-uniform
  int64_t ray = 0;
  long long lane_steps = 0, iters = 0;
  for (;;) {
    if (more) {
      const unsigned idle = __ballot_sync(kAll, !busy);
      if (idle != 0u) {
        const int n_idle = __popc(idle);
        const int leader = __ffs(idle) - 1;
        unsigned long long base = 0;
        if ((int)lane == leader) base = atomicAdd(counter, (unsigned long long)n_idle);
        base = __shfl_sync(kAll, base, leader);
        more = base + (unsigned long long)n_idle < (unsigned long long)n;
        if (!busy) {
          const unsigned long long i = base + (unsigned long long)__popc(idle & below);
          if (i < (unsigned long long)n) {
            ray = (int64_t)i;
            t.begin(ray);
            busy = true;
          }
        }
      }
    }
    if (__ballot_sync(kAll, busy) == 0u) {
      if (!more) break;
      continue;
    }
    bool stepped = false;
    if (busy) {
      if (!t.finished()) {
        t.step();
        stepped = true;
      }
      if (t.finished()) {
        t.end(ray);
        busy = false;
      }
    }
    if (util) {
      const unsigned s = __ballot_sync(kAll, stepped);
      lane_steps += __popc(s);
      iters += 1;
    }
  }
  if (util && lane == 0u) {
    const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    util[kUtilCounters * warp] = lane_steps;
    util[kUtilCounters * warp + 1] = iters;
  }
}

// The SMs of the current device, taken once per library load.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks of a persistent launch of `kernel` over n rays: the blocks that
// fit on the card at once (occupancy x SMs; per_sm caches the occupancy,
// one int per kernel, taken at its first launch), no more than the rays
// need.
template <class Kernel>
inline unsigned int persistent_grid(Kernel kernel, int threads, int64_t n, int& per_sm) {
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (per_sm <= 0) per_sm = 1;
  }
  const int64_t full = (int64_t)per_sm * sm_count();
  const int64_t need = (n + threads - 1) / threads;
  return (unsigned int)(need < full ? need : full);
}
#endif

}  // namespace uivr
