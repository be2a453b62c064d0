// Lanes of the delayed DRT term (uivr_tpu_torch/integrators/volpath_flat.py:
// _drt_backward_flat), one function or task per launch.
//
// The term's draws come from the wavefront Sampler TEA(seed, 0x5151), whose
// counter is shared by all lanes: the reference's loops run until their
// longest walk ends, so every lane's later draws sit after the maximum trip
// count of the loop before.  The launches reproduce that exactly:
//
//   1. DrtWalkTask (drt_walk_lane): drt_distance; trip k draws at 2k,
//      2k+1; atomicMax of the trip count into counts[0] (K_A).  It keeps
//      the sigma and albedo of the selected collision.  Its kernel is
//      persistent (persistent.cuh) and reads the draws' pre-hashes from a
//      table in shared memory.
//   2. DrtNeeTask (drt_nee_lane): the NEE direction at 2K_A, 2K_A+1, then
//      ratio tracking with trip j at 2K_A+2+j; atomicMax into counts[1]
//      (K_B).  Its kernel is persistent.
//   3. drt_phase_lane: phase sampling from D = 2K_A (+ 2 + K_B with NEE),
//      with u1 at D and u2 at D+2; builds the PathState of the recursive
//      primal.
//   4. drt_scatter_lane, after the recursive primal from that PathState
//      (volpath_primal_state_kernel): the MIS weight from the kept sigma
//      and the atomic scatter of the factor adjoint * Li to the sampled
//      point's corners.
//
// K_A and K_B are read from device memory: no host sync between launches.
// An inactive lane never walks and raises no maximum.
#pragma once
#include "volpath_adjoint.cuh"

namespace uivr {

// Mirrors uivr_tpu_torch/ops/volpath_step.py:DrtParams (ctypes).
struct DrtParams {
  PrimalParams P;            // medium, emitter, config (P.seed unused)
  // reservoir vertices (inputs)
  const float* res_o;        // (n, 3)
  const float* res_d_l;      // (n, 3)
  const float* res_d_w;      // (n, 3)
  const float* res_maxt;     // (n,)
  const int32_t* res_depth;  // (n,)
  const uint8_t* res_active; // (n,)
  const float* adjoint;      // (n, 3) reservoir weight * dL
  // launch 1
  float* t_sel;              // (n,)
  float* wsum;               // (n,)
  uint8_t* found;            // (n,)
  int32_t* trips_a;          // (n,)
  float* p;                  // (n, 3) sampled point (local)
  uint8_t* active;           // (n,) reservoir active and found
  float* sel_sig;            // (n,) sigma at p (0 where not found)
  float* sel_alb;            // (n, 3) albedo at p (0 where not found)
  // launch 2
  float* nee;                // (n, 3)
  int32_t* trips_b;          // (n,)
  // launch 3: the recursive path's state
  uint8_t* ps_active;        // (n,)
  int32_t* ps_depth;         // (n,)
  float* ps_d_l;             // (n, 3)
  float* ps_d_w;             // (n, 3)
  float* ps_maxt;            // (n,)
  float* ps_last_pdf;        // (n,)
  // launch 4
  const float* rec_L;        // (n, 3) the recursive primal's radiance
  float* g_sigma;            // (D, H, W) accumulated
  float* g_albedo;           // (D, H, W, 3) accumulated
  uint32_t* counts;          // [K_A, K_B], zeroed by the caller
  uint32_t drt_seed;         // TEA(seed, 0x5151)
};

__host__ __device__ inline void atomic_max(uint32_t* a, uint32_t v) {
#ifdef __CUDA_ARCH__
  atomicMax(a, v);
#else
  if (v > *a) *a = v;
#endif
}

// ratio tracking's null fraction (tracking/trackers.py:_ratio)
__host__ __device__ inline float null_ratio(float sig, float sigma_maj) {
  return fmaxf(sigma_maj > 0.0f ? 1.0f - sig / fmaxf(sigma_maj, 1e-20f) : 1.0f, 0.0f);
}

// The wavefront draws of the walk's first kDrtPreTrips trips read their
// counters' pre-hashes (wavefront_pre of dims 0 .. kDrtPreDims - 1) from a
// table that each block of drt_walk_kernel fills in shared memory at its
// start; a later trip hashes its own.  The draws are the same either way.
constexpr uint32_t kDrtPreTrips = 128;
constexpr uint32_t kDrtPreDims = 2u * kDrtPreTrips;

// Raise *a to v over the warp's lanes that call this together: one
// atomicMax for the group (its largest v; a lane with `has` false adds 0).
__host__ __device__ inline void raise_group_max(uint32_t* a, bool has, uint32_t v) {
#ifdef __CUDA_ARCH__
  const unsigned group = __activemask();
  const unsigned most = __reduce_max_sync(group, has ? v : 0u);
  if ((threadIdx.x & 31u) == (unsigned)(__ffs(group) - 1) && most > 0u) atomicMax(a, most);
#else
  if (has) atomic_max(a, v);
#endif
}

// Launch 1 for one reservoir vertex, as a task of the persistent scheduler
// (persistent.cuh): begin(i) loads the vertex, step() runs one trip of
// drt_distance (draws at 2k, 2k+1), end(i) writes the outputs and raises
// K_A.  An inactive vertex walks no trip: it is finished at begin.  The
// walk keeps the sigma and albedo of the collision it selects (sel_sig,
// sel_alb): the values at p, which the scatter reads instead of fetching
// the 8 corners again.  pre / n_pre: the table of pre-hashes (null and 0:
// every draw hashes its own).
struct DrtWalkTask {
  const DrtParams& D;
  const uint32_t* pre;
  uint32_t n_pre;
  V3 o, d, sel_alb;
  float maxt, t, W, wsum, t_sel, sel_sig;
  uint32_t key, k;        // vertex, trips
  bool walks, walking;

  __host__ __device__ DrtWalkTask(const DrtParams& dp, const uint32_t* table, uint32_t n_table)
      : D(dp), pre(table), n_pre(n_table) {}

  __host__ __device__ void begin(int64_t i) {
    key = (uint32_t)i;
    o = load3(D.res_o, i);
    d = load3(D.res_d_l, i);
    maxt = D.res_maxt[i];
    walks = walking = D.res_active[i] != 0;
    t = 0.0f;
    W = walks ? 1.0f : 0.0f;
    wsum = t_sel = sel_sig = 0.0f;
    sel_alb = {0.0f, 0.0f, 0.0f};
    k = 0;
  }

  __host__ __device__ bool finished() const { return !walking; }

  __host__ __device__ void step() {
    const PrimalParams& P = D.P;
    float t_exit;
    const float sigma_maj = cell_step(P, o, d, t, t_exit);
    const float u1 = wavefront_draw_at(pre, n_pre, D.drt_seed, 2u * k, key);
    const float u_res = wavefront_draw_at(pre, n_pre, D.drt_seed, 2u * k + 1u, key);
    const float t_cand = t + free_step(sigma_maj, u1);
    const bool collided = t_cand < fminf(t_exit, maxt);
    const bool crossed = !collided && t_exit < maxt;
    const bool done_now = !collided && t_exit >= maxt;
    if (collided) {
      float sig;
      V3 alb;
      sigma_albedo(P, step_point(o, t_cand, d), sig, alb);
      const float omega = W / fmaxf(sigma_maj, 1e-20f);
      wsum = wsum + omega;
      if (u_res * wsum <= omega) {
        t_sel = t_cand;
        sel_sig = sig;
        sel_alb = alb;
      }
      W = W * null_ratio(sig, sigma_maj);
      t = t_cand;
    } else if (crossed) {
      t = t_exit;
    }
    if (done_now || !(W > 1e-7f) || !(k < (uint32_t)P.max_steps)) walking = false;
    ++k;
  }

  __host__ __device__ void write(int64_t i) const {
    const bool found = walks && wsum > 0.0f;
    D.t_sel[i] = t_sel;
    D.wsum[i] = wsum;
    D.found[i] = found ? 1 : 0;
    D.trips_a[i] = (int32_t)k;
    store3(D.p, i, step_point(o, found ? t_sel : 0.0f, d));
    D.active[i] = found ? 1 : 0;
    D.sel_sig[i] = found ? sel_sig : 0.0f;
    store3(D.sel_alb, i, found ? sel_alb : V3{0.0f, 0.0f, 0.0f});
  }

  __host__ __device__ void end(int64_t i) const {
    write(i);
    raise_group_max(D.counts, walks, k);
  }
};

// Launch 1 run to its end for one vertex, every draw hashed in full and
// K_A raised by the lane alone (the one-thread-per-vertex kernel's lane).
__host__ __device__ inline void drt_walk_lane(const DrtParams& D, int64_t i) {
  DrtWalkTask task(D, nullptr, 0);
  task.begin(i);
  while (!task.finished()) task.step();
  task.write(i);
  if (task.walks) atomic_max(D.counts, task.k);
}

// Launch 2 for one reservoir vertex, as a task of the persistent scheduler
// (persistent.cuh): begin(i) takes the direction draws at 2K_A, 2K_A+1,
// samples the emitter and sets up the transmittance walk; step() runs one
// ratio-tracking trip (draw 2K_A+2+j); end(i) writes nee and trips_b and
// raises K_B.  An inactive vertex, or one whose sample has pdf 0, walks no
// trip: it is finished at begin and writes zeros.  Every draw is keyed by
// the vertex index and K_B is a maximum, so the order in which vertices
// occupy lanes and finish changes nothing.
struct DrtNeeTask {
  const DrtParams& D;
  V3 p, dln, em_w;        // walk origin and direction (local), sample weight
  float tmax, t, tr, k;   // k: phase * MIS weight of the sample
  uint32_t key, dim0, j;  // vertex, first draw, trips
  bool walks, walking;

  __host__ __device__ explicit DrtNeeTask(const DrtParams& d) : D(d) {}

  __host__ __device__ void begin(int64_t i) {
    const PrimalParams& P = D.P;
    key = (uint32_t)i;
    dim0 = 2u * D.counts[0];
    j = 0;
    t = 0.0f;
    tr = 1.0f;
    k = 0.0f;
    walks = walking = false;
    if (!D.active[i]) return;
    const float u0 = wavefront_draw(D.drt_seed, dim0, key);
    const float u1 = wavefront_draw(D.drt_seed, dim0 + 1u, key);
    float ds_pdf;
    const float* rad;   // stays null: the term's NEE samples at full resolution
    const V3 ds_d = emitter_sample(P, u0, u1, ds_pdf, em_w, rad);
    if (!(ds_pdf > 0.0f)) return;
    p = load3(D.p, i);
    dln = xform_dir(P.w2l, 4, ds_d);
    tmax = exit_dist(p, dln);
    const float ph = phase_eval(P.phase_g, load3(D.res_d_w, i), ds_d);
    k = ph * mis_weight(ds_pdf, ph);
    walks = walking = true;
  }

  __host__ __device__ bool finished() const { return !walking; }

  __host__ __device__ void step() {
    const PrimalParams& P = D.P;
    float t_exit;
    const float sigma_maj = cell_step(P, p, dln, t, t_exit);
    const float u = wavefront_draw(D.drt_seed, dim0 + 2u + j, key);
    const float t_cand = t + free_step(sigma_maj, u);
    const bool collided = t_cand < fminf(t_exit, tmax);
    const bool crossed = !collided && t_exit < tmax;
    const bool done_now = !collided && t_exit >= tmax;
    if (collided) {
      float sig;
      V3 alb;
      sigma_albedo(P, step_point(p, t_cand, dln), sig, alb);
      tr = tr * null_ratio(sig, sigma_maj);
      t = t_cand;
    } else if (crossed) {
      t = t_exit;
    }
    if (done_now || !(tr > 0.0f) || !(j < (uint32_t)P.max_steps)) walking = false;
    ++j;
  }

  // nee and trips_b of vertex i
  __host__ __device__ void write(int64_t i) const {
    V3 nee = {0.0f, 0.0f, 0.0f};
    if (walks) {
      const float s = k * tr;
      nee = {s * em_w.x, s * em_w.y, s * em_w.z};
    }
    store3(D.nee, i, nee);
    D.trips_b[i] = (int32_t)j;
  }

  // the outputs, and K_B raised once per group of the warp's lanes that
  // finish together
  __host__ __device__ void end(int64_t i) const {
    write(i);
    raise_group_max(D.counts + 1, walks, j);
  }
};

// Launch 2 run to its end for one vertex, K_B raised by the lane alone
// (the one-thread-per-vertex kernel's lane).
__host__ __device__ inline void drt_nee_lane(const DrtParams& D, int64_t i) {
  DrtNeeTask task(D);
  task.begin(i);
  while (!task.finished()) task.step();
  task.write(i);
  if (task.walks) atomic_max(D.counts + 1, task.j);
}

__host__ __device__ inline void drt_phase_lane(const DrtParams& D, int64_t i) {
  const PrimalParams& P = D.P;
  const uint32_t dim = 2u * D.counts[0] + (P.use_nee ? 2u + D.counts[1] : 0u);
  const float u1 = wavefront_draw(D.drt_seed, dim, (uint32_t)i);
  const float u2 = wavefront_draw(D.drt_seed, dim + 2u, (uint32_t)i);
  float pdf;
  const V3 wo = phase_sample(P.phase_g, load3(D.res_d_w, i), u1, u2, pdf);
  const V3 dl = xform_dir(P.w2l, 4, wo);
  const float maxt = exit_dist(load3(D.p, i), dl);
  const bool act = D.active[i] != 0;
  const int32_t depth = act ? D.res_depth[i] + 1 : D.res_depth[i];
  D.ps_active[i] = (act && depth < P.max_depth && maxt > 1e-7f) ? 1 : 0;
  D.ps_depth[i] = depth;
  store3(D.ps_d_l, i, dl);
  store3(D.ps_d_w, i, wo);
  D.ps_maxt[i] = maxt;
  D.ps_last_pdf[i] = act ? pdf : 1.0f;
}

// Launch 4 for one vertex, after the recursive primal wrote rec_L: for a
// vertex that found a point, the MIS weight and the factor adjoint *
// (nee + rec_L) from the sigma and albedo the walk kept at p, scattered to
// p's 8 corners.
__host__ __device__ inline void drt_scatter_lane(const DrtParams& D, int64_t i,
                                                 int use_drt_mis) {
  if (!D.active[i]) return;
  const PrimalParams& P = D.P;
  const float sig = D.sel_sig[i];
  const V3 alb = load3(D.sel_alb, i);
  const float w_mis = use_drt_mis ? 1.0f / (1.0f + sig * sig) : 1.0f;
  const float ww = w_mis * D.wsum[i];
  const V3 adj = load3(D.adjoint, i), rec = load3(D.rec_L, i);
  V3 Li = rec;
  if (P.use_nee) {
    const V3 nee = load3(D.nee, i);
    Li = {nee.x + rec.x, nee.y + rec.y, nee.z + rec.z};
  }
  const V3 f = {(ww * adj.x) * Li.x, (ww * adj.y) * Li.y, (ww * adj.z) * Li.z};
  scatter_sigma_albedo(P, D.g_sigma, D.g_albedo, load3(D.p, i),
                       (f.x * alb.x + f.y * alb.y) + f.z * alb.z,
                       {f.x * sig, f.y * sig, f.z * sig});
}

}  // namespace uivr
