// Lanes of the delayed DRT term (uivr_tpu_torch/integrators/volpath_flat.py:
// _drt_backward_flat), one function per launch.
//
// The term's draws come from the wavefront Sampler TEA(seed, 0x5151), whose
// counter is shared by all lanes: the reference's loops run until their
// longest walk ends, so every lane's later draws sit after the maximum trip
// count of the loop before.  The launches reproduce that exactly:
//
//   1. drt_walk_lane: drt_distance; trip k draws at 2k, 2k+1; atomicMax of
//      the trip count into counts[0] (K_A).
//   2. drt_nee_lane: the NEE direction at 2K_A, 2K_A+1, then ratio
//      tracking with trip j at 2K_A+2+j; atomicMax into counts[1] (K_B).
//   3. drt_phase_lane: phase sampling from D = 2K_A (+ 2 + K_B with NEE),
//      with u1 at D and u2 at D+2; builds the PathState of the recursive
//      primal (volpath_primal_state_kernel runs it).
//   4. drt_scatter_lane: sigma/albedo at the sampled point, MIS weight and
//      the atomic scatter of the factor adjoint * Li.
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

__host__ __device__ inline void drt_walk_lane(const DrtParams& D, int64_t i) {
  const PrimalParams& P = D.P;
  const V3 o = load3(D.res_o, i), d = load3(D.res_d_l, i);
  const float maxt = D.res_maxt[i];
  const bool act = D.res_active[i] != 0;
  float t = 0.0f, W = act ? 1.0f : 0.0f, wsum = 0.0f, t_sel = 0.0f;
  uint32_t k = 0;
  if (act) {
    for (;;) {
      float t_exit;
      const float sigma_maj = cell_step(P, o, d, t, t_exit);
      const float u1 = wavefront_draw(D.drt_seed, 2u * k, (uint32_t)i);
      const float u_res = wavefront_draw(D.drt_seed, 2u * k + 1u, (uint32_t)i);
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
        if (u_res * wsum <= omega) t_sel = t_cand;
        W = W * null_ratio(sig, sigma_maj);
        t = t_cand;
      } else if (crossed) {
        t = t_exit;
      }
      if (done_now || !(W > 1e-7f) || !(k < (uint32_t)P.max_steps)) {
        ++k;
        break;
      }
      ++k;
    }
    atomic_max(D.counts, k);
  }
  const bool found = act && wsum > 0.0f;
  D.t_sel[i] = t_sel;
  D.wsum[i] = wsum;
  D.found[i] = found ? 1 : 0;
  D.trips_a[i] = (int32_t)k;
  store3(D.p, i, step_point(o, found ? t_sel : 0.0f, d));
  D.active[i] = found ? 1 : 0;
}

__host__ __device__ inline void drt_nee_lane(const DrtParams& D, int64_t i) {
  const PrimalParams& P = D.P;
  const uint32_t dim0 = 2u * D.counts[0];
  V3 nee = {0.0f, 0.0f, 0.0f};
  uint32_t j = 0;
  if (D.active[i]) {
    const float u0 = wavefront_draw(D.drt_seed, dim0, (uint32_t)i);
    const float u1 = wavefront_draw(D.drt_seed, dim0 + 1u, (uint32_t)i);
    float ds_pdf;
    V3 em_w;
    const float* rad;   // stays null: the term's NEE samples at full resolution
    const V3 ds_d = emitter_sample(P, u0, u1, ds_pdf, em_w, rad);
    if (ds_pdf > 0.0f) {
      const V3 p = load3(D.p, i);
      const V3 dln = xform_dir(P.w2l, 4, ds_d);
      const float tmax = exit_dist(p, dln);
      float t = 0.0f, tr = 1.0f;
      for (;;) {
        float t_exit;
        const float sigma_maj = cell_step(P, p, dln, t, t_exit);
        const float u = wavefront_draw(D.drt_seed, dim0 + 2u + j, (uint32_t)i);
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
        if (done_now || !(tr > 0.0f) || !(j < (uint32_t)P.max_steps)) {
          ++j;
          break;
        }
        ++j;
      }
      atomic_max(D.counts + 1, j);
      const float ph = phase_eval(P.phase_g, load3(D.res_d_w, i), ds_d);
      const float s = (ph * mis_weight(ds_pdf, ph)) * tr;
      nee = {s * em_w.x, s * em_w.y, s * em_w.z};
    }
  }
  store3(D.nee, i, nee);
  D.trips_b[i] = (int32_t)j;
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

__host__ __device__ inline void drt_scatter_lane(const DrtParams& D, int64_t i,
                                                 int use_drt_mis) {
  if (!D.active[i]) return;
  const PrimalParams& P = D.P;
  const V3 p = load3(D.p, i);
  float sig;
  V3 alb;
  sigma_albedo(P, p, sig, alb);
  const float w_mis = use_drt_mis ? 1.0f / (1.0f + sig * sig) : 1.0f;
  const float ww = w_mis * D.wsum[i];
  const V3 adj = load3(D.adjoint, i), rec = load3(D.rec_L, i);
  V3 Li = rec;
  if (P.use_nee) {
    const V3 nee = load3(D.nee, i);
    Li = {nee.x + rec.x, nee.y + rec.y, nee.z + rec.z};
  }
  const V3 f = {(ww * adj.x) * Li.x, (ww * adj.y) * Li.y, (ww * adj.z) * Li.z};
  scatter_sigma_albedo(P, D.g_sigma, D.g_albedo, p,
                       (f.x * alb.x + f.y * alb.y) + f.z * alb.z,
                       {f.x * sig, f.y * sig, f.z * sig});
}

}  // namespace uivr
