// One lane of the path-replay adjoint (K4 + the adjoint half of K5): the
// MAIN / SHADOW / REPLAY / DONE state machine of uivr_tpu_torch/
// integrators/volpath_flat.py:adjoint_walk, run to completion for one ray
// on the primal lane's tracking loop (trace_lane with AdjointHooks).
//
// Per event, in the twin's order: PRB in-scattering cotangents at real
// collisions; at each segment end (real collision or escape) one alt draw
// for the DRT reservoir and trans_grad_samples alt draws for the
// transmittance-gradient samples; at a completed shadow walk the PRB
// subtraction and, when the contribution is nonzero, a REPLAY of the
// shadow walk from the primary counter snapshot taken at the scatter,
// adding -sum(sh_adj)/sigma_n at every null collision.  Cotangents go to
// the (D,H,W) sigma and (D,H,W,3) albedo gradient grids with atomicAdd.
//
// Host and device inlines: a host compiler builds this file for the CPU
// tests with __host__ and __device__ defined empty, where atomic_add is a
// plain +=.
#pragma once
#include "volpath_lane.cuh"

namespace uivr {

// Mirrors uivr_tpu_torch/ops/volpath_step.py:AdjParams (ctypes).
struct AdjParams {
  PrimalParams P;            // rays, medium, emitter, config; P.seed = seed
  const float* L_in;         // (n, 3) replayed primal radiance
  const float* dL;           // (n, 3) adjoint radiance
  float* g_sigma;            // (D, H, W) accumulated
  float* g_albedo;           // (D, H, W, 3) accumulated
  float* res_wsum;           // (n, 3) reservoir outputs
  float* res_cur_w;          // (n, 3)
  int32_t* res_depth;        // (n,)
  float* res_o;              // (n, 3)
  float* res_d_l;            // (n, 3)
  float* res_d_w;            // (n, 3)
  float* res_maxt;           // (n,)
  uint8_t* res_active;       // (n,)
  uint32_t* alt_dims;        // (n,) alt-stream draws, or null
  int32_t* events;           // (n, 2) real collisions and replay scatters, or null
  int32_t use_drt, use_drt_subsampling, use_drt_mis, trans_grad_samples;
};

__host__ __device__ inline void atomic_add(float* a, float v) {
#ifdef __CUDA_ARCH__
  atomicAdd(a, v);
#else
  *a += v;
#endif
}

// cotangent cot on sigma_t(p): the grid holds sigma_t / scale
__host__ __device__ inline void scatter_sigma(const PrimalParams& P, float* g,
                                              V3 p, float cot) {
  int64_t idx[8];
  float w[8];
  corners(P, p, idx, w);
  const float cs = cot * P.scale;
  for (int k = 0; k < 8; ++k) atomic_add(g + idx[k], w[k] * cs);
}

__host__ __device__ inline void scatter_sigma_albedo(const PrimalParams& P,
                                                     float* gs, float* ga, V3 p,
                                                     float cot_s, V3 cot_a) {
  int64_t idx[8];
  float w[8];
  corners(P, p, idx, w);
  const float cs = cot_s * P.scale;
  for (int k = 0; k < 8; ++k) {
    atomic_add(gs + idx[k], w[k] * cs);
    atomic_add(ga + idx[k] * 3, w[k] * cot_a.x);
    atomic_add(ga + idx[k] * 3 + 1, w[k] * cot_a.y);
    atomic_add(ga + idx[k] * 3 + 2, w[k] * cot_a.z);
  }
}

struct Reservoir {
  V3 wsum, cur_w, o, d_l, d_w;
  float maxt;
  int depth;
  bool active;
};

struct AdjointHooks {
  static constexpr bool kAdjoint = true;
  const AdjParams& A;
  int max_steps;
  V3 dL;
  LaneRng alt;
  uint32_t rp_dim, sh_dim0;
  float rp_t, rp_tr;
  V3 sh_adj;
  Reservoir res;
  int32_t n_real, n_replay;   // events that scatter 32 and 8 floats

  __host__ __device__ explicit AdjointHooks(const AdjParams& a)
      : A(a), max_steps(3 * a.P.max_steps) {}

  // The per-ray state, set when the lane starts ray i (whose primary
  // stream is rng): a persistent lane that takes a new ray resets all of
  // it, REPLAY's rp_t and rp_dim included.
  __host__ __device__ void start(int64_t i, const LaneRng& rng) {
    dL = load3(A.dL, i);
    alt = rng.fork(0x9E3779B9u);
    rp_dim = sh_dim0 = 0u;
    rp_t = rp_tr = 0.0f;
    sh_adj = {0.0f, 0.0f, 0.0f};
    n_real = n_replay = 0;
    res.wsum = res.cur_w = res.o = res.d_l = res.d_w = V3{0.0f, 0.0f, 0.0f};
    res.maxt = 0.0f;
    res.depth = -1;
    res.active = false;
  }

  // PRB subtraction; REPLAY unless the walk contributed nothing
  __host__ __device__ int shadow_done(const PrimalParams&, LaneState& s, V3 c) {
    s.result = {s.result.x - c.x, s.result.y - c.y, s.result.z - c.z};
    sh_adj = {dL.x * c.x, dL.y * c.y, dL.z * c.z};
    if ((fabsf(c.x) + fabsf(c.y)) + fabsf(c.z) > 0.0f) {
      rp_dim = sh_dim0;
      rp_t = 0.0f;
      rp_tr = 1.0f;
      return REPLAY;
    }
    return s.post_mode;
  }

  __host__ __device__ void main_event(const PrimalParams& P, const LaneState& s,
                                      bool real, bool fin_seg, float t_cand, V3 p,
                                      float sig, V3 alb) {
    n_real += real ? 1 : 0;
    // in-scattering gradients at real collisions
    if (real && (!A.use_drt || A.use_drt_mis)) {
      const float wf = (A.use_drt && A.use_drt_mis) ? sig / (1.0f + sig * sig)
                                                    : 1.0f / fmaxf(sig, 1e-8f);
      const V3 base = {(dL.x * (s.result.x / fmaxf(alb.x, 1e-8f))) * wf,
                       (dL.y * (s.result.y / fmaxf(alb.y, 1e-8f))) * wf,
                       (dL.z * (s.result.z / fmaxf(alb.z, 1e-8f))) * wf};
      const float cot_s = (base.x * alb.x + base.y * alb.y) + base.z * alb.z;
      scatter_sigma_albedo(P, A.g_sigma, A.g_albedo, p, cot_s,
                           {base.x * sig, base.y * sig, base.z * sig});
    }
    if (!(real || fin_seg)) return;
    // DRT reservoir over segment ends, escape segments included
    if (A.use_drt && A.use_drt_subsampling) {
      const float u = alt.next(true);
      const V3 w = s.thr;
      res.wsum = {res.wsum.x + w.x, res.wsum.y + w.y, res.wsum.z + w.z};
      const float q0 = res.wsum.x > 0.0f ? w.x / fmaxf(res.wsum.x, 1e-30f) : 0.0f;
      const float q1 = res.wsum.y > 0.0f ? w.y / fmaxf(res.wsum.y, 1e-30f) : 0.0f;
      const float q2 = res.wsum.z > 0.0f ? w.z / fmaxf(res.wsum.z, 1e-30f) : 0.0f;
      if (u <= ((q0 + q1) + q2) / 3.0f) {
        res.cur_w = w;
        res.depth = s.depth;
        res.o = s.o;
        res.d_l = s.d_l;
        res.d_w = s.d_w;
        res.maxt = s.maxt;
        res.active = true;
      }
    }
    // transmittance gradients: uniform samples along the segment
    const float interval = fin_seg ? s.maxt : t_cand;
    const float adj_w = (dL.x * s.result.x + dL.y * s.result.y) + dL.z * s.result.z;
    const float cot = -adj_w * (interval / (float)A.trans_grad_samples);
    for (int k = 0; k < A.trans_grad_samples; ++k) {
      const float ut = alt.next(true) * interval;
      const V3 ps = {s.o.x + ut * s.d_l.x, s.o.y + ut * s.d_l.y, s.o.z + ut * s.d_l.z};
      scatter_sigma(P, A.g_sigma, ps, cot);
    }
  }

  // one step of the replayed shadow walk
  __host__ __device__ void replay(const PrimalParams& P, LaneState& s, V3 p,
                                  float sig, float sigma_maj, float ratio,
                                  bool collided, bool fin_seg, float t_next,
                                  float u_evt) {
    if (collided) {
      if (ratio > 0.0f) {
        ++n_replay;
        const float sigma_n = fmaxf(sigma_maj - sig, 1e-8f);
        scatter_sigma(P, A.g_sigma, p, -((sh_adj.x + sh_adj.y) + sh_adj.z) / sigma_n);
      }
      rp_tr = rp_tr * ratio;
      if (P.shadow_rr > 0.0f && rp_tr < P.shadow_rr && rp_tr > 0.0f)
        rp_tr = u_evt < rp_tr * P.inv_shadow_rr ? P.shadow_rr : 0.0f;
    }
    rp_t = t_next;
    rp_dim += 2u;
    if (fin_seg || rp_tr <= 0.0f) s.mode = s.post_mode;
  }

  __host__ __device__ void scattered(const LaneState& s) { sh_dim0 = s.rng.dim; }
};

// An adjoint lane's start on ray i: the primal lane's from a world ray,
// the replayed radiance, the hooks' per-ray state.
__host__ __device__ inline void adjoint_begin(const AdjParams& A, int64_t i, LaneState& s,
                                              AdjointHooks& h) {
  init_from_ray(A.P, i, s);
  init_common(s);
  s.result = load3(A.L_in, i);
  h.start(i, s.rng);
}

// Ray i's outputs: its DRT reservoir and per-lane counters.
__host__ __device__ inline void adjoint_end(const AdjParams& A, int64_t i, const LaneState& s,
                                            const AdjointHooks& h) {
  const PrimalParams& P = A.P;
  const Reservoir& r = h.res;
  store3(A.res_wsum, i, r.wsum);
  store3(A.res_cur_w, i, r.cur_w);
  A.res_depth[i] = r.depth;
  store3(A.res_o, i, r.o);
  store3(A.res_d_l, i, r.d_l);
  store3(A.res_d_w, i, r.d_w);
  A.res_maxt[i] = r.maxt;
  A.res_active[i] = r.active ? 1 : 0;
  if (P.dims) P.dims[i] = s.rng.dim;
  if (P.steps) P.steps[i] = s.steps;
  write_cls_counts(P, i, s);
  if (A.alt_dims) A.alt_dims[i] = h.alt.dim;
  if (A.events) {
    A.events[2 * i] = h.n_real;
    A.events[2 * i + 1] = h.n_replay;
  }
}

__host__ __device__ inline void adjoint_lane(const AdjParams& A, int64_t i) {
  LaneState s;
  AdjointHooks h(A);
  adjoint_begin(A, i, s, h);
  trace_lane(A.P, s, h);
  adjoint_end(A, i, s, h);
}

}  // namespace uivr
