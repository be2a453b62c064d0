// One ray of the NeRF bootstrap stage: the jittered fixed-step march of
// uivr_tpu_torch/integrators/nerf.py, primal (nerf_primal_lane) and
// path-replay adjoint (nerf_adjoint_lane), run to completion per ray.
//
// The march reads one interleaved (D, H, W, 4) grid [sigma (unscaled),
// emission rgb], so a corner is one float4 load; the adjoint adds each
// step's sigma and emission cotangents into a (D, H, W, 4) gradient grid of
// the same layout, one 4-wide add a corner.  The arithmetic repeats the
// plain version operation for operation (float64 exp rounded once, the
// trilinear fma chain of core/grids.py, no other contraction: build with
// --fmad=false), and the jitter is the wavefront sampler's first draw
// (wavefront_draw at counter 0, lane = ray index), so a lane computes the
// plain version's bits.
//
// Host and device inlines: a host compiler builds this file for the CPU
// tests with __host__ and __device__ defined empty, where add4 is a plain
// +=.
#pragma once
#include "volpath_lane.cuh"

namespace uivr {

// Mirrors uivr_tpu_torch/ops/volpath_step.py:NerfParams (ctypes).
struct NerfParams {
  // rays o, d; L (n, 3) out; grid = the (D, H, W, 4) [sigma, emission]
  // grid with its D, H, W; n, seed, scale, w2l and the emitter
  PrimalParams P;
  uint8_t* valid;            // (n,) out (primal), or null
  const float* L_in;         // (n, 3) primal radiance (adjoint)
  const float* dL;           // (n, 3) adjoint radiance (adjoint)
  float* g_grid;             // (D, H, W, 4) [sigma, emission] gradients (adjoint)
  int32_t steps, jitter, relu, emission_scaled, hide_emitters;
};

// Hopper's 16-byte atomicAdd(float4*) on global memory, which CUDA 12.9
// brought; an older toolkit cannot build this file
#if defined(__CUDACC_VER_MAJOR__) && (__CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ < 1209)
#error "nerf.cuh needs CUDA 12.9 or later (atomicAdd on float4)"
#endif

// a 4-wide add into the gradient grid
__host__ __device__ inline void add4(float* a, float x, float y, float z, float w) {
#if defined(__CUDA_ARCH__)
  atomicAdd(reinterpret_cast<float4*>(a), make_float4(x, y, z, w));
#else
  a[0] += x;
  a[1] += y;
  a[2] += z;
  a[3] += w;
#endif
}

struct NerfRay {
  V3 entry, dl;        // local entry point and direction
  float step, jit;
  bool active;
};

// intersect_bbox, the entry point, the jitter and the step length
__host__ __device__ inline NerfRay nerf_setup(const NerfParams& N, int64_t i) {
  const PrimalParams& P = N.P;
  const V3 ow = load3(P.o, i);
  V3 ol = xform_dir(P.w2l, 4, ow);
  ol = {ol.x + P.w2l[3], ol.y + P.w2l[7], ol.z + P.w2l[11]};
  NerfRay r;
  r.dl = xform_dir(P.w2l, 4, load3(P.d, i));
  float tn, tf;
  ray_unit_cube(ol, r.dl, tn, tf);
  r.active = tf > tn;
  const float seg = r.active ? tf - tn : 0.0f;
  r.entry = {ol.x + tn * r.dl.x, ol.y + tn * r.dl.y, ol.z + tn * r.dl.z};
  r.jit = wavefront_draw(P.seed, 0u, (uint32_t)i);
  r.step = seg / (float)(N.jitter ? N.steps : N.steps - 1);
  return r;
}

// Step j of the march: its point's corners and weights, dsigma/draw, the
// emission, dt and alpha_recip (1 on the last step); advances t_a.
struct NerfQuery {
  int64_t idx[8];
  float w[8];
  float dact, dt, ar;
  V3 em;
};

__host__ __device__ inline void nerf_query(const NerfParams& N, const NerfRay& r, int j,
                                           float& t_a, NerfQuery& q) {
  const PrimalParams& P = N.P;
  const float t_b = r.step * ((float)(j + 1) + (N.jitter ? r.jit : 0.0f));
  q.dt = t_b - t_a;
  t_a = t_b;
  const V3 p = {r.entry.x + t_b * r.dl.x, r.entry.y + t_b * r.dl.y,
                r.entry.z + t_b * r.dl.z};
  corners(P, p, q.idx, q.w);
  float acc[4];
  for (int k = 0; k < 8; ++k) {
    float v[4];
    load4(P.grid + q.idx[k] * 4, v);
    for (int c = 0; c < 4; ++c) acc[c] = k == 0 ? v[c] * q.w[0] : fmaf(v[c], q.w[k], acc[c]);
  }
  const float raw = acc[0] * P.scale;
  const float sig = N.relu ? fmaxf(raw, 0.0f) : raw;
  q.dact = N.relu ? (raw > 0.0f ? 1.0f : 0.0f) : 1.0f;
  q.em = {acc[1], acc[2], acc[3]};
  if (N.emission_scaled) q.em = {q.em.x * P.scale, q.em.y * P.scale, q.em.z * P.scale};
  q.ar = j + 1 < N.steps ? exp_r(-sig * q.dt) : 1.0f;
}

// The primal radiance of ray i into P.L (and its valid flag).
__host__ __device__ inline void nerf_primal_lane(const NerfParams& N, int64_t i) {
  const PrimalParams& P = N.P;
  const NerfRay r = nerf_setup(N, i);
  V3 result = {0.0f, 0.0f, 0.0f};
  float thr = 1.0f, wsum = 0.0f, t_a = 0.0f;
  if (r.active) {
    NerfQuery q;
    for (int j = 0; j < N.steps; ++j) {
      nerf_query(N, r, j, t_a, q);
      const float weight = (1.0f - q.ar) * thr;
      result = {result.x + weight * q.em.x, result.y + weight * q.em.y,
                result.z + weight * q.em.z};
      thr = thr * (q.ar + 1e-10f);
      wsum = wsum + weight;
    }
  }
  const V3 bg = emitter_eval(P, load3(P.d, i));
  const bool valid = !N.hide_emitters || wsum > 0.0f;
  const float f = 1.0f - wsum;
  result = {result.x + (valid ? f * bg.x : 0.0f), result.y + (valid ? f * bg.y : 0.0f),
            result.z + (valid ? f * bg.z : 0.0f)};
  store3(P.L, i, result);
  if (N.valid) N.valid[i] = valid;
}

// The path-replay adjoint of ray i: adds its cotangents into N.g_grid.
__host__ __device__ inline void nerf_adjoint_lane(const NerfParams& N, int64_t i) {
  const PrimalParams& P = N.P;
  const NerfRay r = nerf_setup(N, i);
  if (!r.active) return;
  V3 result = load3(N.L_in, i);
  const V3 dL = load3(N.dL, i);
  float thr = 1.0f, t_a = 0.0f;
  NerfQuery q;
  for (int j = 0; j < N.steps; ++j) {
    nerf_query(N, r, j, t_a, q);
    const bool last = j + 1 >= N.steps;
    const float weight = (1.0f - q.ar) * thr;
    const float sar = q.ar + 1e-10f;
    // result now holds the later steps' and the background's terms
    result = {result.x - weight * q.em.x, result.y - weight * q.em.y,
              result.z - weight * q.em.z};
    thr = thr * sar;
    V3 ce = {dL.x * weight, dL.y * weight, dL.z * weight};
    if (N.emission_scaled) ce = {ce.x * P.scale, ce.y * P.scale, ce.z * P.scale};
    // thr is already multiplied by sar: thr / sar is the throughput of weight
    const float dalpha = last ? 0.0f : q.dt * q.ar;
    const float a = thr / sar * dalpha, b = dalpha / sar;
    const float x0 = dL.x * (q.em.x * a - result.x * b);
    const float x1 = dL.y * (q.em.y * a - result.y * b);
    const float x2 = dL.z * (q.em.z * a - result.z * b);
    const float cs = ((x0 + x1) + x2) * q.dact * P.scale;
    if (cs == 0.0f && ce.x == 0.0f && ce.y == 0.0f && ce.z == 0.0f) continue;
    for (int k = 0; k < 8; ++k)
      add4(N.g_grid + q.idx[k] * 4, q.w[k] * cs, q.w[k] * ce.x, q.w[k] * ce.y,
           q.w[k] * ce.z);
  }
}

}  // namespace uivr
