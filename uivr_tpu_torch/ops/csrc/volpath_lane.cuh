// One lane of the volumetric path tracer (K2 + K3 + K3b + K7): the MAIN / SHADOW /
// DONE tracking state machine of uivr_tpu_torch/integrators/
// volpath_flat.py, run to completion for one ray.  The loop is a template
// on its hooks: PrimalHooks here give the primal estimate; AdjointHooks
// (volpath_adjoint.cuh) add the REPLAY walk and the gradient scatters of
// the adjoint on the same tracking step.
//
// Replaces uivr_tpu/ops/volpath_step.py:_step_kernel (adjoint=False,
// k_cand=1), the XLA trilinear gather around it (_sigma_albedo_planes) and
// the compaction rounds that run it: each thread owns one ray and loops over
// tracking events until the path ends, so there are no state planes and no
// chunk shuffles.  In front of the sigma fetch sits PRE's subcell
// classification (K6, :892-907): MAIN and SHADOW candidates that a
// per-subcell sigma bound decides skip the fetch; the draws and decisions
// are those of the fetch, so classification changes no path.  On an envmap
// with a coarse proxy (nee_H > 0) NEE takes the reference's deferred-
// radiance mode (K3b, :600-616 and _deferred_nee_fixup :1230): the
// direction and pdf come from the proxy's alias table, the radiance from
// the full-resolution texel the direction lands in, multiplied into the
// shadow weight after 1/pdf; escapes weigh MIS with the proxy's pdf.
// With k_cand > 1 a primal lane walks in K-candidate batches instead
// (lane_step_k, K7: the reference's k_cand > 1 specialisation).
//
// The arithmetic repeats the plain twin operation for operation (see
// uivr_tpu_torch/core/fmath.py): fmaf exactly where the twin fuses, float64
// transcendentals rounded once, and no other contraction (build with
// --fmad=false).  The draws are consumed in the twin's order and under its
// masks, so a lane walks the same path on both.
//
// Host and device inlines: a host compiler builds this file for the CPU
// tests with __host__ and __device__ defined empty.
#pragma once
#include <cmath>
#include <cstdint>

#include "rng.cuh"

namespace uivr {

// Mirrors uivr_tpu_torch/ops/volpath_step.py:PrimalParams (ctypes).
struct PrimalParams {
  const float* o;            // (n, 3) world ray origins
  const float* d;            // (n, 3) world ray directions
  float* L;                  // (n, 3) radiance out
  uint8_t* escaped;          // (n,) out
  uint32_t* dims;            // (n,) draws consumed, or null
  int32_t* steps;            // (n,) tracking steps, or null
  const float* grid;         // (D, H, W, 4) [sigma unscaled, albedo rgb]
  const float* majorant;     // (Dc, Hc, Wc), scaled
  const float* env_data;     // (eH, eW, 3)
  const float* env_alias;    // (eH*eW, 4) [prob, alias, pmf_self, pmf_alias]
  const float* env_row_pmf;  // (eH,)
  const float* env_cond_pmf; // (eH, eW)
  // K3b: the coarse proxy's tables, or null (nee_H == 0: full resolution)
  const float* nee_alias;    // (nH*nW, 4)
  const float* nee_row_pmf;  // (nH,)
  const float* nee_cond_pmf; // (nH, nW)
  // PathState entry (volpath_primal_state_kernel): lanes resume from these
  const uint8_t* ps_active;  // (n,)
  const int32_t* ps_depth;   // (n,)
  const float* ps_o;         // (n, 3) local position
  const float* ps_d_l;       // (n, 3) local direction
  const float* ps_d_w;       // (n, 3) world direction
  const float* ps_maxt;      // (n,)
  const float* ps_last_pdf;  // (n,)
  // K6: per-subcell sigma upper bound (Ds, Hs, Ws), scaled, or null (off)
  const float* sub;
  int32_t* cls_counts;       // (n, kClsCounters) K6 counters, or null
  int32_t* kc_counts;        // (n, kK7Counters) K7 counters, or null
  int64_t n;
  int32_t D, H, W, Dc, Hc, Wc, Ds, Hs, Ws, env_H, env_W, nee_H, nee_W;
  int32_t emitter;           // 0 constant, 1 envmap
  int32_t max_depth, rr_depth, max_steps, draw_rounds;
  int32_t use_nee, hide_emitters;
  int32_t k_cand, cross_steps;   // K7: candidates per batch, crossings each
  uint32_t seed;
  float scale, phase_g, shadow_rr, inv_shadow_rr;
  float w2l[12];             // world -> local, rows of the 3x4 affine part
  float env_to_world[9];     // 3x3 row-major
  float radiance[3];         // constant emitter
  float const_weight[3];     // constant emitter radiance / (1 / 4pi)
};

enum { DONE = 0, MAIN = 1, SHADOW = 2, REPLAY = 3 };
constexpr int kClsCounters = 5;   // per-lane K6 counters (LaneState)

constexpr float kInvFourPi = 0.07957747154594767f;   // 1 / (4 pi)
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kTwoPiSq = 19.739208802178716f;        // 2 pi^2
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kInvPi = 0.3183098861837907f;

struct V3 {
  float x, y, z;
};

__host__ __device__ inline float comp(const V3& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : v.z);
}

// float64 evaluation rounded once (core/fmath.py)
__host__ __device__ inline float sin_r(float x) { return (float)sin((double)x); }
__host__ __device__ inline float cos_r(float x) { return (float)cos((double)x); }
__host__ __device__ inline float sqrt_r(float x) { return (float)sqrt((double)x); }
__host__ __device__ inline float log1p_r(float x) { return (float)log1p((double)x); }
__host__ __device__ inline float exp_r(float x) { return (float)exp((double)x); }
__host__ __device__ inline float atan2_r(float y, float x) { return (float)atan2((double)y, (double)x); }
__host__ __device__ inline float acos_r(float x) { return (float)acos((double)x); }

__host__ __device__ inline float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__host__ __device__ inline void load4(const float* p, float out[4]) {
#ifdef __CUDA_ARCH__
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
#else
  out[0] = p[0]; out[1] = p[1]; out[2] = p[2]; out[3] = p[3];
#endif
}

// out_i = fma(v_2, m_i2, fma(v_1, m_i1, v_0 m_i0)); m row-major, `stride`
// floats per row (3 for a 3x3, 4 for the 3x4 affine part)
__host__ __device__ inline V3 xform_dir(const float* m, int stride, V3 v) {
  float r[3];
  for (int i = 0; i < 3; ++i) {
    const float* row = m + i * stride;
    r[i] = fmaf(v.z, row[2], fmaf(v.y, row[1], v.x * row[0]));
  }
  return {r[0], r[1], r[2]};
}

// world -> emitter-local for a rotation M: v @ M
__host__ __device__ inline V3 xform_dir_t(const float* m, V3 v) {
  float r[3];
  for (int j = 0; j < 3; ++j)
    r[j] = fmaf(v.z, m[6 + j], fmaf(v.y, m[3 + j], v.x * m[j]));
  return {r[0], r[1], r[2]};
}

// Slab test against [0,1]^3 (core/aabb.py:ray_unit_cube, tmin = 0)
__host__ __device__ inline void ray_unit_cube(V3 o, V3 d, float& t_near,
                                              float& t_far) {
  float lo = -INFINITY, hi = INFINITY;
  for (int a = 0; a < 3; ++a) {
    const float da = comp(d, a), oa = comp(o, a);
    const float safe = fabsf(da) < 1e-20f ? (da >= 0.0f ? 1e-20f : -1e-20f) : da;
    const float inv = 1.0f / safe;
    const float t0 = (0.0f - oa) * inv;
    const float t1 = (1.0f - oa) * inv;
    lo = fmaxf(lo, fminf(t0, t1));
    hi = fminf(hi, fmaxf(t0, t1));
  }
  t_near = fmaxf(lo, 0.0f);
  t_far = hi;
}

__host__ __device__ inline float exit_dist(V3 o, V3 d) {
  float tn, tf;
  ray_unit_cube(o, d, tn, tf);
  return tf;
}

__host__ __device__ inline float mis_weight(float a, float b) {
  const float a2 = a * a;
  const float w = a2 / fmaxf(a2 + b * b, 1e-30f);
  return a > 0.0f ? w : 0.0f;
}

// ---------------------------------------------------------------- phase
__host__ __device__ inline float hg_eval(float g, float cos_theta) {
  const float g2 = g * g;
  const float denom = (1.0f + g2) - (2.0f * g) * cos_theta;
  return (kInvFourPi * (1.0f - g2)) /
         fmaxf(denom * sqrt_r(fmaxf(denom, 1e-12f)), 1e-12f);
}

__host__ __device__ inline bool is_iso(float g) { return fabsf(g) < 1e-4f; }

__host__ __device__ inline float phase_eval(float g, V3 wi, V3 wo) {
  if (is_iso(g)) return kInvFourPi;
  return hg_eval(g, (wi.x * wo.x + wi.y * wo.y) + wi.z * wo.z);
}

__host__ __device__ inline V3 phase_sample(float g, V3 wi, float u1, float u2,
                                           float& pdf) {
  float ct;
  if (is_iso(g)) {
    ct = 1.0f - 2.0f * u1;
  } else {
    const float sqr = (1.0f - g * g) / ((1.0f - g) + (2.0f * g) * u1);
    ct = clampf(((1.0f + g * g) - sqr * sqr) / (2.0f * g), -1.0f, 1.0f);
  }
  const float st = sqrt_r(fmaxf(fmaf(-ct, ct, 1.0f), 0.0f));
  const float phi = kTwoPi * u2;
  // Duff et al. frame around wi
  const float sign = wi.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + wi.z);
  const float b = wi.x * wi.y * a;
  const V3 t = {fmaf(sign * (wi.x * wi.x), a, 1.0f), sign * b, -sign * wi.x};
  const V3 s = {b, fmaf(wi.y * wi.y, a, sign), -wi.y};
  const float A = st * cos_r(phi), B = st * sin_r(phi);
  V3 wo = {fmaf(ct, wi.x, fmaf(A, t.x, B * s.x)),
           fmaf(ct, wi.y, fmaf(A, t.y, B * s.y)),
           fmaf(ct, wi.z, fmaf(A, t.z, B * s.z))};
  const float nrm = sqrt_r(fmaf(wo.z, wo.z, fmaf(wo.y, wo.y, wo.x * wo.x)));
  wo = {wo.x / nrm, wo.y / nrm, wo.z / nrm};
  pdf = is_iso(g) ? kInvFourPi : hg_eval(g, ct);
  return wo;
}

// ---------------------------------------------------------------- emitters
__host__ __device__ inline void env_uv(const PrimalParams& P, V3 d, float& u,
                                       float& v) {
  const V3 dl = xform_dir_t(P.env_to_world, d);
  u = atan2_r(dl.z, dl.x) * kInvTwoPi;
  u = fmodf(u, 1.0f);
  if (u != 0.0f && u < 0.0f) u += 1.0f;
  v = acos_r(clampf(dl.y, -1.0f, 1.0f)) * kInvPi;
}

__host__ __device__ inline V3 emitter_eval(const PrimalParams& P, V3 d) {
  if (P.emitter == 0) return {P.radiance[0], P.radiance[1], P.radiance[2]};
  const int H = P.env_H, W = P.env_W;
  float u, v;
  env_uv(P, d, u, v);
  const float x = u * (float)W - 0.5f;
  const float y = clampf(v * (float)H - 0.5f, 0.0f, (float)H - 1.0f);
  const float x0 = floorf(x);
  const int64_t y0 = (int64_t)floorf(y);
  const float fx = x - x0, fy = y - (float)y0;
  int64_t x0i = ((int64_t)x0) % W;
  if (x0i < 0) x0i += W;
  const int64_t x1i = (x0i + 1) % W;
  const int64_t y1 = y0 + 1 < H - 1 ? y0 + 1 : H - 1;
  const float* c00 = P.env_data + (y0 * W + x0i) * 3;
  const float* c01 = P.env_data + (y0 * W + x1i) * 3;
  const float* c10 = P.env_data + (y1 * W + x0i) * 3;
  const float* c11 = P.env_data + (y1 * W + x1i) * 3;
  float r[3];
  for (int c = 0; c < 3; ++c) {
    const float top = fmaf(c00[c], 1.0f - fx, c01[c] * fx);
    const float bottom = fmaf(c10[c], 1.0f - fx, c11[c] * fx);
    r[c] = fmaf(top, 1.0f - fy, bottom * fy);
  }
  return {r[0], r[1], r[2]};
}

// The pdf NEE samples with: the proxy's under K3b, else the map's own.
__host__ __device__ inline float emitter_pdf(const PrimalParams& P, V3 d) {
  if (P.emitter == 0) return kInvFourPi;
  const bool proxy = P.nee_H > 0;
  const int H = proxy ? P.nee_H : P.env_H, W = proxy ? P.nee_W : P.env_W;
  const float* row_pmf = proxy ? P.nee_row_pmf : P.env_row_pmf;
  const float* cond_pmf = proxy ? P.nee_cond_pmf : P.env_cond_pmf;
  float u, v;
  env_uv(P, d, u, v);
  int64_t col = (int64_t)(u * (float)W);
  int64_t row = (int64_t)(v * (float)H);
  col = col < 0 ? 0 : (col > W - 1 ? W - 1 : col);
  row = row < 0 ? 0 : (row > H - 1 ? H - 1 : row);
  const float p_uv = ((row_pmf[row] * (float)H) * cond_pmf[row * W + col]) * (float)W;
  const float sin_theta = sin_r(clampf(v, 1e-4f, 0.9999f) * kPi);
  return p_uv / (kTwoPiSq * sin_theta);
}

// Direction, solid-angle pdf and weight of an emitter sample.  The weight
// is radiance / pdf, except under K3b (rad set): then it is 1/pdf, and the
// caller multiplies the full-resolution radiance rad[0..2] in after it.
__host__ __device__ inline V3 emitter_sample(const PrimalParams& P, float u0,
                                             float u1, float& pdf, V3& weight,
                                             const float*& rad) {
  rad = nullptr;
  if (P.emitter == 0) {
    const float z = 1.0f - 2.0f * u0;
    const float r = sqrt_r(fmaxf(fmaf(-z, z, 1.0f), 0.0f));
    const float phi = kTwoPi * u1;
    pdf = kInvFourPi;
    weight = {P.const_weight[0], P.const_weight[1], P.const_weight[2]};
    return {r * cos_r(phi), z, r * sin_r(phi)};
  }
  const bool proxy = P.nee_H > 0;
  const int64_t H = proxy ? P.nee_H : P.env_H, W = proxy ? P.nee_W : P.env_W;
  const int64_t N = H * W;
  const float scaled = u0 * (float)N;
  int64_t slot = (int64_t)scaled;
  slot = slot < 0 ? 0 : (slot > N - 1 ? N - 1 : slot);
  const float frac = scaled - (float)slot;
  float tab[4];
  load4((proxy ? P.nee_alias : P.env_alias) + slot * 4, tab);
  const bool keep = frac < tab[0];
  const int64_t texel = keep ? slot : (int64_t)tab[1];
  const float pmf = keep ? tab[2] : tab[3];
  const int64_t row = texel / W;
  const int64_t col = texel - row * W;
  const float u = ((float)col + u1) * (float)(1.0 / (double)W);
  const float dv = keep ? frac / fmaxf(tab[0], 1e-20f)
                        : (frac - tab[0]) / fmaxf(1.0f - tab[0], 1e-20f);
  const float v = ((float)row + clampf(dv, 0.0f, 0.999999f)) * (float)(1.0 / (double)H);
  const float phi = u * kTwoPi, theta = v * kPi;
  const float st = sin_r(theta);
  const V3 dl = {st * cos_r(phi), cos_r(theta), st * sin_r(phi)};
  const V3 d = xform_dir(P.env_to_world, 3, dl);
  const float sin_theta = sin_r(clampf(v, 1e-4f, 0.9999f) * kPi);
  pdf = (pmf * (float)N) / (kTwoPiSq * sin_theta);
  const float inv = fmaxf(pdf, 1e-20f);
  if (proxy) {   // K3b: the full-resolution texel under (u, v)
    const int64_t fh = P.env_H, fw = P.env_W;
    const int64_t cf = (int64_t)(u * (float)fw), rf = (int64_t)(v * (float)fh);
    rad = P.env_data + ((rf < fh - 1 ? rf : fh - 1) * fw + (cf < fw - 1 ? cf : fw - 1)) * 3;
    const float w = pdf > 0.0f ? 1.0f / inv : 0.0f;
    weight = {w, w, w};
    return d;
  }
  const float* val = P.env_data + texel * 3;
  weight = pdf > 0.0f ? V3{val[0] / inv, val[1] / inv, val[2] / inv} : V3{0.0f, 0.0f, 0.0f};
  return d;
}

// ---------------------------------------------------------------- medium
// Flat node indices and weights of the 8 trilinear corners at local point
// p, in corner order (core/grids.py:_corner_indices_weights).
__host__ __device__ inline void corners(const PrimalParams& P, V3 p,
                                        int64_t idx[8], float w[8]) {
  const int dims[3] = {P.W, P.H, P.D};
  float f[3];
  int64_t i0[3], i1[3];
  for (int a = 0; a < 3; ++a) {
    const float res = (float)(dims[a] - 1);
    const float x = clampf(comp(p, a), 0.0f, 1.0f) * res;
    const float i0f = fminf(fmaxf(floorf(x), 0.0f), fmaxf(res - 1.0f, 0.0f));
    f[a] = res > 0.0f ? x - i0f : 0.0f;
    i0[a] = (int64_t)i0f;
    const int64_t hi = (int64_t)fmaxf(res, 0.0f);
    i1[a] = i0[a] + 1 < hi ? i0[a] + 1 : hi;
  }
  const float fx = f[0], fy = f[1], fz = f[2];
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  w[0] = gz * gy * gx; w[1] = gz * gy * fx; w[2] = gz * fy * gx; w[3] = gz * fy * fx;
  w[4] = fz * gy * gx; w[5] = fz * gy * fx; w[6] = fz * fy * gx; w[7] = fz * fy * fx;
  const int64_t H = P.H, W = P.W;
  for (int k = 0; k < 8; ++k) {
    const int64_t iz = (k & 4) ? i1[2] : i0[2];
    const int64_t iy = (k & 2) ? i1[1] : i0[1];
    const int64_t ix = (k & 1) ? i1[0] : i0[0];
    idx[k] = (iz * H + iy) * W + ix;
  }
}

// Trilinear sigma (scaled) + albedo at local point p: 8 corner float4 reads,
// summed as a forward fma chain in corner order (core/grids.py).  With
// `load` false the sums run over zero corners: the loads are predicated,
// not branched around, so the fetches of a K7 batch sit in one basic block
// and can all be in flight together.
__host__ __device__ inline void sigma_albedo(const PrimalParams& P, V3 p, float& sig,
                                             V3& alb, bool load = true) {
  int64_t idx[8];
  float w[8];
  corners(P, p, idx, w);
  float acc[4];
  for (int k = 0; k < 8; ++k) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (load) load4(P.grid + idx[k] * 4, v);
    for (int c = 0; c < 4; ++c) acc[c] = k == 0 ? v[c] * w[0] : fmaf(v[c], w[k], acc[c]);
  }
  sig = acc[0] * P.scale;
  alb = {acc[1], acc[2], acc[3]};
}

// o + t d, fused in x and y only (core/fmath.py:ray_point)
__host__ __device__ inline V3 step_point(V3 o, float t, V3 d) {
  return {fmaf(t, d.x, o.x), fmaf(t, d.y, o.y), o.z + t * d.z};
}

// Supercell majorant and cell-exit parameter at walk position wt
__host__ __device__ inline float cell_step(const PrimalParams& P, V3 o, V3 wd,
                                           float wt, float& t_exit) {
  const float res[3] = {(float)P.Wc, (float)P.Hc, (float)P.Dc};
  const float eps = 1e-5f * (1.0f + fabsf(wt));
  const V3 p = step_point(o, wt + eps, wd);
  float cell[3];
  float te = INFINITY;
  for (int a = 0; a < 3; ++a) {
    cell[a] = fminf(fmaxf(floorf(clampf(comp(p, a), 0.0f, 0.9999999f) * res[a]), 0.0f),
                    res[a] - 1.0f);
    const float lo = cell[a] / res[a];
    const float hi = (cell[a] + 1.0f) / res[a];
    const float da = comp(wd, a), oa = comp(o, a);
    const float safe = fabsf(da) < 1e-20f ? (da >= 0.0f ? 1e-20f : -1e-20f) : da;
    te = fminf(te, fmaxf((lo - oa) / safe, (hi - oa) / safe));
  }
  t_exit = fmaxf(te, wt + eps);
  const int64_t cx = (int64_t)cell[0], cy = (int64_t)cell[1], cz = (int64_t)cell[2];
  return P.majorant[(cz * P.Hc + cy) * P.Wc + cx];
}

// K6: the subcell sigma bound at local point p (floor(clip(p) * dims))
__host__ __device__ inline float subcell_bound(const PrimalParams& P, V3 p) {
  const int64_t x = (int64_t)(clampf(p.x, 0.0f, 1.0f - 1e-7f) * (float)P.Ws);
  const int64_t y = (int64_t)(clampf(p.y, 0.0f, 1.0f - 1e-7f) * (float)P.Hs);
  const int64_t z = (int64_t)(clampf(p.z, 0.0f, 1.0f - 1e-7f) * (float)P.Ds);
  return P.sub[(z * P.Hs + y) * P.Ws + x];
}

// distance of a free-flight step against majorant sigma_maj
__host__ __device__ inline float free_step(float sigma_maj, float u) {
  return sigma_maj > 0.0f ? -log1p_r(-u) / fmaxf(sigma_maj, 1e-20f) : 1e30f;
}

__host__ __device__ inline V3 load3(const float* a, int64_t i) {
  return {a[3 * i], a[3 * i + 1], a[3 * i + 2]};
}

__host__ __device__ inline void store3(float* a, int64_t i, V3 v) {
  a[3 * i] = v.x;
  a[3 * i + 1] = v.y;
  a[3 * i + 2] = v.z;
}

// ---------------------------------------------------------------- the lane
// One ray's walk state (the twin's _FlatCarry for one lane).
struct LaneState {
  V3 o, d_l, d_w;            // segment origin (local), directions
  float t, maxt, last_pdf;
  int depth, mode, post_mode, steps;
  V3 thr, result;
  bool escaped, has_scattered;
  V3 sh_d, sh_base;          // shadow direction (local), contribution / Tr
  float sh_t, sh_tmax, sh_tr;
  LaneRng rng;
  // K6 counters: candidate collisions (every walk), MAIN null events,
  // classified MAIN nulls, classified SHADOW events, sigma fetches
  int32_t n_cand, n_main_null, n_cls_main, n_cls_sh, n_fetch;
};

// _init_carry for a world ray: enter the medium's unit cube
__host__ __device__ inline void init_from_ray(const PrimalParams& P, int64_t i,
                                              LaneState& s) {
  const V3 ow = load3(P.o, i), dw = load3(P.d, i);
  s.rng.init((uint32_t)i, P.seed, P.draw_rounds);
  V3 ol = xform_dir(P.w2l, 4, ow);
  ol = {ol.x + P.w2l[3], ol.y + P.w2l[7], ol.z + P.w2l[11]};
  s.d_l = xform_dir(P.w2l, 4, dw);
  float tn, tf;
  ray_unit_cube(ol, s.d_l, tn, tf);
  const bool active = (tn <= tf) && (tf > tn);
  s.o = {ol.x + tn * s.d_l.x, ol.y + tn * s.d_l.y, fmaf(tn, s.d_l.z, ol.z)};
  s.d_w = dw;
  s.t = 0.0f;
  s.maxt = active ? tf - tn : 0.0f;
  s.depth = 0;
  s.mode = active ? MAIN : DONE;
  s.escaped = !active;
  s.has_scattered = false;
  s.last_pdf = 1.0f;
}

// _init_carry for a PathState: a path resumed after a scatter
__host__ __device__ inline void init_from_state(const PrimalParams& P, int64_t i,
                                                LaneState& s) {
  s.rng.init((uint32_t)i, P.seed, P.draw_rounds);
  const bool active = P.ps_active[i] != 0;
  s.o = load3(P.ps_o, i);
  s.d_l = load3(P.ps_d_l, i);
  s.d_w = load3(P.ps_d_w, i);
  s.t = 0.0f;
  s.maxt = P.ps_maxt[i];
  s.depth = P.ps_depth[i];
  s.mode = active ? MAIN : DONE;
  s.escaped = false;
  s.has_scattered = active;
  s.last_pdf = P.ps_last_pdf[i];
}

__host__ __device__ inline void init_common(LaneState& s) {
  s.post_mode = MAIN;
  s.steps = 0;
  s.thr = {1.0f, 1.0f, 1.0f};
  s.result = {0.0f, 0.0f, 0.0f};
  s.sh_d = {0.0f, 0.0f, 0.0f};
  s.sh_base = {0.0f, 0.0f, 0.0f};
  s.sh_t = 0.0f;
  s.sh_tmax = 0.0f;
  s.sh_tr = 0.0f;
  s.n_cand = s.n_main_null = s.n_cls_main = s.n_cls_sh = s.n_fetch = 0;
}

__host__ __device__ inline void write_cls_counts(const PrimalParams& P, int64_t i,
                                                 const LaneState& s) {
  if (!P.cls_counts) return;
  int32_t* c = P.cls_counts + kClsCounters * i;
  c[0] = s.n_cand;
  c[1] = s.n_main_null;
  c[2] = s.n_cls_main;
  c[3] = s.n_cls_sh;
  c[4] = s.n_fetch;
}

// What one tracking event does to the lane (the twin's _event_effect): the
// SHADOW walk's transmittance and completion, or the MAIN walk's escape,
// real collision, Russian roulette, phase sampling and NEE setup.  The
// event is at t_cand (point p; sigma sig, albedo alb there; r = sig /
// sigma_maj), the walk moves on to t_next.
template <class Hooks>
__host__ __device__ inline void apply_event(const PrimalParams& P, LaneState& s,
                                            Hooks& h, bool is_sh, bool collided,
                                            bool fin_seg, float t_next, float t_cand,
                                            V3 p, float sig, float r, float ratio,
                                            V3 alb, float u_evt) {
  if (is_sh) {   // ratio tracking of the NEE shadow ray
    if (collided) {
      s.sh_tr = s.sh_tr * ratio;
      if (P.shadow_rr > 0.0f && s.sh_tr < P.shadow_rr && s.sh_tr > 0.0f)
        s.sh_tr = u_evt < s.sh_tr * P.inv_shadow_rr ? P.shadow_rr : 0.0f;
    }
    s.sh_t = t_next;
    if (fin_seg || s.sh_tr <= 0.0f) {
      const V3 c = {s.sh_base.x * s.sh_tr, s.sh_base.y * s.sh_tr,
                    s.sh_base.z * s.sh_tr};
      s.mode = h.shadow_done(P, s, c);
    }
    return;
  }

  // MAIN: delta tracking
  const bool real = collided && u_evt < r;
  s.n_main_null += (collided && !real) ? 1 : 0;
  h.main_event(P, s, real, fin_seg, t_cand, p, sig, alb);
  s.t = t_next;
  if (fin_seg) {
    s.escaped = true;
    s.mode = DONE;
  }
  if (!real) return;
  s.thr = {s.thr.x * alb.x, s.thr.y * alb.y, s.thr.z * alb.z};
  s.depth += 1;
  // the RR draw is taken on every real collision, even with RR off
  const float u_rr = s.rng.next(true);
  if (s.depth >= P.max_depth) {
    s.mode = DONE;
    return;
  }
  if (s.depth > P.rr_depth) {
    const float q = fminf(fmaxf(fmaxf(s.thr.x, s.thr.y), s.thr.z), 0.99f);
    const float qd = fmaxf(q, 1e-8f);
    s.thr = {s.thr.x / qd, s.thr.y / qd, s.thr.z / qd};
    if (u_rr >= q) {
      s.mode = DONE;
      return;
    }
  }

  // scatter: phase-sample the continuation (pdf and MIS use the incoming d_w)
  const V3 d_in = s.d_w;
  const float u_p1 = s.rng.next(true);
  const float u_p2 = s.rng.next(true);
  float ph_pdf;
  s.d_w = phase_sample(P.phase_g, d_in, u_p1, u_p2, ph_pdf);
  s.d_l = xform_dir(P.w2l, 4, s.d_w);
  s.last_pdf = ph_pdf;
  s.has_scattered = true;
  s.o = p;
  s.maxt = exit_dist(s.o, s.d_l);
  s.t = 0.0f;
  // a continuation with no room left ends the lane without escaping
  const int resume = s.maxt <= 1e-7f ? DONE : MAIN;

  if (P.use_nee) {
    const float u_e1 = s.rng.next(true);
    const float u_e2 = s.rng.next(true);
    float ds_pdf;
    V3 em_w;
    const float* rad;
    const V3 ds_d = emitter_sample(P, u_e1, u_e2, ds_pdf, em_w, rad);
    s.post_mode = resume;
    if (ds_pdf > 0.0f) {
      const float phv = phase_eval(P.phase_g, d_in, ds_d);
      const float k = phv * mis_weight(ds_pdf, phv);
      s.sh_d = xform_dir(P.w2l, 4, ds_d);
      s.sh_tmax = exit_dist(s.o, s.sh_d);
      s.sh_base = {(s.thr.x * k) * em_w.x, (s.thr.y * k) * em_w.y,
                   (s.thr.z * k) * em_w.z};
      if (rad) s.sh_base = {s.sh_base.x * rad[0], s.sh_base.y * rad[1], s.sh_base.z * rad[2]};
      s.sh_t = 0.0f;
      s.sh_tr = 1.0f;
      s.mode = SHADOW;
    } else {
      s.mode = resume;
    }
  } else {
    s.mode = resume;
  }
  h.scattered(s);
}

// One tracking event of a lane that is not DONE and has steps left (the
// body of trace_lane's loop; the persistent kernels call it directly, one
// event per warp iteration).  Hooks:
//   kAdjoint               REPLAY walks exist (adjoint only)
//   max_steps              tracking steps allowed per lane
//   shadow_done(s, c)      a shadow walk ended with contribution c; returns
//                          the lane's next mode
//   main_event(s, real, fin_seg, t_cand, p, sig, alb)
//                          a MAIN step, before the state changes
//   replay(s, ...)         one REPLAY step (adjoint only)
//   scattered(s)           after a scatter's draws
template <class Hooks>
__host__ __device__ inline void lane_step(const PrimalParams& P, LaneState& s, Hooks& h) {
  ++s.steps;
  const bool is_main = s.mode == MAIN, is_sh = s.mode == SHADOW;
  bool is_rp = false;
  if constexpr (Hooks::kAdjoint) is_rp = s.mode == REPLAY;
  const V3 wd = is_main ? s.d_l : s.sh_d;
  float wt = is_main ? s.t : s.sh_t;
  const float wmax = is_main ? s.maxt : s.sh_tmax;
  float u_step, u_evt;
  if constexpr (Hooks::kAdjoint) {
    if (is_rp) wt = h.rp_t;
  }
  float t_exit;
  const float sigma_maj = cell_step(P, s.o, wd, wt, t_exit);
  if (is_rp) {   // the shadow walk's draws, re-read at the replay counter
    if constexpr (Hooks::kAdjoint) {
      u_step = s.rng.at(h.rp_dim);
      u_evt = s.rng.at(h.rp_dim + 1u);
    }
  } else {
    u_step = s.rng.next(true);
    u_evt = s.rng.next(true);
  }
  const float t_cand = wt + free_step(sigma_maj, u_step);
  const float bound = fminf(t_exit, wmax);
  const bool collided = t_cand < bound;
  const bool fin_seg = !collided && t_exit >= wmax;
  const bool crossed = !collided && t_exit < wmax;
  const float t_next = collided ? t_cand : (crossed ? t_exit : wt);

  const V3 p = step_point(s.o, t_cand, wd);
  float sig = 0.0f, r = 0.0f, ratio = 1.0f;
  V3 alb = {0.0f, 0.0f, 0.0f};
  if (collided) {   // sigma and albedo matter only at a collision
    ++s.n_cand;
    // K6: a MAIN candidate with u_evt * sigma_maj >= hi(p) >= sigma(p) is
    // null, and a SHADOW candidate in a cell with hi == 0 has sigma == 0:
    // both decide as the fetch would, with sig = 0 and the same draws.
    // REPLAY always fetches (its cotangent needs sigma).
    bool cls = false;
    if (P.Ds > 0 && !is_rp) {
      const float hi = subcell_bound(P, p);
      cls = is_main ? u_evt * sigma_maj >= hi : hi <= 0.0f;
      if (cls) {
        if (is_main) ++s.n_cls_main; else ++s.n_cls_sh;
      }
    }
    if (!cls) {
      ++s.n_fetch;
      sigma_albedo(P, p, sig, alb);
      r = sigma_maj > 0.0f ? sig / fmaxf(sigma_maj, 1e-20f) : 0.0f;
      ratio = fmaxf(1.0f - r, 0.0f);
    }
  }

  if constexpr (Hooks::kAdjoint) {
    if (is_rp) {
      h.replay(P, s, p, sig, sigma_maj, ratio, collided, fin_seg, t_next, u_evt);
      return;
    }
  }
  apply_event(P, s, h, is_sh, collided, fin_seg, t_next, t_cand, p, sig, r, ratio,
              alb, u_evt);
}

// Whether the lane's walk is over: DONE, or out of tracking steps.
template <class Hooks>
__host__ __device__ inline bool lane_finished(const LaneState& s, const Hooks& h) {
  return s.mode == DONE || s.steps >= h.max_steps;
}

// The tracking loop: events until the lane's walk is over.
template <class Hooks>
__host__ __device__ inline void trace_lane(const PrimalParams& P, LaneState& s,
                                           Hooks& h) {
  while (!lane_finished(s, h)) lane_step(P, s, h);
}

// ---------------------------------------------------------------- K7
// K-candidate batching (uivr_tpu/ops/volpath_step.py, k_cand > 1: PRE
// :846-940, POST phase 0 :366-432, the K-row sigma gather :1277-1291), the
// twin's _emit_batch / _resolve_batch.  A dispatch is POST then PRE, the
// first one PRE only; the lane's cap counts dispatches.  PRE emits up to
// k_cand candidates of the walk null-assumed, each taking up to cross_steps
// cell steps of two draws; a segment end or a spent crossing budget stops
// the batch.  POST issues the sigma fetches of every collision candidate
// back to back (predicated, in one basic block: up to KMAX x 8 corner loads
// can be in flight, the card's counterpart of the reference's one K-row
// gather), then resolves the batch
// in order and presents the first terminal event (real MAIN collision,
// segment end or crossing, killed shadow walk), or the last null, to
// apply_event; candidates past it are discarded with their draws spent.
// K6 is off on this path, as in the reference.
enum { kCandNone = 0, kCandColl = 1, kCandSegEnd = 2, kCandCrossSpent = 3 };
constexpr int kK7Counters = 4;   // batches, cell steps, fetched, discarded

struct Cand {
  float t_cand, t_exit, smaj, u_evt;
  int kind;
};

// PRE: the lane's next batch into c[0 .. returned count).  One loop over
// the batch's cell steps (a warp then runs as many as its longest lane
// takes, not the sum of each candidate's longest); a candidate goes into
// its register slot by a select over the slots.
template <int KMAX>
__host__ __device__ inline int emit_batch(const PrimalParams& P, LaneState& s,
                                          Cand (&c)[KMAX], int32_t& cell_steps) {
  const bool is_main = s.mode == MAIN;
  if (!is_main && s.mode != SHADOW) return 0;
  const V3 wd = is_main ? s.d_l : s.sh_d;
  const float wmax = is_main ? s.maxt : s.sh_tmax;
  float nwt = is_main ? s.t : s.sh_t;
  const int cs = P.cross_steps > 1 ? P.cross_steps : 1;
  int nc = 0, k = 0;   // candidates emitted; cell steps of the current one
  while (nc < P.k_cand) {
    ++cell_steps;
    float t_exit;
    const float smaj = cell_step(P, s.o, wd, nwt, t_exit);
    const float u_step = s.rng.next(true);
    const float u_evt = s.rng.next(true);
    const float t_cand = nwt + free_step(smaj, u_step);
    const bool hit = t_cand < fminf(t_exit, wmax);
    const bool cross = !hit && t_exit < wmax;
    if (!hit && cross && k < cs - 1) {   // into the next cell, same candidate
      nwt = t_exit;
      ++k;
      continue;
    }
    const Cand cand = {t_cand, t_exit, smaj, u_evt,
                       hit ? kCandColl : (cross ? kCandCrossSpent : kCandSegEnd)};
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j == nc) c[j] = cand;
    }
    ++nc;
    k = 0;
    if (!hit) break;   // a segment end or a spent crossing budget ends the batch
    // null-assumed continuation (not after the batch's last candidate)
    if (nc < P.k_cand) nwt = t_cand;
  }
  if (is_main) s.t = nwt; else s.sh_t = nwt;
  return nc;
}

// A lane's batch between dispatches: its candidates, their count and the
// K7 counters (batches is set from the lane's steps when it ends).
template <int KMAX>
struct KBatch {
  Cand c[KMAX];
  int nc;
  int32_t cnt[kK7Counters];

  // the lane's first batch (PRE only), right after its ray starts
  __host__ __device__ void start(const PrimalParams& P, LaneState& s) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) c[j] = {0.0f, 0.0f, 0.0f, 0.0f, kCandNone};
    for (int k = 0; k < kK7Counters; ++k) cnt[k] = 0;
    nc = emit_batch<KMAX>(P, s, c, cnt[1]);
  }
};

// One K7 dispatch of a lane that is not DONE and has steps left: the
// batch's fetches, phase-0 resolution, apply_event and the next batch
// (the body of trace_lane_k's loop; PrimalKTask runs one per warp
// iteration).
template <int KMAX, class Hooks>
__host__ __device__ inline void lane_step_k(const PrimalParams& P, LaneState& s, Hooks& h,
                                            KBatch<KMAX>& b) {
  static_assert(!Hooks::kAdjoint, "K-candidate batching is primal only");
  ++s.steps;
  const bool is_main = s.mode == MAIN, is_sh = s.mode == SHADOW;
  const V3 wd = is_main ? s.d_l : s.sh_d;
  const float wt = is_main ? s.t : s.sh_t;
  const float wmax = is_main ? s.maxt : s.sh_tmax;
  const int nc = b.nc;
  const Cand* c = b.c;
  float sig[KMAX];
  V3 alb[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {   // the batch's fetches, back to back
    const bool coll = j < nc && c[j].kind == kCandColl;
    sigma_albedo(P, step_point(s.o, c[j].t_cand, wd), sig[j], alb[j], coll);
    b.cnt[2] += coll ? 1 : 0;
  }
  // phase 0: resolve in order; shadow multiplies (and roulette) applied
  float sh_tr = s.sh_tr;
  bool found = false;
  Cand pr = {0.0f, 0.0f, 0.0f, 0.0f, kCandNone};
  float p_sig = 0.0f;
  V3 p_alb = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j >= nc) continue;
    const bool coll = c[j].kind == kCandColl;
    if (found) {   // past the terminal: fetched, never used
      b.cnt[3] += coll ? 1 : 0;
      continue;
    }
    const float r = c[j].smaj > 0.0f ? sig[j] / fmaxf(c[j].smaj, 1e-20f) : 0.0f;
    bool term = c[j].kind >= kCandSegEnd;
    if (is_main) {
      term = term || (coll && c[j].u_evt < r);
    } else if (coll) {
      sh_tr = sh_tr * fmaxf(1.0f - r, 0.0f);
      if (P.shadow_rr > 0.0f && sh_tr < P.shadow_rr && sh_tr > 0.0f)
        sh_tr = c[j].u_evt < sh_tr * P.inv_shadow_rr ? P.shadow_rr : 0.0f;
      term = term || sh_tr <= 0.0f;
    }
    pr = c[j];
    p_sig = sig[j];
    p_alb = alb[j];
    found = term;
  }
  s.sh_tr = sh_tr;
  // the presented event; a shadow one takes sigma 0 (its multiply is done)
  const bool collided = pr.t_cand < fminf(pr.t_exit, wmax);
  const bool fin_seg = !collided && pr.t_exit >= wmax;
  const bool crossed = !collided && pr.t_exit < wmax;
  const float t_next = collided ? pr.t_cand : (crossed ? pr.t_exit : wt);
  const float sg = is_sh ? 0.0f : p_sig;
  const float r = pr.smaj > 0.0f ? sg / fmaxf(pr.smaj, 1e-20f) : 0.0f;
  apply_event(P, s, h, is_sh, collided, fin_seg, t_next, pr.t_cand,
              step_point(s.o, pr.t_cand, wd), sg, r, fmaxf(1.0f - r, 0.0f), p_alb,
              pr.u_evt);
  b.nc = emit_batch<KMAX>(P, s, b.c, b.cnt[1]);
}

// The primal lane's walk with batches of up to KMAX candidates; b gets
// the K7 counters.
template <int KMAX, class Hooks>
__host__ __device__ inline void trace_lane_k(const PrimalParams& P, LaneState& s, Hooks& h,
                                             KBatch<KMAX>& b) {
  b.start(P, s);
  while (!lane_finished(s, h)) lane_step_k<KMAX>(P, s, h, b);
}

// _finish: emitter radiance on escape, MIS-weighted against NEE (with the
// pdf NEE sampled: the proxy's under K3b); the radiance is full-resolution
__host__ __device__ inline V3 finish_radiance(const PrimalParams& P,
                                              const LaneState& s) {
  V3 L = s.result;
  bool active_e = s.escaped;
  if (P.hide_emitters) active_e = active_e && !(s.depth <= 0);
  if (active_e) {
    const V3 e = emitter_eval(P, s.d_w);
    if (P.use_nee) {
      const float epdf = s.has_scattered ? emitter_pdf(P, s.d_w) : 0.0f;
      const float w = mis_weight(s.last_pdf, epdf);
      L = {L.x + (s.thr.x * w) * e.x, L.y + (s.thr.y * w) * e.y,
           L.z + (s.thr.z * w) * e.z};
    } else {
      L = {L.x + s.thr.x * e.x, L.y + s.thr.y * e.y, L.z + s.thr.z * e.z};
    }
  }
  return L;
}

// The primal estimate: shadow walks add their contribution.
struct PrimalHooks {
  static constexpr bool kAdjoint = false;
  int max_steps;

  __host__ __device__ int shadow_done(const PrimalParams&, LaneState& s, V3 c) {
    s.result = {s.result.x + c.x, s.result.y + c.y, s.result.z + c.z};
    return s.post_mode;
  }
  __host__ __device__ void main_event(const PrimalParams&, const LaneState&, bool,
                                      bool, float, V3, float, V3) {}
  __host__ __device__ void scattered(const LaneState&) {}
};

__host__ __device__ inline void write_primal(const PrimalParams& P, int64_t i,
                                             const LaneState& s) {
  store3(P.L, i, finish_radiance(P, s));
  P.escaped[i] = s.escaped ? 1 : 0;
  if (P.dims) P.dims[i] = s.rng.dim;
  if (P.steps) P.steps[i] = s.steps;
  write_cls_counts(P, i, s);
}

// A primal lane's start on ray i: a world ray (from_state = false) or a
// PathState.
__host__ __device__ inline void primal_begin(const PrimalParams& P, int64_t i,
                                             bool from_state, LaneState& s) {
  if (from_state) {
    init_from_state(P, i, s);
  } else {
    init_from_ray(P, i, s);
  }
  init_common(s);
}

// One primal lane from a world ray (from_state = false) or a PathState.
__host__ __device__ inline void primal_lane(const PrimalParams& P, int64_t i,
                                            bool from_state) {
  LaneState s;
  primal_begin(P, i, from_state, s);
  PrimalHooks h{P.max_steps};
  trace_lane(P, s, h);
  write_primal(P, i, s);
}

// K7's outputs of ray i: the primal's and the K7 counters' row (batches:
// the lane's steps).
template <int KMAX>
__host__ __device__ inline void write_primal_k(const PrimalParams& P, int64_t i,
                                               const LaneState& s, const KBatch<KMAX>& b) {
  write_primal(P, i, s);
  if (P.kc_counts) {
    int32_t* row = P.kc_counts + kK7Counters * i;
    row[0] = s.steps;
    for (int k = 1; k < kK7Counters; ++k) row[k] = b.cnt[k];
  }
}

// One primal lane from a world ray with K-candidate batches (k_cand <= KMAX).
template <int KMAX>
__host__ __device__ inline void primal_lane_k(const PrimalParams& P, int64_t i) {
  LaneState s;
  init_from_ray(P, i, s);
  init_common(s);
  PrimalHooks h{P.max_steps};
  KBatch<KMAX> b;
  trace_lane_k<KMAX>(P, s, h, b);
  write_primal_k<KMAX>(P, i, s, b);
}

}  // namespace uivr
