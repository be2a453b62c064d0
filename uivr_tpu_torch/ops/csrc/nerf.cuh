// The NeRF bootstrap stage's march (uivr_tpu_torch/integrators/nerf.py),
// primal and path-replay adjoint, one ray a call, in two forms:
//
// - nerf_primal_lane, nerf_adjoint_lane: the one-ray-per-thread kernels
//   *_direct_kernel, kept to compare with;
// - NerfPrimalTask, NerfAdjointTask (a query a step): the main path's
//   kernels, over the rays that nerf_compact_lane found inside the box.
//
// The march reads one interleaved (D, H, W, 4) grid [sigma (unscaled),
// emission rgb], so a corner is one float4 load; the adjoint adds each
// step's sigma and emission cotangents into a (D, H, W, 4) gradient grid of
// the same layout, one 4-wide add a corner.  The arithmetic repeats the
// plain version operation for operation (float64 exp rounded once, the
// trilinear fma chain of core/grids.py, no other contraction: build with
// --fmad=false), and the jitter is the wavefront sampler's first draw
// (wavefront_draw at counter 0, lane = ray index), so a lane computes the
// plain version's bits.  The main path's form computes the same cells and
// weights (nerf_cell) in an index type Idx, int32_t or, for grids of 2^29
// voxels and more (whose float offsets pass 2^31), int64_t, and reads a
// cell's corners once while the queries stay in it; its adjoint sums a ray's cotangents in
// registers while its queries stay in one cell and, when they move to a
// neighbouring cell, adds only the corners they leave: the primal's bits
// stay the same, the adjoint's sums change order.
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
  int32_t* order;            // (n,) scratch: the rays inside the box (main path)
  unsigned long long* listed;    // (1,) scratch: how many order holds
  unsigned long long* atomics;   // (1,) global atomics issued (counting builds), or null
  double* g_grid64;          // (D, H, W, 4) float64 sums of the direct adjoint's terms, or null
  int32_t steps, jitter, relu, emission_scaled, hide_emitters;
  int32_t index64;           // march in int64_t offsets even below 2^29 voxels (main path)
};

// Whether grid (D, H, W)'s float offsets need 64 bits: D*H*W*4 >= 2^31.
__host__ __device__ inline bool nerf_needs_index64(const PrimalParams& P) {
  return (int64_t)P.D * P.H * P.W * 4 >= ((int64_t)1 << 31);
}

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

// the same add into float64 sums (the direct adjoint's reference build)
__host__ __device__ inline void add4(double* a, float x, float y, float z, float w) {
#if defined(__CUDA_ARCH__)
  atomicAdd(a, (double)x);
  atomicAdd(a + 1, (double)y);
  atomicAdd(a + 2, (double)z);
  atomicAdd(a + 3, (double)w);
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

// The far end t_b of query j and its local point.
__host__ __device__ inline V3 nerf_point(const NerfParams& N, const NerfRay& r, int j,
                                         float& t_b) {
  t_b = r.step * ((float)(j + 1) + (N.jitter ? r.jit : 0.0f));
  return {r.entry.x + t_b * r.dl.x, r.entry.y + t_b * r.dl.y, r.entry.z + t_b * r.dl.z};
}

// Step j of the march: its point's corners and weights, dsigma/draw, the
// emission, dt and alpha_recip (1 on the last step); advances t_a.
struct NerfQuery {
  int64_t idx[8];
  float w[8];
  float dact, dt, ar;
  V3 em;
};

// A query's sigma activation, its emission and alpha_recip from the
// trilinear sums acc = [raw sigma, emission rgb].
__host__ __device__ inline void nerf_shade(const NerfParams& N, int j, const float acc[4],
                                           float& dact, V3& em, float dt, float& ar) {
  const PrimalParams& P = N.P;
  const float raw = acc[0] * P.scale;
  const float sig = N.relu ? fmaxf(raw, 0.0f) : raw;
  dact = N.relu ? (raw > 0.0f ? 1.0f : 0.0f) : 1.0f;
  em = {acc[1], acc[2], acc[3]};
  if (N.emission_scaled) em = {em.x * P.scale, em.y * P.scale, em.z * P.scale};
  ar = j + 1 < N.steps ? exp_r(-sig * dt) : 1.0f;
}

__host__ __device__ inline void nerf_query(const NerfParams& N, const NerfRay& r, int j,
                                           float& t_a, NerfQuery& q) {
  const PrimalParams& P = N.P;
  float t_b;
  const V3 p = nerf_point(N, r, j, t_b);
  q.dt = t_b - t_a;
  t_a = t_b;
  corners(P, p, q.idx, q.w);
  float acc[4];
  for (int k = 0; k < 8; ++k) {
    float v[4];
    load4(P.grid + q.idx[k] * 4, v);
    for (int c = 0; c < 4; ++c) acc[c] = k == 0 ? v[c] * q.w[0] : fmaf(v[c], q.w[k], acc[c]);
  }
  nerf_shade(N, j, acc, q.dact, q.em, q.dt, q.ar);
}

// The primal radiance of ray i from its march's sums, with the background,
// into P.L (and its valid flag).
__host__ __device__ inline void nerf_primal_write(const NerfParams& N, int64_t i, V3 result,
                                                  float wsum) {
  const PrimalParams& P = N.P;
  const V3 bg = emitter_eval(P, load3(P.d, i));
  const bool valid = !N.hide_emitters || wsum > 0.0f;
  const float f = 1.0f - wsum;
  result = {result.x + (valid ? f * bg.x : 0.0f), result.y + (valid ? f * bg.y : 0.0f),
            result.z + (valid ? f * bg.z : 0.0f)};
  store3(P.L, i, result);
  if (N.valid) N.valid[i] = valid;
}

// The primal radiance of ray i into P.L (and its valid flag).
__host__ __device__ inline void nerf_primal_lane(const NerfParams& N, int64_t i) {
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
  nerf_primal_write(N, i, result, wsum);
}

// One query's sigma and emission cotangents (cs, ce) in the path-replay
// adjoint; updates result (the later steps' and the background's terms)
// and thr.
__host__ __device__ inline void nerf_cotangents(const NerfParams& N, int j, float dact, V3 em,
                                                float dt, float ar, V3 dL, V3& result,
                                                float& thr, float& cs, V3& ce) {
  const PrimalParams& P = N.P;
  const bool last = j + 1 >= N.steps;
  const float weight = (1.0f - ar) * thr;
  const float sar = ar + 1e-10f;
  // result now holds the later steps' and the background's terms
  result = {result.x - weight * em.x, result.y - weight * em.y, result.z - weight * em.z};
  thr = thr * sar;
  ce = {dL.x * weight, dL.y * weight, dL.z * weight};
  if (N.emission_scaled) ce = {ce.x * P.scale, ce.y * P.scale, ce.z * P.scale};
  // thr is already multiplied by sar: thr / sar is the throughput of weight
  const float dalpha = last ? 0.0f : dt * ar;
  const float a = thr / sar * dalpha, b = dalpha / sar;
  const float x0 = dL.x * (em.x * a - result.x * b);
  const float x1 = dL.y * (em.y * a - result.y * b);
  const float x2 = dL.z * (em.z * a - result.z * b);
  cs = ((x0 + x1) + x2) * dact * P.scale;
}

// The path-replay adjoint of ray i: adds its cotangents into N.g_grid (kF64:
// the same terms into N.g_grid64), one 4-wide add a corner and query;
// `adds` (or null) counts them.
template <bool kF64 = false>
__host__ __device__ inline void nerf_adjoint_lane(const NerfParams& N, int64_t i,
                                                  unsigned long long* adds = nullptr) {
  const NerfRay r = nerf_setup(N, i);
  if (!r.active) return;
  V3 result = load3(N.L_in, i);
  const V3 dL = load3(N.dL, i);
  float thr = 1.0f, t_a = 0.0f;
  NerfQuery q;
  for (int j = 0; j < N.steps; ++j) {
    nerf_query(N, r, j, t_a, q);
    float cs;
    V3 ce;
    nerf_cotangents(N, j, q.dact, q.em, q.dt, q.ar, dL, result, thr, cs, ce);
    if (cs == 0.0f && ce.x == 0.0f && ce.y == 0.0f && ce.z == 0.0f) continue;
    for (int k = 0; k < 8; ++k) {
      if (kF64) {
        add4(N.g_grid64 + q.idx[k] * 4, q.w[k] * cs, q.w[k] * ce.x, q.w[k] * ce.y,
             q.w[k] * ce.z);
      } else {
        add4(N.g_grid + q.idx[k] * 4, q.w[k] * cs, q.w[k] * ce.x, q.w[k] * ce.y,
             q.w[k] * ce.z);
      }
    }
    if (adds) *adds += 8;
  }
}

// ---------------------------------------------------------------------------
// The main path's kernels' march, one listed ray a thread.

// Whether ray i enters the medium's box; the primal writes a ray that
// misses at once (its background and valid flag), as nerf_primal_lane does.
__host__ __device__ inline bool nerf_compact_lane(const NerfParams& N, int64_t i, bool primal) {
  const NerfRay r = nerf_setup(N, i);
  if (!r.active && primal) nerf_primal_write(N, i, {0.0f, 0.0f, 0.0f}, 0.0f);
  return r.active;
}

// A query's cell: its voxel (x, y, z), the index of its corner 0 in Idx
// (int32_t below 2^29 voxels, int64_t from there: nerf_needs_index64) and
// its 8 trilinear weights, by corners()' float operations (the same bits).
// Corner k lies at base + the strides of the set bits of k
// (NerfMarch::corner).
template <class Idx>
struct NerfCell {
  Idx base;
  int32_t x, y, z;
  float w[8];
};

template <class Idx>
__host__ __device__ inline void nerf_cell(const PrimalParams& P, V3 p, NerfCell<Idx>& c) {
  const int dims[3] = {P.W, P.H, P.D};
  float f[3];
  int32_t i0[3];
  for (int a = 0; a < 3; ++a) {
    const float res = (float)(dims[a] - 1);
    const float x = clampf(comp(p, a), 0.0f, 1.0f) * res;
    const float i0f = fminf(fmaxf(floorf(x), 0.0f), fmaxf(res - 1.0f, 0.0f));
    f[a] = res > 0.0f ? x - i0f : 0.0f;
    i0[a] = (int32_t)i0f;
  }
  const float fx = f[0], fy = f[1], fz = f[2];
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  c.w[0] = gz * gy * gx; c.w[1] = gz * gy * fx; c.w[2] = gz * fy * gx; c.w[3] = gz * fy * fx;
  c.w[4] = fz * gy * gx; c.w[5] = fz * gy * fx; c.w[6] = fz * fy * gx; c.w[7] = fz * fy * fx;
  c.x = i0[0];
  c.y = i0[1];
  c.z = i0[2];
  c.base = ((Idx)i0[2] * P.H + i0[1]) * P.W + i0[0];
}

// One ray's march, a query a call: query j's cell is `cur`; a query in the
// cell of the one before reads its corners from registers (the same
// values, so the same bits) instead of loading them again.
template <class Idx>
struct NerfMarch {
  NerfRay r;
  Idx sx, sy, sz;        // corner strides (zero on an axis of one voxel)
  int j;                 // the query to run
  float t_a;
  NerfCell<Idx> cur;
  Idx held;              // the cell whose corners v holds (-1: none)
  float v[8][4];

  __host__ __device__ void strides(const PrimalParams& P) {
    sx = P.W > 1 ? 1 : 0;
    sy = P.H > 1 ? P.W : 0;
    sz = P.D > 1 ? (Idx)P.H * P.W : 0;
  }
  __host__ __device__ Idx corner(Idx base, int k) const {
    return base + ((k & 4) ? sz : 0) + ((k & 2) ? sy : 0) + ((k & 1) ? sx : 0);
  }
  __host__ __device__ void cell_of(const NerfParams& N, int q, NerfCell<Idx>& c) const {
    float t_b;
    nerf_cell(N.P, nerf_point(N, r, q, t_b), c);
  }
  // ray i, which enters the box
  __host__ __device__ void start(const NerfParams& N, int64_t i) {
    r = nerf_setup(N, i);
    j = 0;
    t_a = 0.0f;
    held = -1;
    cell_of(N, 0, cur);
  }
  // query j: dact, the emission, dt and alpha_recip (nerf_query's)
  __host__ __device__ void query(const NerfParams& N, float& dact, V3& em, float& dt,
                                 float& ar) {
    float t_b;
    nerf_point(N, r, j, t_b);
    dt = t_b - t_a;
    t_a = t_b;
    if (cur.base != held) {
      for (int k = 0; k < 8; ++k) load4(N.P.grid + corner(cur.base, k) * 4, v[k]);
      held = cur.base;
    }
    float acc[4];
    for (int k = 0; k < 8; ++k)
      for (int c = 0; c < 4; ++c) acc[c] = k == 0 ? v[0][c] * cur.w[0]
                                                  : fmaf(v[k][c], cur.w[k], acc[c]);
    nerf_shade(N, j, acc, dact, em, dt, ar);
  }
  // on to query j + 1
  __host__ __device__ void advance(const NerfParams& N) {
    ++j;
    if (j < N.steps) cell_of(N, j, cur);
  }
};

// The primal lane of nerf_primal_kernel: listed ray order[i], a query a
// step (the kernel loops over its steps).
template <class Idx>
struct NerfPrimalTask {
  const NerfParams& N;
  NerfMarch<Idx> m;
  int64_t ray;
  V3 result;
  float thr, wsum;

  __host__ __device__ explicit NerfPrimalTask(const NerfParams& n) : N(n) { m.strides(n.P); }
  __host__ __device__ void begin(int64_t i) {
    ray = N.order[i];
    m.start(N, ray);
    result = {0.0f, 0.0f, 0.0f};
    thr = 1.0f;
    wsum = 0.0f;
  }
  __host__ __device__ bool finished() const { return m.j >= N.steps; }
  __host__ __device__ void step() {
    float dact, dt, ar;
    V3 em;
    m.query(N, dact, em, dt, ar);
    const float weight = (1.0f - ar) * thr;
    result = {result.x + weight * em.x, result.y + weight * em.y, result.z + weight * em.z};
    thr = thr * (ar + 1e-10f);
    wsum = wsum + weight;
    m.advance(N);
  }
  __host__ __device__ void end() const { nerf_primal_write(N, ray, result, wsum); }
};

// The adjoint lane of nerf_adjoint_kernel: listed ray order[i], a query a
// step.  It holds the cotangent sums of the 8 corners of its open cell: a
// query adds into them while it stays in that cell.  When a query moves to
// a neighbouring cell, along each axis it moves on by one voxel the 4
// corners it leaves are sent and the sums of the 4 it keeps move to their
// new corner numbers; a longer move sends all 8, as does the end of the
// ray.  Sending a corner adds its sum, when not zero, into g_grid with one
// float4 atomic; kCount: `adds` counts them.
template <bool kCount, class Idx>
struct NerfAdjointTask {
  const NerfParams& N;
  NerfMarch<Idx> m;
  int64_t ray;
  V3 result, dL;
  float thr;
  Idx open;              // the open cell's base (-1: none)
  int32_t ox, oy, oz;    // its voxel
  float s[8][4];
  unsigned long long adds;

  __host__ __device__ explicit NerfAdjointTask(const NerfParams& n) : N(n), open(-1), adds(0) {
    m.strides(n.P);
    for (int k = 0; k < 8; ++k)
      for (int c = 0; c < 4; ++c) s[k][c] = 0.0f;
  }
  __host__ __device__ void begin(int64_t i) {
    ray = N.order[i];
    m.start(N, ray);
    result = load3(N.L_in, ray);
    dL = load3(N.dL, ray);
    thr = 1.0f;
  }
  __host__ __device__ bool finished() const { return m.j >= N.steps; }
  __host__ __device__ void send(int k) {
    if (s[k][0] != 0.0f || s[k][1] != 0.0f || s[k][2] != 0.0f || s[k][3] != 0.0f) {
      add4(N.g_grid + m.corner(open, k) * 4, s[k][0], s[k][1], s[k][2], s[k][3]);
      if (kCount) ++adds;
    }
    for (int c = 0; c < 4; ++c) s[k][c] = 0.0f;
  }
  __host__ __device__ void flush() {
    if (open < 0) return;
    for (int k = 0; k < 8; ++k) send(k);
    open = -1;
  }
  // the open cell (open >= 0) moves to cell c
  __host__ __device__ void move(const NerfCell<Idx>& c) {
    const int32_t d[3] = {c.x - ox, c.y - oy, c.z - oz};
    if (d[0] < -1 || d[0] > 1 || d[1] < -1 || d[1] > 1 || d[2] < -1 || d[2] > 1) {
      flush();
    } else {
      for (int a = 0; a < 3; ++a) {
        const int bit = 1 << a;
        const Idx stride = a == 0 ? m.sx : (a == 1 ? m.sy : m.sz);
        if (d[a] == 1) {          // corners without `bit` go, those with it take their place
          for (int k = 0; k < 8; ++k) {
            if (k & bit) continue;
            send(k);
            for (int q = 0; q < 4; ++q) {
              s[k][q] = s[k | bit][q];
              s[k | bit][q] = 0.0f;
            }
          }
          open += stride;
        } else if (d[a] == -1) {  // the other way round
          for (int k = 0; k < 8; ++k) {
            if (!(k & bit)) continue;
            send(k);
            for (int q = 0; q < 4; ++q) {
              s[k][q] = s[k ^ bit][q];
              s[k ^ bit][q] = 0.0f;
            }
          }
          open -= stride;
        }
      }
    }
    open = c.base;
    ox = c.x;
    oy = c.y;
    oz = c.z;
  }
  __host__ __device__ void step() {
    float dact, dt, ar, cs;
    V3 em, ce;
    const int j = m.j;
    m.query(N, dact, em, dt, ar);
    nerf_cotangents(N, j, dact, em, dt, ar, dL, result, thr, cs, ce);
    if (cs != 0.0f || ce.x != 0.0f || ce.y != 0.0f || ce.z != 0.0f) {
      if (m.cur.base != open) {
        if (open >= 0) {
          move(m.cur);
        } else {
          open = m.cur.base;
          ox = m.cur.x;
          oy = m.cur.y;
          oz = m.cur.z;
        }
      }
      for (int k = 0; k < 8; ++k) {
        const float w = m.cur.w[k];
        s[k][0] += w * cs;
        s[k][1] += w * ce.x;
        s[k][2] += w * ce.y;
        s[k][3] += w * ce.z;
      }
    }
    m.advance(N);
  }
  __host__ __device__ void end() { flush(); }
};

}  // namespace uivr
