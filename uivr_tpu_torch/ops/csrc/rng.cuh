// TEA hash and unit float (K1): the counter-based RNG of the port.
//
// Replaces the in-kernel TEA of uivr_tpu/ops/volpath_step.py (tea_i32,
// _unit_float) and the wavefront Sampler's next_1d (uivr_tpu/core/
// rng.py:83-92).  uint32 arithmetic, bit-identical to uivr_tpu_torch/core/
// rng.py.  Host and device inlines, so a host compiler can build the lane
// logic too (define __host__ and __device__ empty there).
#pragma once
#include <cstdint>

namespace uivr {

constexpr uint32_t kTeaDelta = 0x9E3779B9u;
constexpr uint32_t kTeaK0 = 0xA341316Cu, kTeaK1 = 0xC8013EA4u,
                   kTeaK2 = 0xAD90777Du, kTeaK3 = 0x7E95761Eu;

__host__ __device__ inline void tea(uint32_t& v0, uint32_t& v1, int rounds) {
  uint32_t s = 0;
  for (int r = 0; r < rounds; ++r) {
    s += kTeaDelta;
    v0 += ((v1 << 4) + kTeaK0) ^ (v1 + s) ^ ((v1 >> 5) + kTeaK1);
    v1 += ((v0 << 4) + kTeaK2) ^ (v0 + s) ^ ((v0 >> 5) + kTeaK3);
  }
}

// uint32 -> float in [0, 1) from the top 24 bits
__host__ __device__ inline float unit_float(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// Per-lane stream: h = hash(seed, lane), one draw per counter value.
struct LaneRng {
  uint32_t h;
  uint32_t dim;
  int rounds;

  __host__ __device__ void init(uint32_t lane, uint32_t seed, int draw_rounds) {
    uint32_t v0 = lane, v1 = seed;
    tea(v0, v1, 6);
    h = v0 ^ v1;
    dim = 0;
    rounds = draw_rounds;
  }
  // the draw at counter d, without advancing
  __host__ __device__ float at(uint32_t d) const {
    uint32_t v0 = h, v1 = d;
    tea(v0, v1, rounds);
    return unit_float(v0);
  }
  // the draw at the current counter; the counter advances iff `consume`
  __host__ __device__ float next(bool consume) {
    const float u = at(dim);
    dim += consume ? 1u : 0u;
    return u;
  }
  // a decorrelated stream of the same lane (lane_fork), counter at 0
  __host__ __device__ LaneRng fork(uint32_t salt) const {
    uint32_t v0 = h, v1 = salt;
    tea(v0, v1, 6);
    LaneRng r;
    r.h = v0 ^ v1;
    r.dim = 0;
    r.rounds = rounds;
    return r;
  }
};

// The wavefront Sampler's draw at shared counter `dim` for lane `lane`:
// a scalar pre-hash of (dim, seed), then a hash against the lane id.
__host__ __device__ inline float wavefront_draw(uint32_t seed, uint32_t dim,
                                                uint32_t lane) {
  uint32_t h0 = dim, h1 = seed;
  tea(h0, h1, 4);
  uint32_t v0 = lane, v1 = h0 ^ h1;
  tea(v0, v1, 8);
  return unit_float(v0);
}

}  // namespace uivr
