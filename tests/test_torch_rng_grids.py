"""The port's RNG and grids against the JAX package, on the CPU.

RNG streams must be bit-exact (the port's paths depend on every draw);
trilinear lookups agree to 1e-6 and majorant supergrids exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from uivr_tpu.core import grids as jgrids
from uivr_tpu.core import rng as jrng
from uivr_tpu.scene.medium import MediumConfig as JMediumConfig
from uivr_tpu.scene.medium import MediumParams as JMediumParams
from uivr_tpu.scene.medium import finalize_medium as j_finalize
from uivr_tpu_torch.core import grids as tgrids
from uivr_tpu_torch.core import rng as trng
from uivr_tpu_torch.scene.medium import MediumConfig, MediumParams, finalize_medium


def _u32_pairs(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 2 ** 32, n, dtype=np.int64),
            rs.randint(0, 2 ** 32, n, dtype=np.int64))


@pytest.mark.parametrize("rounds", [4, 5, 6, 8])
def test_tea_bit_exact(rounds):
    a, b = _u32_pairs(4096, rounds)
    j0, j1 = jrng.tea(jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32), rounds)
    t0, t1 = trng.tea(torch.from_numpy(a), torch.from_numpy(b), rounds)
    np.testing.assert_array_equal(np.asarray(j0).astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64), t1.numpy())


def test_tea_scalars_and_negative_int32_bits():
    """Python-int seeds hash on the host; int32 bit patterns read as uint32."""
    for v0, v1 in [(1234, 22), (0xFFFFFFFF, 5), (7070, 0x5151)]:
        j = jrng.sample_tea_32(jnp.uint32(v0), jnp.uint32(v1))
        assert trng.sample_tea_32(v0, v1) == (int(j[0]), int(j[1]))
    x = torch.tensor([-1, -2 ** 31], dtype=torch.int32)
    u = torch.tensor([2 ** 32 - 1, 2 ** 31], dtype=torch.int64)
    assert torch.equal(trng.tea(x, 9)[0], trng.tea(u, 9)[0])


def test_wavefront_sampler_next_2d_bit_exact():
    js = jrng.make_sampler(jnp.uint32(0xC0FFEE), n_lanes=1000)
    ts = trng.make_sampler(0xC0FFEE, n_lanes=1000, device="cpu")
    for _ in range(3):
        ju, js = jrng.next_2d(js)
        tu, ts = trng.next_2d(ts)
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    assert ts.dim == int(js.dim)


def test_lane_sampler_consume_masks_bit_exact():
    js = jrng.make_lane_sampler(jnp.uint32(42), n_lanes=777)
    ts = trng.make_lane_sampler(42, n_lanes=777, device="cpu")
    np.testing.assert_array_equal(np.asarray(js.h).astype(np.int64), ts.h.numpy())
    rs = np.random.RandomState(0)
    for _ in range(6):
        m = rs.rand(777) < 0.6
        ju, js = jrng.lane_next_1d(js, consume=jnp.asarray(m))
        tu, ts = trng.lane_next_1d(ts, consume=torch.from_numpy(m))
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    np.testing.assert_array_equal(np.asarray(js.dim).astype(np.int64), ts.dim.numpy())
    jf, tf = jrng.lane_fork(js, 0x9E3779B9), trng.lane_fork(ts, 0x9E3779B9)
    np.testing.assert_array_equal(np.asarray(jf.h).astype(np.int64), tf.h.numpy())
    assert trng._DRAW_ROUNDS == jrng._DRAW_ROUNDS == 5


@pytest.mark.parametrize("shape", [(5, 6, 7), (1, 4, 3), (9, 9, 9)])
def test_trilinear_sample(shape):
    rs = np.random.RandomState(sum(shape))
    data = rs.rand(*shape, 4).astype(np.float32)
    p = (rs.rand(2000, 3) * 1.2 - 0.1).astype(np.float32)   # incl. outside
    ref = np.asarray(jgrids.trilinear_sample(jnp.asarray(data), jnp.asarray(p)))
    out = tgrids.trilinear_sample(torch.from_numpy(data), torch.from_numpy(p))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def _both_media(sigma, factor, scale=3.0, max_cells=2048):
    alb = np.full(sigma.shape[:3] + (3,), 0.5, np.float32)
    T = np.diag([2.0, 3.0, 4.0, 1.0]).astype(np.float32)
    T[:3, 3] = [-1.0, 0.5, 0.25]
    jm = j_finalize(JMediumParams(jnp.asarray(sigma), jnp.asarray(alb), jnp.asarray(alb)),
                    JMediumConfig(majorant_factor=factor, scale=scale,
                                  kernel_majorant_max_cells=max_cells), T)
    tm = finalize_medium(MediumParams(torch.from_numpy(sigma), torch.from_numpy(alb),
                                      torch.from_numpy(alb)),
                         MediumConfig(majorant_factor=factor, scale=scale,
                                      kernel_majorant_max_cells=max_cells), T)
    return jm, tm


@pytest.mark.parametrize("res,factor,max_cells", [
    (17, 4, 2048),    # non-divisible: 16 node intervals, 4 per cell
    (23, 5, 2048),    # 22 node intervals over 5 cells
    (53, 4, 2048),    # 13^3 cells > 2048: coarsened to factor 8
    (10, 8, 2048),    # factor shrunk to 2 (min_side // f >= 4)
    (3, 8, 2048),     # too small: one global majorant
    (33, 2, 0),       # budget off: the requested factor stands
])
def test_majorant_grid_exact(res, factor, max_cells):
    rs = np.random.RandomState(res + factor)
    sigma = rs.rand(res, res, res, 1).astype(np.float32)
    jm, tm = _both_media(sigma, factor, max_cells=max_cells)
    np.testing.assert_array_equal(np.asarray(jm.majorant_grid), tm.majorant_grid.numpy())
    np.testing.assert_array_equal(np.asarray(jm.world_to_local), tm.world_to_local.numpy())


def test_majorant_coarsening_hits_budget():
    sigma = np.random.RandomState(1).rand(53, 53, 53, 1).astype(np.float32)
    _, tm = _both_media(sigma, 4)
    assert tuple(tm.majorant_grid.shape) == (7, 7, 7)
    assert tgrids.majorant_dims((53, 53, 53), 4) == (13, 13, 13)
