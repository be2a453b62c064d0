"""The environment variables that change the reference's result, read by the
port where the reference reads them, on the CPU:

- ``UIVR_KERNEL_TM``: ``MediumConfig.kernel_majorant_max_cells``, read when
  a config is made; the supergrid equals JAX's under it;
- ``UIVR_TEA_DRAW_ROUNDS``: the lane draws' TEA rounds, read when
  ``core/rng.py`` is imported; a fresh import under it draws bit for bit
  the reference's ``tea(..., rounds=4)``;
- ``UIVR_RENDER_CHUNK``: ``render_image``'s rays per chunk (and so its
  per-chunk seeds), read per call; the image is the one of that chunk
  argument, which ``tests/test_torch_render.py`` holds against the
  reference's.
"""
import importlib.util

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_common import both_scenes
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from uivr_tpu.config import smoke_scene
from uivr_tpu.core import rng as jrng
from uivr_tpu.scene.medium import MediumConfig as JMediumConfig
from uivr_tpu.scene.medium import MediumParams as JMediumParams
from uivr_tpu.scene.medium import finalize_medium as j_finalize
from uivr_tpu_torch.core import rng as trng
from uivr_tpu_torch.integrators import VolpathConfig
from uivr_tpu_torch.render import RenderSettings, render_image
from uivr_tpu_torch.scene.medium import MediumConfig, MediumParams, finalize_medium


@pytest.mark.parametrize("budget,dims", [("4096", (13, 13, 13)), ("64", (4, 4, 4))])
def test_kernel_tm_env_sets_the_supergrid(budget, dims, monkeypatch):
    """Both packages' supergrid under MediumConfig's default budget with
    the variable set (unset, 2048 coarsens the 13^3 cells to 7^3)."""
    monkeypatch.setenv("UIVR_KERNEL_TM", budget)
    assert MediumConfig().kernel_majorant_max_cells == int(budget)
    sigma = np.random.RandomState(1).rand(53, 53, 53, 1).astype(np.float32)
    alb = np.full(sigma.shape[:3] + (3,), 0.5, np.float32)
    jm = j_finalize(JMediumParams(jnp.asarray(sigma), jnp.asarray(alb), jnp.asarray(alb)),
                    JMediumConfig(majorant_factor=4))
    tm = finalize_medium(MediumParams(torch.from_numpy(sigma), torch.from_numpy(alb),
                                      torch.from_numpy(alb)),
                         MediumConfig(majorant_factor=4))
    assert tuple(tm.majorant_grid.shape) == tuple(jm.majorant_grid.shape) == dims
    np.testing.assert_array_equal(np.asarray(jm.majorant_grid), tm.majorant_grid.numpy())


def test_tea_draw_rounds_env_read_at_import(monkeypatch):
    """A fresh copy of core/rng.py imported under the variable draws with 4
    TEA rounds; the package's own import keeps its 5."""
    monkeypatch.setenv("UIVR_TEA_DRAW_ROUNDS", "4")
    spec = importlib.util.spec_from_file_location("uivr_tpu_torch.core._rng_env", trng.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod._DRAW_ROUNDS == 4 and trng._DRAW_ROUNDS == 5
    ts = mod.make_lane_sampler(42, n_lanes=777, device="cpu")
    tu, _ = mod.lane_next_1d(ts)
    bits, _ = jrng.tea(jnp.asarray(ts.h.numpy().astype(np.uint32)),
                       jnp.asarray(ts.dim.numpy().astype(np.uint32)), rounds=4)
    np.testing.assert_array_equal(np.asarray(jrng._to_unit_float(bits)), tu.numpy())
    five, _ = trng.lane_next_1d(ts)
    assert not torch.equal(five, tu)


def test_render_chunk_env_read_per_call(monkeypatch):
    """A 16 x 12 film at 2 spp without a chunk argument: under the variable
    the port's image is the chunk=192 image bit for bit (two chunks, two
    seeds), not the one-chunk image (test_render_image_matches_jax holds
    the chunked render against the reference's)."""
    tb = both_scenes(smoke_scene(res=16, resx=32, resy=32, n_sensors=2))[1]
    ts = RenderSettings(integrator=VolpathConfig(max_depth=2), medium=tb.medium_cfg,
                        film_size=(16, 12), spp=2, spp_grad=2)
    args = (tb.params, tb.emitter, tb.cameras, 1)
    whole = render_image(ts, *args, medium_to_world=tb.to_world, seed=5)
    chunked = render_image(ts, *args, medium_to_world=tb.to_world, seed=5, chunk=192)
    monkeypatch.setenv("UIVR_RENDER_CHUNK", "192")
    img = render_image(ts, *args, medium_to_world=tb.to_world, seed=5)
    np.testing.assert_array_equal(img, chunked)
    assert not np.array_equal(img, whole)
