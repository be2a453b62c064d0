"""The port's render path against the JAX package, on the CPU: full-frame
``render_image``, the chunked batch render, the EXR writer and the CLI."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_common import both_scenes
from uivr_tpu.config import smoke_scene
from uivr_tpu.core import exr_io as j_exr
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.render import RenderSettings as JSettings
from uivr_tpu.render import make_render as j_make_render
from uivr_tpu.render import render_image as j_render_image
from uivr_tpu_torch.cli import render as cli_render
from uivr_tpu_torch.core import exr_io as t_exr
from uivr_tpu_torch.integrators import VolpathConfig
from uivr_tpu_torch.render import RenderSettings, render_batch, render_image


@pytest.fixture(scope="module")
def smoke():
    jb = smoke_scene(res=16, resx=32, resy=32, n_sensors=2)
    return jb, both_scenes(jb)[1]


def _settings(jb, tb, film, spp, **kw):
    js = JSettings(integrator=JCfg(max_depth=4), medium=jb.medium_cfg,
                   film_size=film, spp=spp, spp_grad=spp, **kw)
    ts = RenderSettings(integrator=VolpathConfig(max_depth=4), medium=tb.medium_cfg,
                        film_size=film, spp=spp, spp_grad=spp, **kw)
    return js, ts


def test_render_image_matches_jax(smoke):
    """16 x 12 film at 2 spp, in chunks of 64 rays (per-chunk seeds)."""
    jb, tb = smoke
    js, ts = _settings(jb, tb, (16, 12), 2)
    kw = dict(seed=5, chunk=64)
    ref = j_render_image(js, jb.params, jb.emitter, jb.cameras, 1,
                         medium_to_world=jb.to_world, **kw)
    img = render_image(ts, tb.params, tb.emitter, tb.cameras, 1,
                       medium_to_world=tb.to_world, **kw)
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    agree = np.mean(np.all(np.abs(img - ref) < 1e-5, axis=-1))
    assert agree >= 0.90, agree
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.05)


def test_render_batch_spp_chunks_match_jax(smoke):
    """Above max_rays_per_pass the batch renders in spp chunks whose seeds
    (tea(seed, 7070 + c), tea(tea(seed, 22), 1000 + c)) match the
    reference's."""
    jb, tb = smoke
    js, ts = _settings(jb, tb, (32, 32), 8, max_rays_per_pass=256)
    rs = np.random.RandomState(6)
    sidx = rs.randint(0, 2, 64)
    pix = rs.randint(0, 32, (64, 2))
    ref = j_make_render(js, jb.to_world)(
        jb.params, jb.emitter, jb.cameras, jnp.asarray(sidx, jnp.int32),
        jnp.asarray(pix, jnp.int32), jnp.uint32(11), jnp.uint32(12))
    img = render_batch(ts, tb.params, tb.emitter, tb.cameras, torch.from_numpy(sidx),
                       torch.from_numpy(pix), 11, medium_to_world=tb.to_world)
    ref = np.asarray(ref)
    agree = np.mean(np.all(np.abs(img.numpy() - ref) < 1e-5, axis=-1))
    assert agree >= 0.90, agree
    np.testing.assert_allclose(img.numpy().mean(), ref.mean(), rtol=0.05)


@pytest.mark.parametrize("channels,compression", [(3, "zip"), (1, "none"), (4, "zips")])
def test_exr_byte_identical(tmp_path, channels, compression):
    img = np.random.RandomState(channels).rand(37, 21, channels).astype(np.float32)
    img[::5] = 0.25      # compressible rows too
    a, b = tmp_path / "jax.exr", tmp_path / "port.exr"
    j_exr.write_exr(str(a), img, compression)
    t_exr.write_exr(str(b), img, compression)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(j_exr.read_exr(str(b)), img)
    np.testing.assert_array_equal(t_exr.read_exr(str(a)), img)


def test_cli_render_on_cpu(tmp_path, capsys):
    out = tmp_path / "r.exr"
    img, _ = cli_render.main(["--scene", "tiny-cube", "--spp", "1", "--scale", "0.125",
                              "--device", "cpu", "--out", str(out)])
    line = capsys.readouterr().out
    assert "[render]" in line and "8x8 @ 1 spp" in line and "Mrays/s" in line
    np.testing.assert_array_equal(t_exr.read_exr(str(out)), img)
    assert np.isfinite(img).all() and img.mean() > 0
