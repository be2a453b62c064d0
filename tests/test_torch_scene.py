"""The port's scene layer against the JAX package, on the CPU: emitters,
phase sampling, cameras, procedural scenes, the registry and the bundle
carried across with ``bundle_from_numpy``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import both_scenes, bundle_to_numpy
from uivr_tpu.config import cube_test_scene as j_cube
from uivr_tpu.config import registry as jreg
from uivr_tpu.config import smoke_scene as j_smoke
from uivr_tpu.config.scenes import procedural_sky as j_sky
from uivr_tpu.render.batched import sample_batch_pixels as j_pixels
from uivr_tpu.scene import phase as jphase
from uivr_tpu.scene.camera import sample_rays as j_rays
from uivr_tpu.scene.emitters import make_envmap as j_envmap
from uivr_tpu_torch.config import registry as treg
from uivr_tpu_torch.config import scenes as tscenes
from uivr_tpu_torch.core.device import resolve_device
from uivr_tpu_torch.render.batched import sample_batch_pixels as t_pixels
from uivr_tpu_torch.scene import phase as tphase
from uivr_tpu_torch.scene.camera import sample_rays as t_rays
from uivr_tpu_torch.scene.emitters import make_envmap as t_envmap


@pytest.fixture(scope="module")
def smoke():
    return both_scenes(j_smoke(res=16, resx=32, resy=32, n_sensors=2))


@pytest.mark.parametrize("hw", [(64, 128), (9, 14)])
def test_make_envmap_tables_exact(hw):
    sky = j_sky(*hw)
    rot = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    je, te = j_envmap(sky, rot), t_envmap(sky, rot, device="cpu")
    for f in ("alias_tab", "row_pmf", "cond_pmf", "flat_data", "data", "to_world"):
        np.testing.assert_array_equal(np.asarray(getattr(je, f)), getattr(te, f).numpy(), f)


def test_envmap_queries(smoke):
    jsc, _, tsc = smoke
    rs = np.random.RandomState(1)
    u2 = rs.rand(4096, 2).astype(np.float32)
    d = rs.randn(4096, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    em = jsc.emitter
    # the reference's queries in one compiled program
    ref = jax.jit(lambda u, w: (*em.sample_direction(u), em.pdf_direction(w), em.eval(w)))(
        jnp.asarray(u2), jnp.asarray(d))
    te, tw = tsc.emitter, torch.from_numpy(d)
    got = (*te.sample_direction(torch.from_numpy(u2)), te.pdf_direction(tw), te.eval(tw))
    for r, g in zip(ref, got):     # direction, pdf, weight; pdf, radiance
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_constant_emitter_queries():
    jsc, _, tsc = both_scenes(j_cube(resx=16, resy=16))
    u2 = np.random.RandomState(2).rand(1024, 2).astype(np.float32)
    for j, t in zip(jax.jit(jsc.emitter.sample_direction)(jnp.asarray(u2)),
                    tsc.emitter.sample_direction(torch.from_numpy(u2))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("g", [0.0, 0.6, -0.3])
def test_phase_sample_and_eval(g):
    rs = np.random.RandomState(3)
    wi = rs.randn(2048, 3)
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    u1, u2 = (rs.rand(2048).astype(np.float32) for _ in range(2))

    @jax.jit      # the reference's sample and eval in one compiled program
    def ref(w, a, b):
        wo, pdf = jphase.phase_sample(jnp.float32(g), w, a, b)
        return wo, pdf, jphase.phase_eval(jnp.float32(g), w, wo)

    jwo, jpdf, jval = ref(jnp.asarray(wi), jnp.asarray(u1), jnp.asarray(u2))
    two, tpdf = tphase.phase_sample(float(np.float32(g)), torch.from_numpy(wi),
                                    torch.from_numpy(u1), torch.from_numpy(u2))
    np.testing.assert_allclose(two.numpy(), np.asarray(jwo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tphase.phase_eval(float(np.float32(g)), torch.from_numpy(wi), two).numpy(),
        np.asarray(jval), rtol=1e-5, atol=1e-6)


def test_sample_rays_exact(smoke):
    jsc, tb, _ = smoke
    rs = np.random.RandomState(4)
    uv = rs.rand(4096, 2).astype(np.float32)
    si = rs.randint(0, 2, 4096)
    jo, jd = j_rays(jsc.cameras, jnp.asarray(si, jnp.int32), jnp.asarray(uv))
    to, td = t_rays(tb.cameras, torch.from_numpy(si), torch.from_numpy(uv))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("sensors", [None, tuple(i for i in range(64) if i not in (52, 53))])
def test_sample_batch_pixels_exact(sensors):
    js, jp = j_pixels(jnp.uint32(9), 64, (180, 155), 4096, sensors=sensors)
    ts, tp = t_pixels(9, 64, (180, 155), 4096, sensors=sensors, device="cpu")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_procedural_scenes_match():
    for jb, tb in [(j_cube(resx=32, resy=24), tscenes.cube_test_scene(resx=32, resy=24, device="cpu")),
                   (j_smoke(res=12, resx=20, resy=16, n_sensors=3, seed=1),
                    tscenes.smoke_scene(res=12, resx=20, resy=16, n_sensors=3, seed=1, device="cpu"))]:
        for f in ("sigma_t", "albedo", "emission"):
            np.testing.assert_array_equal(getattr(tb.params, f).numpy(),
                                          np.asarray(getattr(jb.params, f)))
            np.testing.assert_array_equal(getattr(tb.start_from, f).numpy(),
                                          np.asarray(getattr(jb.start_from, f)))
        np.testing.assert_array_equal(tb.cameras.cam_to_world.numpy(),
                                      np.asarray(jb.cameras.cam_to_world))
        np.testing.assert_allclose(tb.cameras.tan_half_fov.numpy(),
                                   np.asarray(jb.cameras.tan_half_fov), rtol=1e-6)
        np.testing.assert_array_equal(tb.to_world, jb.to_world)
        assert tb.film_size == jb.film_size and tb.medium_cfg.scale == jb.medium_cfg.scale


def test_bundle_from_numpy_round_trip(smoke):
    _, tb, _ = smoke
    d = bundle_to_numpy(j_smoke(res=16, resx=32, resy=32, n_sensors=2))
    for k in ("sigma_t", "albedo", "emission"):
        np.testing.assert_array_equal(getattr(tb.params, k).numpy(), d[k])
    np.testing.assert_array_equal(tb.emitter.alias_tab.numpy(), d["env_alias_tab"])
    assert tb.medium_cfg.majorant_factor == d["majorant_factor"]
    assert tb.start_from is not None and tb.film_size == (32, 32)


def test_registry_matches_reference():
    assert treg.list_scene_configs() == jreg.list_scene_configs()
    assert treg.list_int_configs() == jreg.list_int_configs()
    for name in treg.list_scene_configs():
        t, j = treg.get_scene_config(name), jreg.get_scene_config(name)
        for f in ("builder_kwargs", "max_depth", "ref_spp", "ref_integrator",
                  "max_density", "sensors", "scene_xml", "start_from_value"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    for name in treg.list_int_configs():
        t, j = treg.get_int_config(name), jreg.get_int_config(name)
        assert (t.kind, t.params) == (j.kind, j.params)
        if t.kind == "volpath":
            assert t.create(64).__dict__ == j.create(64).__dict__
    with pytest.raises(NotImplementedError):
        treg.get_int_config("nerf").create(64)


def test_scene_preset_builds_stand_in_and_refuses_xml(tmp_path, monkeypatch):
    preset = treg.get_scene_config("janga-smoke")
    monkeypatch.setenv("UIVR_SCENE_DIR", str(tmp_path))
    (tmp_path / "janga-smoke" / "textures").mkdir(parents=True)
    (tmp_path / "janga-smoke" / "janga-smoke.xml").write_text("<scene/>")
    small = treg.ScenePreset(name="janga-small", builder=preset.builder,
                             builder_kwargs={**preset.builder_kwargs, "res": 8},
                             scene_xml=preset.scene_xml, scene_vars=preset.scene_vars,
                             sensors=preset.sensors)
    b = small.build(device="cpu")       # XML present, its assets absent
    assert b.cameras.n_sensors == 62 and b.sensors is None and b.film_size == (180, 155)
    (tmp_path / "janga-smoke" / "textures" / "gamrig_2k.hdr").write_bytes(b"")
    # with its assets present the XML is loaded, and this one has no sensor
    # (tests/test_torch_xml.py loads real ones)
    with pytest.raises(ValueError, match="no perspective sensors"):
        small.build(device="cpu")


def test_device_resolution():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
