"""The NeRF bootstrap stage of the port against the JAX package, on the CPU.

- the plain march (``uivr_tpu_torch/integrators/nerf.py``) against JAX's
  ``sample_primal`` / ``sample_adjoint`` at 128 queries a ray: L within
  1e-5 of max|L| (float32 rounding of two builds: XLA's exp and its fused
  multiply-adds against the port's float64-rounded exp and single-rounded
  products; measured about 2e-6), the sigma and emission gradients within
  1e-4 relative L1 (the same, summed over 128 steps; measured about 2e-6),
  albedo's exactly 0 (the march never touches it);
- ``csrc/nerf.cuh`` built with g++ against the plain version, lane for
  lane: L bit for bit on every lane but for rare ties of the float64 exp
  rounded to float32 (g++'s libm and PyTorch's vectorised exp may differ
  in the last bit of the double), so within 1e-6 of max|L|; gradients
  within 1e-6 relative L1, or sqrt(k) 2^-24 where that is larger, k the
  additions into a voxel (the kernel adds ray by ray, ``index_add_`` step
  by step: another summation order, whose float32 rounding walks as
  sqrt(k); measured 2e-7 on the 16^3 smoke, k = 128, and 2-3e-6 on the 3^3
  cube, k = 19,418, bound 8.3e-6);
- two ``run_optimization`` iterations of a NeRF stage on the cube fixture
  at batch 64: the same seeds and pixels, losses within 1e-3 relative and
  final sigma and emission grids within 1e-3 relative L1 (the march has no
  branch a rounding flips, so the two runs differ by rounding alone), and
  the autograd render op's emission gradient nonzero;
- ``cli.reproduce`` runs the reference's default stages, ``nerf`` then
  ``volpathsimple-drt`` (ROADMAP C5), and ``--shadow-rr`` leaves the NeRF
  stage's config alone;
- ``cli.render --checkpoint`` renders a checkpoint written by each
  package; ``disk_memo`` / ``pickle_cache`` / ``render_cache`` round-trip
  and a hit skips the call.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import both_scenes, bundle_to_numpy, camera_rays, host_library
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from uivr_tpu.config import cube_test_scene
from uivr_tpu.core import make_sampler as j_make_sampler
from uivr_tpu.integrators import NerfConfig as JNerfConfig
from uivr_tpu.integrators import nerf as j_nerf
from uivr_tpu.opt import loop as j_loop
from uivr_tpu.opt.loop import OptimizationConfig as JOptCfg
from uivr_tpu_torch.config import bundle_from_numpy
from uivr_tpu_torch.config import smoke_scene as t_smoke_scene
from uivr_tpu_torch.core import exr_io, vol_io
from uivr_tpu_torch.core.rng import make_sampler
from uivr_tpu_torch.integrators import NerfConfig, VolpathConfig, nerf
from uivr_tpu_torch.ops import nerf_step
from uivr_tpu_torch.opt import loop
from uivr_tpu_torch.opt.loop import OptimizationConfig, run_optimization
from uivr_tpu_torch.render.batched import RenderSettings, make_render
from uivr_tpu_torch.scene.camera import sample_rays as t_sample_rays
from uivr_tpu_torch.scene.medium import MediumParams
from uivr_tpu_torch.scene.medium import finalize_medium as t_finalize_medium
from uivr_tpu_torch.scene.scene import Scene as TScene

N_RAYS = 512
SEED = 7
CASES = (dict(), dict(activation="relu", jitter=False))


@pytest.fixture(scope="module")
def cube():
    """The cube fixture (constant emitter): (JAX scene, port scene, JAX
    rays, port rays)."""
    jb = cube_test_scene(resx=16, resy=16)
    jsc, _, tsc = both_scenes(jb)
    jr, tr = camera_rays(jb, N_RAYS)
    return jsc, tsc, jr, tr


def _port_smoke():
    """A 16^3 smoke with its envmap, built by the port alone, and N_RAYS
    camera rays of sensor 0."""
    b = t_smoke_scene(res=16, resx=16, resy=16, n_sensors=1, device="cpu")
    sc = TScene(t_finalize_medium(b.params, b.medium_cfg, b.to_world), b.emitter, b.cameras)
    uv = torch.from_numpy(np.random.RandomState(3).rand(N_RAYS, 2).astype(np.float32) * 0.6 + 0.2)
    o, d = t_sample_rays(b.cameras, torch.zeros(N_RAYS, dtype=torch.int64), uv)
    return sc, (o.contiguous(), d.contiguous())


def _dL(n=N_RAYS):
    return np.random.RandomState(1).randn(n, 3).astype(np.float32)


def _plain(cfg, tsc, o, d, dL=None, L=None):
    """The plain version's (L, valid) or its gradients."""
    if dL is None:
        L_, valid, _ = nerf.sample_primal(cfg, tsc, o, d, make_sampler(SEED, n_lanes=o.shape[0]))
        return L_, valid
    g, _ = nerf.sample_adjoint(cfg, tsc, o, d, make_sampler(SEED, n_lanes=o.shape[0]),
                               torch.from_numpy(dL), L)
    return g


def _rel_l1(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).sum() / max(np.abs(ref).sum(), 1e-30)


def test_plain_matches_jax(cube):
    """The plain primal and adjoint against JAX's on the cube, identity
    activation with jitter and relu without."""
    dL = _dL()
    jsc, tsc, (jo, jd), (o, d) = cube
    for kw in CASES:
        jcfg, tcfg = JNerfConfig(**kw), NerfConfig(**kw)

        @jax.jit
        def jax_run(o_, d_, dL_):
            L, valid, _ = j_nerf.sample_primal(jcfg, jsc, o_, d_,
                                               j_make_sampler(SEED, n_lanes=N_RAYS))
            g, _ = j_nerf.sample_adjoint(jcfg, jsc, o_, d_, j_make_sampler(SEED, n_lanes=N_RAYS),
                                         dL_, L)
            return L, valid, g
        Lj, vj, gj = jax.device_get(jax_run(jo, jd, jnp.asarray(dL)))
        Lt, vt = _plain(tcfg, tsc, o, d)
        assert np.abs(Lt.numpy() - Lj).max() <= 1e-5 * np.abs(Lj).max(), kw
        assert np.array_equal(vt.numpy(), vj)
        gt = _plain(tcfg, tsc, o, d, dL, torch.from_numpy(np.array(Lj)))
        for k in ("sigma_t", "emission"):
            assert np.abs(getattr(gj, k)).sum() > 0, (kw, k)
            assert _rel_l1(getattr(gt, k).numpy(), getattr(gj, k)) <= 1e-4, (kw, k)
        assert not gt.albedo.any() and not np.asarray(gj.albedo).any()


_HOST_SRC = r'''#define __host__
#define __device__
#include "nerf.cuh"
extern "C" {
int nerf_params_size() { return (int)sizeof(uivr::NerfParams); }
void nerf_primal_host(const uivr::NerfParams* p) {
  for (int64_t i = 0; i < p->P.n; ++i) uivr::nerf_primal_lane(*p, i);
}
void nerf_adjoint_host(const uivr::NerfParams* p) {
  for (int64_t i = 0; i < p->P.n; ++i) uivr::nerf_adjoint_lane(*p, i);
}
}
'''


def test_lane_logic_matches_plain(cube):
    """``nerf.cuh`` built with g++ against the plain version on every lane:
    the cube (constant emitter) and a 16^3 smoke (envmap), both
    configurations."""
    import ctypes

    from uivr_tpu_torch.ops import volpath_step
    lib = host_library(_HOST_SRC, "nerf-lane")
    lib.nerf_params_size.restype = ctypes.c_int
    assert lib.nerf_params_size() == ctypes.sizeof(volpath_step.NerfParams)
    dL = _dL()
    for name, (tsc, (o, d)) in (("cube", (cube[1], cube[3])), ("smoke", _port_smoke())):
        for kw in CASES:
            cfg = NerfConfig(**kw)
            grid = nerf_step.nerf_grid(tsc.medium)
            p = nerf_step.nerf_params(cfg, tsc, o, d, SEED, grid)
            L = torch.empty((N_RAYS, 3))
            valid = torch.empty((N_RAYS,), dtype=torch.bool)
            p.P.L, p.valid = L.data_ptr(), valid.data_ptr()
            lib.nerf_primal_host(ctypes.byref(p))
            Lp, vp = _plain(cfg, tsc, o, d)
            assert torch.equal(valid, vp)
            assert (L == Lp).all(dim=1).float().mean() >= 0.99, (name, kw)
            assert (L - Lp).abs().max() <= 1e-6 * Lp.abs().max(), (name, kw)
            g4 = torch.zeros_like(grid)
            dL_t = torch.from_numpy(dL)
            p.L_in, p.dL, p.g_grid = Lp.data_ptr(), dL_t.data_ptr(), g4.data_ptr()
            lib.nerf_adjoint_host(ctypes.byref(p))
            gp = _plain(cfg, tsc, o, d, dL, Lp)
            adds = N_RAYS * cfg.queries_per_ray * 8 / grid[..., 0].numel()
            tol = max(1e-6, adds ** 0.5 * 2.0 ** -24)
            assert _rel_l1(g4[..., :1], gp.sigma_t) <= tol, (name, kw)
            assert _rel_l1(g4[..., 1:], gp.emission) <= tol, (name, kw)


RUN = dict(spp=2, primal_spp_factor=2, n_iter=2, batch_size=64, preview_stride=0,
           checkpoint_stride=0, checkpoint_initial=False, render_initial=False,
           render_final=False)


def test_run_optimization_matches_jax(tmp_path):
    """Two NeRF iterations in each package: the same seeds and pixels,
    losses and final grids close; the render op's emission gradient."""
    jb = cube_test_scene(resx=16, resy=16)
    tb = bundle_from_numpy(bundle_to_numpy(jb), device="cpu")
    ref = np.random.RandomState(10).rand(1, 16, 16, 3).astype(np.float32)
    calls = {"jax": [], "port": []}

    def recording(make_step, out):
        def make(*a, **k):
            step = make_step(*a, **k)

            def run(*args):
                res = step(*args)
                out.append(dict(seeds=(int(args[7]), int(args[8])),
                                pixels=np.asarray(args[5]).astype(np.int64)))
                return res
            return run
        return make

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_loop, "_make_step", recording(j_loop._make_step, calls["jax"]))
        mp.setattr(loop, "_make_step", recording(loop._make_step, calls["port"]))
        j_loop.run_optimization(str(tmp_path / "jax"), JOptCfg(**RUN), jb, JNerfConfig(),
                                ref_images=ref, resume=False, verbose=False)
        final = run_optimization(str(tmp_path / "port"), OptimizationConfig(**RUN), tb,
                                 NerfConfig(), ref_images=ref, resume=False, verbose=False)
    assert [c["seeds"] for c in calls["port"]] == [c["seeds"] for c in calls["jax"]]
    for cj, ct in zip(calls["jax"], calls["port"]):
        assert np.array_equal(ct["pixels"], cj["pixels"])

    def losses_of(d):
        with open(d / "metrics.jsonl") as f:
            return [r["loss"] for r in map(json.loads, f) if "loss" in r]
    jl, tl = losses_of(tmp_path / "jax"), losses_of(tmp_path / "port")
    assert len(jl) == len(tl) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for key in ("sigma_t", "emission"):
        name = f"final-medium1_{key}.vol"
        a, _ = vol_io.read_vol(str(tmp_path / "jax" / "params" / name))
        b, _ = vol_io.read_vol(str(tmp_path / "port" / "params" / name))
        assert _rel_l1(b, a) <= 1e-3, key
        assert np.array_equal(b, getattr(final, key).numpy())
    assert not torch.equal(final.emission, tb.start_from.emission)

    st = RenderSettings(integrator=NerfConfig(), medium=tb.medium_cfg, film_size=tb.film_size,
                        spp=4, spp_grad=2)
    leaves = MediumParams(*[g.clone().requires_grad_(True) for g in tb.start_from])
    pix = torch.from_numpy(calls["port"][0]["pixels"])
    img = make_render(st, tb.to_world)(leaves, tb.emitter, tb.cameras,
                                       torch.zeros(pix.shape[0], dtype=torch.int64), pix, 3, 4)
    img.square().mean().backward()
    assert leaves.emission.grad.abs().sum() > 0 and leaves.sigma_t.grad.abs().sum() > 0
    assert not leaves.albedo.grad.any()


def test_reproduce_runs_the_reference_stages(tmp_path, monkeypatch):
    """C5: with no ``--integrator`` the port runs ``nerf`` then
    ``volpathsimple-drt``, as the reference does; ``--shadow-rr`` reaches
    the volpath stage only."""
    from uivr_tpu.cli import reproduce as j_reproduce  # noqa: F401  (its defaults below)
    from uivr_tpu_torch.cli import reproduce
    from uivr_tpu_torch.config import get_scene_config
    b = get_scene_config("tiny-cube").build(device="cpu")
    W, H = b.film_size
    refs = tmp_path / "refs"
    refs.mkdir()
    for s in range(b.cameras.n_sensors):
        exr_io.write_exr(str(refs / f"ref_{s:06d}.exr"), np.full((H, W, 3), 0.3, np.float32))
    stages = []

    def fake_run(out_dir, opt, bundle, int_cfg, **kw):
        stages.append((os.path.basename(out_dir), int_cfg))
        loop.save_checkpoint(os.path.join(out_dir, "params"), bundle.params, "final")
    monkeypatch.setattr(reproduce, "run_optimization", fake_run)
    reproduce.main(["--config", "tiny-cube", "--device", "cpu", "--shadow-rr", "0.1",
                    "--references", str(refs), "--outputs", str(tmp_path / "o")])
    assert [s for s, _ in stages] == ["nerf", "volpathsimple-drt"]
    assert stages[0][1] == NerfConfig(queries_per_ray=128)
    assert isinstance(stages[1][1], VolpathConfig) and stages[1][1].shadow_rr == 0.1
    # the reference's default, read from its parser's source
    import inspect
    assert 'default=["nerf", "volpathsimple-drt"]' in inspect.getsource(j_reproduce.main)


def test_render_checkpoint_and_caches(tmp_path):
    """``cli.render --checkpoint`` on a checkpoint of each package (the
    same grids give the same image); the cache utilities."""
    from uivr_tpu_torch.cli import render as cli_render
    from uivr_tpu_torch.utils.cache import disk_memo, pickle_cache, render_cache
    jb = cube_test_scene()
    rs = np.random.RandomState(3)
    grids = {k: (rs.rand(*np.shape(getattr(jb.params, k))) * 0.5).astype(np.float32)
             for k in ("sigma_t", "albedo", "emission")}
    j_loop.save_checkpoint(str(tmp_path / "jax"), type(jb.params)(**{
        k: jnp.asarray(v) for k, v in grids.items()}), "final")
    loop.save_checkpoint(str(tmp_path / "port"), MediumParams(**{
        k: torch.from_numpy(v) for k, v in grids.items()}), "final")
    imgs = []
    for who in ("jax", "port"):
        img, _ = cli_render.main(["--scene", "tiny-cube", "--integrator", "nerf", "--spp", "2",
                                  "--scale", "0.25", "--device", "cpu", "--checkpoint",
                                  str(tmp_path / who), "--prefix", "final",
                                  "--out", str(tmp_path / f"{who}.exr")])
        imgs.append(img)
    gt, _ = cli_render.main(["--scene", "tiny-cube", "--integrator", "nerf", "--spp", "2",
                             "--scale", "0.25", "--device", "cpu",
                             "--out", str(tmp_path / "gt.exr")])
    assert np.array_equal(imgs[0], imgs[1]) and np.isfinite(imgs[0]).all()
    assert not np.array_equal(imgs[0], gt)

    calls = []

    def make(x):
        calls.append(x)
        return {"x": x, "a": np.arange(3)}
    for memo in (pickle_cache(str(tmp_path / "c" / "v.pkl")),
                 disk_memo(str(tmp_path / "d" / "v.pkl"))):
        f = memo(make)
        first, again = f(1), f(2)
        assert again["x"] == 1 and np.array_equal(again["a"], first["a"])
    assert calls == [1, 1]
    img = rs.rand(4, 5, 3).astype(np.float32)

    def render():
        calls.append("render")
        return img
    r = render_cache(str(tmp_path / "r" / "i.exr"), verbose=False)(render)
    assert np.array_equal(r(), img) and np.array_equal(r(), img)
    assert calls == [1, 1, "render"]
