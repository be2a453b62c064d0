"""The nested engine of the port against the JAX package's, on the CPU.

- the wavefront sampler's ``fork`` (bit for bit) and ``clone``;
- ``free_flight`` and the adjoint form of ``transmittance`` on the same
  local rays and wavefront sampler: the same escapes and collision
  distances, the same final counter (the longest walk), the same scattered
  sigma_t gradient;
- ``volpathsimple.sample_primal`` at max_depth 4 with NEE on the cube
  fixture's 1,024 camera rays (``tests/pallas_common._setup``'s, seed 42):
  lane agreement and the final counter of the shared sampler;
- ``volpathsimple.sample_adjoint`` in its three forms (free-flight only,
  DRT on a reservoir-selected vertex, DRT on every segment) on one seed,
  by the relative L1 rule of the flat adjoint tests;
- ``reproduce --retries 1`` of the ``volpathsimple-drt-quadratic`` preset:
  a child that fails after its first full-state checkpoint is run again
  and resumes there, ending where an uninterrupted run ends.

Every lane of the nested engine draws from one sampler whose counter the
whole wavefront shares, so a draw-accounting fault shifts every lane (lane
agreement near 0, a different final counter), while a lane flipped at a
float tie (XLA:CPU's own log1p and fused multiply-adds) shifts the lanes
only if it was a loop's longest walk.  The failure messages print both
counters to tell the two apart.  Each JAX reference runs as one jitted
program; the adjoints replay the port's primal radiance, which spares a
second JAX primal compile.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import assert_lanes_agree, both_scenes, camera_rays
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from uivr_tpu.config import cube_test_scene
from uivr_tpu.core import aabb as jaabb
from uivr_tpu.core.rng import clone as j_clone
from uivr_tpu.core.rng import fork as j_fork
from uivr_tpu.core.rng import make_sampler as j_make_sampler
from uivr_tpu.core.rng import next_1d as j_next_1d
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.integrators import volpathsimple as jvps
from uivr_tpu.scene.gradients import finalize_accum as j_finalize
from uivr_tpu.scene.gradients import init_accum as j_init_accum
from uivr_tpu.tracking import free_flight as j_free_flight
from uivr_tpu.tracking import transmittance as j_transmittance
from uivr_tpu_torch.core import exr_io, vol_io
from uivr_tpu_torch.core.rng import clone, fork, make_sampler, next_1d
from uivr_tpu_torch.integrators import VolpathConfig, volpathsimple
from uivr_tpu_torch.scene.gradients import init_accum
from uivr_tpu_torch.tracking import free_flight, transmittance

SEED = 42
N = 1024
PRIMAL = dict(max_depth=4)
FORMS = {   # sample_adjoint's three forms
    "basic": dict(use_drt=False),
    "drt": dict(use_drt=True, use_drt_subsampling=True),
    "drt-quadratic": dict(use_drt=True, use_drt_subsampling=False),
}


def rel_l1(ref, x):
    ref, x = np.asarray(ref), np.asarray(x)
    return np.abs(ref - x).sum() / max(np.abs(ref).sum(), 1e-30)


@pytest.fixture(scope="module")
def cube():
    jb = cube_test_scene()
    jsc, _, tsc = both_scenes(jb)
    (jo, jd), (o, d) = camera_rays(jb, n=N)
    dL = np.random.RandomState(2).rand(N, 3).astype(np.float32) / N
    return dict(jsc=jsc, tsc=tsc, jo=jo, jd=jd, o=o, d=d, dL=dL)


@pytest.fixture(scope="module")
def port_primal(cube):
    """The port's primal radiance, final counter and escapes."""
    L, esc, s = volpathsimple.sample_primal(
        VolpathConfig(engine="nested", **PRIMAL), cube["tsc"], cube["o"], cube["d"],
        make_sampler(SEED, n_lanes=N))
    return L, esc, s.dim


def test_sampler_and_trackers_match_jax(cube):
    js = j_fork(j_make_sampler(jnp.uint32(77), n_lanes=N), 0x9E3779B9)
    ts = fork(make_sampler(77, n_lanes=N), 0x9E3779B9)
    assert (int(js.seed), int(js.dim)) == (ts.seed, ts.dim) and ts.dim == 0
    ju, _ = j_next_1d(j_clone(js))
    assert np.array_equal(np.asarray(ju), next_1d(clone(ts))[0].numpy())

    jm, tm = cube["jsc"].medium, cube["tsc"].medium
    rs = np.random.RandomState(5)
    o = rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    d = rs.randn(N, 3).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = rs.rand(N) < 0.9
    adj = rs.rand(N, 3).astype(np.float32)
    _, tf, _ = jaabb.ray_unit_cube(jnp.asarray(o), jnp.asarray(d), 0.0, jaabb.INF)
    J = [jnp.asarray(x) for x in (o, d, np.asarray(tf))]
    T = [torch.from_numpy(np.array(x)) for x in (o, d, np.asarray(tf))]
    ja, ta = jnp.asarray(active), torch.from_numpy(active)

    def jrun(o_, d_, mx, act, a):
        t, found, s = j_free_flight(jm, o_, d_, mx, j_make_sampler(jnp.uint32(77), n_lanes=N),
                                    act)
        tr, s, g = j_transmittance(jm, o_, d_, mx, s, act, adjoint=a,
                                   accum=j_init_accum(jm, need_emission=False))
        return t, found, tr, s.dim, j_finalize(g, jm).sigma_t
    jt, jf, jtr, jdim, jg = jax.jit(jrun)(*J, ja, jnp.asarray(adj))

    t, found, s = free_flight(tm, *T, make_sampler(77, n_lanes=N), ta)
    acc = init_accum(tm, need_emission=False)
    tr, s, acc = transmittance(tm, *T, s, ta, adjoint=torch.from_numpy(adj), accum=acc)

    jf, jt = np.asarray(jf), np.asarray(jt)
    assert int(jdim) == s.dim, f"final dim: JAX {int(jdim)}, port {s.dim}"
    assert np.mean(jf == found.numpy()) >= 0.99
    both = jf & found.numpy()
    assert both.sum() > 0.1 * N
    tt = t.numpy()[both]
    assert np.all(np.abs(jt[both] - tt) <= 1e-5 * np.abs(jt[both]))
    assert np.mean(np.abs(np.asarray(jtr) - tr.numpy()) <= 1e-5) > 0.975
    assert float(np.abs(np.asarray(jg)).sum()) > 0
    assert rel_l1(jg, acc.sigma.numpy()) <= 1e-4


def test_primal_matches_jax(cube, port_primal):
    jL, jesc, jdim = jax.jit(lambda o_, d_: jvps.sample_primal(
        JCfg(engine="nested", **PRIMAL), cube["jsc"], o_, d_,
        j_make_sampler(jnp.uint32(SEED), n_lanes=N)))(cube["jo"], cube["jd"])
    L, esc, dim = port_primal
    dims = f"final dim: JAX {int(jdim.dim)}, port {dim}"
    agree = assert_lanes_agree(np.asarray(jL), L.numpy())
    assert np.mean(np.asarray(jesc) == esc.numpy()) > 0.975, dims
    assert int(jdim.dim) == dim, f"{dims}, lane agreement {agree}"
    assert torch.isfinite(L).all() and (L > 0).any()


@pytest.mark.parametrize("form", list(FORMS))
def test_adjoint_matches_jax(form, cube, port_primal):
    kw = dict(PRIMAL, trans_grad_samples=2, **FORMS[form])
    L = port_primal[0]
    gj, sj = jax.jit(lambda dL, L_: jvps.sample_adjoint(
        JCfg(engine="nested", **kw), cube["jsc"], cube["jo"], cube["jd"],
        j_make_sampler(jnp.uint32(SEED), n_lanes=N), dL, L_))(
        jnp.asarray(cube["dL"]), jnp.asarray(L.numpy()))
    g, s = volpathsimple.sample_adjoint(
        VolpathConfig(engine="nested", **kw), cube["tsc"], cube["o"], cube["d"],
        make_sampler(SEED, n_lanes=N), torch.from_numpy(cube["dL"]), L)
    assert int(sj.dim) == s.dim, f"final dim: JAX {int(sj.dim)}, port {s.dim}"
    assert float(np.abs(np.asarray(gj.sigma_t)).sum()) > 0
    assert rel_l1(gj.sigma_t, g.sigma_t.numpy()) <= 0.05
    assert rel_l1(gj.albedo, g.albedo.numpy()) <= 0.05
    assert not g.emission.any()


def test_reproduce_retries_resumes_quadratic_preset(tmp_path, monkeypatch, capsys):
    """``--retries 1``: the supervisor runs the port's own CLI without
    ``--retries``; the first child fails after its first full-state
    checkpoint, the second resumes from it and ends where an uninterrupted
    run ends.  The children run in this process (``subprocess.call``
    replaced), at 4 iterations of 16 pixels."""
    from uivr_tpu_torch.cli import reproduce
    from uivr_tpu_torch.config import get_scene_config
    from uivr_tpu_torch.opt import loop

    make_opt = reproduce._opt_for
    monkeypatch.setattr(reproduce, "_opt_for", lambda *a: dataclasses.replace(
        make_opt(*a), n_iter=4, batch_size=16, spp=2, primal_spp_factor=1,
        checkpoint_stride=2, preview_stride=0, render_initial=False, render_final=False))
    b = get_scene_config("tiny-cube").build(device="cpu")
    W, H = max(16, b.film_size[0] // 4), max(16, b.film_size[1] // 4)
    refs = tmp_path / "refs"
    refs.mkdir()
    for s in range(b.cameras.n_sensors):
        exr_io.write_exr(str(refs / f"ref_{s:06d}.exr"), np.full((H, W, 3), 0.3, np.float32))

    def argv(out):
        return ["--config", "tiny-cube", "--integrator", "volpathsimple-drt-quadratic",
                "--device", "cpu", "--film-scale", "0.25", "--references", str(refs),
                "--outputs", str(out)]

    save_state = loop.save_state
    children, sleeps = [], []

    def failing_save_state(*a, **k):
        save_state(*a, **k)
        raise RuntimeError("injected failure after the first full-state checkpoint")

    def call(child):
        children.append(list(child))
        with monkeypatch.context() as m:
            if len(children) == 1:
                m.setattr(loop, "save_state", failing_save_state)
            try:
                reproduce.main(child[3:])
            except RuntimeError:
                return 1
        return 0

    monkeypatch.setattr(reproduce.subprocess, "call", call)
    monkeypatch.setattr(reproduce.time, "sleep", sleeps.append)
    with pytest.raises(SystemExit) as done:
        reproduce.main(argv(tmp_path / "o") + ["--retries", "1"])
    assert done.value.code == 0
    assert len(children) == 2 and sleeps == [30]
    for child in children:
        assert child == [sys.executable, "-m", "uivr_tpu_torch.cli.reproduce"] + argv(
            tmp_path / "o")
    assert "Resumed from iteration 2" in capsys.readouterr().out

    reproduce.main(argv(tmp_path / "straight"))
    stage = os.path.join("tiny-cube", "volpathsimple-drt-quadratic")
    for key in ("sigma_t", "albedo", "emission"):
        name = os.path.join(stage, "params", f"final-medium1_{key}.vol")
        a, _ = vol_io.read_vol(str(tmp_path / "o" / name))
        c, _ = vol_io.read_vol(str(tmp_path / "straight" / name))
        assert np.array_equal(a, c), key
    with open(tmp_path / "o" / stage / "metrics.jsonl") as f:
        losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
