"""The training slice of the port against the JAX package, on the CPU.

- Adam, the losses, the schedule, ``enforce_valid_params`` and
  ``upsample_params`` on equal inputs (allclose at 1e-6);
- ``.vol`` files byte-identical, and the full-state ``.npz`` checkpoint
  readable by either package;
- ``run_optimization``: two iterations on the cube fixture at batch 64
  draw the same (seed, seed_grad) pairs and pixels as the reference, with
  losses within 5% and final grids within 5% relative L1;
- the autograd render op (``render.batched.make_render``) on the inputs of
  the reference run's first step: ``loss.backward()`` against the loss and
  gradient of the reference's jitted step, which is ``jax.value_and_grad``
  through its ``make_render`` (the gradient read back from Adam's first
  moment, ``mu = (1 - beta1) g`` from a zero state), so both tests share
  one reference compile.

The integrator of the last two is the free-flight estimator with shadow
Russian roulette (``use_drt=False``, ``shadow_rr=0.1``): the DRT adjoint
is held against the reference in tests/test_torch_adjoint.py.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import bundle_to_numpy
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from uivr_tpu.config import cube_test_scene
from uivr_tpu.core import vol_io as j_vol_io
from uivr_tpu.core.rng import sample_tea_32 as j_tea
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.opt import checkpoint as j_checkpoint
from uivr_tpu.opt import loop as j_loop
from uivr_tpu.opt import losses as j_losses
from uivr_tpu.opt import optimizer as j_optimizer
from uivr_tpu.opt import schedule as j_schedule
from uivr_tpu.opt.loop import OptimizationConfig as JOptCfg
from uivr_tpu.opt.loop import run_optimization as j_run_optimization
from uivr_tpu.scene.medium import MediumParams as JParams
from uivr_tpu_torch.config import adam_state_from_numpy, bundle_from_numpy, params_from_numpy
from uivr_tpu_torch.core import vol_io
from uivr_tpu_torch.integrators import VolpathConfig
from uivr_tpu_torch.opt import checkpoint, losses, loop, optimizer, schedule
from uivr_tpu_torch.opt.loop import OptimizationConfig, run_optimization
from uivr_tpu_torch.render.batched import RenderSettings, make_render
from uivr_tpu_torch.scene.medium import MediumParams

FIELDS = MediumParams._fields
BASIC = dict(max_depth=4, trans_grad_samples=2, use_drt=False, shadow_rr=0.1)
RUN = dict(spp=2, primal_spp_factor=2, n_iter=2, batch_size=64, preview_stride=0,
           checkpoint_stride=0, checkpoint_initial=False, render_initial=False,
           render_final=False)


def _grids(seed, shape=(3, 4, 5)):
    rs = np.random.RandomState(seed)
    return {"sigma_t": rs.rand(*shape, 1).astype(np.float32) * 3 - 0.5,
            "albedo": rs.rand(*shape, 3).astype(np.float32) * 1.4 - 0.2,
            "emission": rs.randn(*shape, 3).astype(np.float32)}


def _jparams(d):
    return JParams(**{k: jnp.asarray(d[k]) for k in FIELDS})


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_adam_and_sgd_match_jax():
    p, g, m, v = _grids(0), _grids(1), _grids(2), _grids(3)
    v = {k: np.abs(x) for k, x in v.items()}
    flat = {"step": np.int32(4), **{f"mu.{k}": m[k] for k in FIELDS},
            **{f"nu.{k}": v[k] for k in FIELDS}}
    jst = j_optimizer.AdamState(step=jnp.int32(4), mu=_jparams(m), nu=_jparams(v))
    tst = adam_state_from_numpy(flat, device="cpu")
    lr = j_schedule.learning_rates(5e-3, j_schedule.Schedule.Last25, 80, 100,
                                   {"albedo": 2.0})
    tlr = schedule.learning_rates(5e-3, schedule.Schedule.Last25, 80, 100, {"albedo": 2.0})
    assert tuple(lr) == tuple(tlr)
    for jstep, tstep in ((j_optimizer.adam_step, optimizer.adam_step),
                         (j_optimizer.sgd_step, optimizer.sgd_step)):
        jp, jn = jstep(_jparams(p), _jparams(g), jst, lr)
        tp, tn = tstep(params_from_numpy(p, device="cpu"), params_from_numpy(g, device="cpu"),
                       tst, tlr)
        assert int(jn.step) == tn.step
        for k in FIELDS:
            _close(getattr(jp, k), getattr(tp, k))
            _close(getattr(jn.mu, k), getattr(tn.mu, k))
            _close(getattr(jn.nu, k), getattr(tn.nu, k))


def test_losses_schedule_projection_match_jax():
    rs = np.random.RandomState(4)
    img, ref = rs.rand(64, 3).astype(np.float32), rs.rand(64, 3).astype(np.float32)
    ref[:5] += 2.0
    for name in ("average", "l1", "l2", "rmse", "huber", "mean_relative_absolute_error",
                 "mean_relative_squared_error", "rmrse", "psnr"):
        a = getattr(j_losses, name)(jnp.asarray(img), jnp.asarray(ref))
        b = getattr(losses, name)(torch.from_numpy(img), torch.from_numpy(ref))
        _close(a, b.numpy())
    assert sorted(j_losses.LOSSES) == sorted(losses.LOSSES)
    for sch in (j_schedule.Schedule.Constant, j_schedule.Schedule.Last25):
        for it in (0, 74, 75, 86, 99):
            assert (j_schedule.schedule_factor(sch, it, 100)
                    == schedule.schedule_factor(schedule.Schedule(int(sch)), it, 100))
    assert (j_schedule.upsample_iterations([0.04, 0.16, 0.36], 600)
            == schedule.upsample_iterations([0.04, 0.16, 0.36], 600))
    assert (j_schedule.initial_resolution((128, 128, 128, 3), 4)
            == schedule.initial_resolution((128, 128, 128, 3), 4))
    g = _grids(5)
    jv = j_schedule.enforce_valid_params(_jparams(g), 2.0)
    tv = schedule.enforce_valid_params(params_from_numpy(g, device="cpu"), 2.0)
    ju = j_schedule.upsample_params(_jparams(g))
    tu = schedule.upsample_params(params_from_numpy(g, device="cpu"))
    for k in FIELDS:
        _close(getattr(jv, k), getattr(tv, k))
        _close(getattr(ju, k), getattr(tu, k))


def test_vol_files_and_state_checkpoints_cross_over(tmp_path, monkeypatch):
    g = _grids(6)
    j_vol_io.write_vol(str(tmp_path / "j.vol"), g["albedo"])
    vol_io.write_vol(str(tmp_path / "t.vol"), g["albedo"])
    assert (tmp_path / "j.vol").read_bytes() == (tmp_path / "t.vol").read_bytes()
    data, bbox = vol_io.read_vol(str(tmp_path / "j.vol"))
    assert np.array_equal(data, g["albedo"]) and bbox == (0, 0, 0, 1, 1, 1)

    m, v = _grids(7), _grids(8)
    tp = params_from_numpy(g, device="cpu")
    flat = {"step": np.int32(3), **{f"mu.{k}": m[k] for k in FIELDS},
            **{f"nu.{k}": v[k] for k in FIELDS}}
    checkpoint.save_state(str(tmp_path / "port" / "state"), tp,
                          adam_state_from_numpy(flat, device="cpu"), 11)
    jp, jst, jit = j_checkpoint.load_state(str(tmp_path / "port" / "state"))
    assert jit == 11 and int(jst.step) == 3
    for k in FIELDS:
        assert np.array_equal(np.asarray(getattr(jp, k)), g[k])
        assert np.array_equal(np.asarray(getattr(jst.nu, k)), v[k])
    # the reference writes .npz where orbax is missing
    monkeypatch.setattr(j_checkpoint, "_HAVE_ORBAX", False)
    j_checkpoint.save_state(str(tmp_path / "jax" / "state"), jp, jst, 12)
    tp2, tst2, tit = checkpoint.load_state(str(tmp_path / "jax" / "state"))
    assert tit == 12 and tst2.step == 3
    for k in FIELDS:
        assert torch.equal(getattr(tp2, k), getattr(tp, k))
        assert np.array_equal(getattr(tst2.mu, k).numpy(), m[k])


def _recording(make_step, calls):
    """``_make_step`` whose steps also record, per call, what they were
    given and the loss and Adam first moment they returned."""
    def make(*a, **k):
        step = make_step(*a, **k)

        def run(params, opt_state, emitter, cameras, sensor_idx, pixels, ref, seed,
                seed_grad, lr):
            out = step(params, opt_state, emitter, cameras, sensor_idx, pixels, ref, seed,
                       seed_grad, lr)
            calls.append(dict(seeds=(int(seed), int(seed_grad)),
                              sensor_idx=np.asarray(sensor_idx).astype(np.int64),
                              pixels=np.asarray(pixels).astype(np.int64),
                              ref=np.array(ref), loss=float(out[2]), mu=out[1].mu))
            return out
        return run
    return make


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two iterations of ``run_optimization`` on the cube fixture in each
    package, every step recorded."""
    jb = cube_test_scene(resx=16, resy=16)
    tb = bundle_from_numpy(bundle_to_numpy(jb), device="cpu")
    ref = np.random.RandomState(10).rand(1, 16, 16, 3).astype(np.float32)
    out = tmp_path_factory.mktemp("runs")
    calls = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_loop, "_make_step", _recording(j_loop._make_step, calls["jax"]))
        mp.setattr(loop, "_make_step", _recording(loop._make_step, calls["port"]))
        j_run_optimization(str(out / "jax"), JOptCfg(**RUN), jb, JCfg(**BASIC),
                           ref_images=ref, resume=False, verbose=False)
        final = run_optimization(str(out / "port"), OptimizationConfig(**RUN), tb,
                                 VolpathConfig(**BASIC), ref_images=ref, resume=False,
                                 verbose=False)
    return dict(dir=out, calls=calls, tb=tb, final=final)


def test_run_optimization_matches_jax(runs):
    j, t = runs["calls"]["jax"], runs["calls"]["port"]
    assert len(j) == len(t) == 2
    assert [c["seeds"] for c in t] == [c["seeds"] for c in j]
    for cj, ct in zip(j, t):
        assert np.array_equal(ct["sensor_idx"], cj["sensor_idx"])
        assert np.array_equal(ct["pixels"], cj["pixels"])

    def losses_of(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [r["loss"] for r in map(json.loads, f) if "loss" in r]

    jl, tl = losses_of(runs["dir"] / "jax"), losses_of(runs["dir"] / "port")
    assert len(jl) == len(tl) == 2
    np.testing.assert_allclose(tl, jl, rtol=0.05)
    for key in ("sigma_t", "albedo"):
        name = f"final-medium1_{key}.vol"
        a, _ = j_vol_io.read_vol(str(runs["dir"] / "jax" / "params" / name))
        b, _ = vol_io.read_vol(str(runs["dir"] / "port" / "params" / name))
        assert a.shape == b.shape
        assert np.abs(a - b).sum() / np.abs(a).sum() < 0.05, key
        assert np.array_equal(b, getattr(runs["final"], key).numpy())
    assert not torch.equal(runs["final"].sigma_t, runs["tb"].start_from.sigma_t)


def test_render_op_backward_matches_jax(runs):
    tb, c = runs["tb"], runs["calls"]["jax"][0]
    ts = RenderSettings(integrator=VolpathConfig(**BASIC), medium=tb.medium_cfg,
                        film_size=tb.film_size, spp=RUN["spp"] * RUN["primal_spp_factor"],
                        spp_grad=RUN["spp"])
    leaves = MediumParams(*[p.clone().requires_grad_(True) for p in tb.start_from])
    img = make_render(ts, tb.to_world)(leaves, tb.emitter, tb.cameras,
                                       torch.from_numpy(c["sensor_idx"]),
                                       torch.from_numpy(c["pixels"]), *c["seeds"])
    loss = losses.l1(img, torch.from_numpy(c["ref"]))
    loss.backward()
    assert abs(loss.item() - c["loss"]) <= 0.05 * abs(c["loss"])
    for k in ("sigma_t", "albedo"):
        a = np.asarray(getattr(c["mu"], k)) / np.float32(1.0 - 0.9)
        b = getattr(leaves, k).grad.numpy()
        assert np.abs(a).sum() > 0
        assert np.abs(a - b).sum() / np.abs(a).sum() < 0.05, k
    assert not leaves.emission.grad.any()
