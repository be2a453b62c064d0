"""Data parallel of the port (``uivr_tpu_torch/parallel``) against the JAX
package, on the CPU with gloo ranks.

- ``shard_batch`` cuts as JAX's ``shard_batch`` on ``make_mesh(2)`` and
  ``make_mesh(4)`` (the conftest's virtual devices) and refuses what does
  not divide; a rank's seeds are JAX's mixing of the step's seeds;
- one ``sharded_loss_and_grad`` step on two gloo ranks (spawned processes)
  against JAX's ``sharded_loss_and_grad(make_mesh(2), ...)`` on the
  fixture of tests/test_parallel.py (smoke 16^3, 64 pixels, 2 spp, depth
  4, the flat engine): loss within 5%, gradients within 5% relative L1;
  and bit for bit the mean of the two shards' value-and-grad computed in
  this process, on both ranks;
- ``reproduce --mesh 2 --device cpu`` for 2 iterations: exit 0, both
  ranks' final grids bit-equal, the files written once.
"""
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import bundle_to_numpy
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from torch_ranks import render_of, sharded_step
from uivr_tpu.config import smoke_scene
from uivr_tpu.core.rng import sample_tea_32 as j_tea
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.opt import losses as j_losses
from uivr_tpu.parallel import make_mesh as j_make_mesh
from uivr_tpu.parallel import replicate as j_replicate
from uivr_tpu.parallel import shard_batch as j_shard_batch
from uivr_tpu.parallel import sharded_loss_and_grad as j_sharded
from uivr_tpu.render import RenderSettings as JSettings
from uivr_tpu.render import make_render as j_make_render
from uivr_tpu.render import sample_batch_pixels as j_sample_batch_pixels
from uivr_tpu_torch.opt import losses
from uivr_tpu_torch.parallel import Mesh, local_seeds, make_mesh, shard_batch, spawn

CFG = dict(max_depth=4, max_steps=256, engine="flat")
SPP, BATCH, SEEDS = 2, 64, (5, 6)
FIELDS = ("sigma_t", "albedo", "emission")


def _meshes(n):
    return [Mesh(size=n, rank=r, device=torch.device("cpu")) for r in range(n)]


def test_shard_batch_and_seeds_match_jax():
    rs = np.random.RandomState(0)
    tree = (rs.randint(0, 4, 16).astype(np.int32), rs.randint(0, 32, (16, 2)).astype(np.int32),
            rs.rand(16, 3).astype(np.float32), np.float32(0.5))
    for n in (2, 4):
        jshards = [sorted(x.addressable_shards, key=lambda s: s.device.id)
                   for x in j_shard_batch(j_make_mesh(n), tree[:3])]
        for r, m in enumerate(_meshes(n)):
            mine = shard_batch(m, tree)
            for a, s in zip(mine[:3], jshards):
                np.testing.assert_array_equal(a.numpy(), np.asarray(s[r].data))
            assert mine[3].ndim == 0 and float(mine[3]) == 0.5
            for step_seeds in ((5, 6), (0xFFFFFFFF, 123456789)):
                got = local_seeds(m, *step_seeds)
                want = (int(j_tea(jnp.uint32(step_seeds[0]), jnp.uint32(2 * r + 1))[0]),
                        int(j_tea(jnp.uint32(step_seeds[1]), jnp.uint32(2 * r + 2))[0]))
                assert got == want
        with pytest.raises(ValueError):
            j_shard_batch(j_make_mesh(n), np.zeros((n + 1, 3), np.float32))
        with pytest.raises(ValueError):
            shard_batch(_meshes(n)[0], np.zeros((n + 1, 3), np.float32))
    with pytest.raises(ValueError):     # no group of 2 ranks in this process
        make_mesh(2, device="cpu")
    assert make_mesh(device="cpu").size == 1


@pytest.fixture(scope="module")
def fixture():
    """tests/test_parallel.py's fixture and one batch of it."""
    jb = smoke_scene(res=16, resx=32, resy=32, n_sensors=4)
    sidx, pix = j_sample_batch_pixels(jnp.uint32(3), 4, jb.film_size, BATCH)
    ref = np.full((BATCH, 3), 0.25, np.float32)
    return jb, (np.asarray(sidx).astype(np.int64), np.asarray(pix).astype(np.int64), ref)


def test_sharded_step_matches_jax_and_the_shard_mean(fixture, tmp_path):
    jb, batch = fixture
    # JAX: the sharded value-and-grad on a 2-device mesh
    js = JSettings(integrator=JCfg(**CFG), medium=jb.medium_cfg, film_size=jb.film_size,
                   spp=SPP, spp_grad=SPP)
    mesh = j_make_mesh(2)
    vag = jax.jit(j_sharded(mesh, j_make_render(js, jb.to_world), j_losses.l1))
    jl, jg = vag(j_replicate(mesh, jb.params), j_replicate(mesh, jb.emitter),
                 j_replicate(mesh, jb.cameras),
                 *j_shard_batch(mesh, tuple(jnp.asarray(x) for x in batch)),
                 jnp.uint32(SEEDS[0]), jnp.uint32(SEEDS[1]))
    # the port: two gloo ranks
    bundle_np = bundle_to_numpy(jb)
    out = str(tmp_path / "rank%d.npz")
    spawn(sharded_step, 2, (bundle_np, CFG, SPP, batch, SEEDS, out), device="cpu",
          timeout_s=300)
    ranks = [np.load(out % r) for r in range(2)]
    # the same two shards, one after the other in this process
    tb, render = render_of(bundle_np, CFG, SPP)
    shards = []
    for m in _meshes(2):
        sidx, pix, ref = shard_batch(m, batch)
        leaves = type(tb.params)(*[p.detach().requires_grad_(True) for p in tb.params])
        value = losses.l1(render(leaves, tb.emitter, tb.cameras, sidx, pix,
                                 *local_seeds(m, *SEEDS)), ref)
        shards.append([value.detach()] + list(torch.autograd.grad(value, leaves)))
    mean = [(a + b) / 2 for a, b in zip(*shards)]
    for rec in ranks:
        got = [rec["loss"]] + [rec[k] for k in FIELDS]
        for a, b in zip(got, mean):
            assert np.array_equal(a, b.numpy())
    loss = float(ranks[0]["loss"])
    assert abs(loss - float(jl)) <= 0.05 * abs(float(jl)), (loss, float(jl))
    for k in ("sigma_t", "albedo"):
        a, b = np.asarray(getattr(jg, k)), ranks[0][k]
        assert np.abs(a).sum() > 0
        assert np.abs(a - b).sum() / np.abs(a).sum() < 0.05, k


def test_reproduce_mesh_trains_on_two_ranks(tmp_path, monkeypatch, capfd):
    """``reproduce --mesh 2 --device cpu`` on tiny-cube, cut to 2
    iterations of 16 pixels (the stages' configs are made in this process
    and sent to the ranks): rank 0 renders the references and writes every
    file once, and both ranks end on the same grids."""
    from uivr_tpu_torch.cli import reproduce
    from uivr_tpu_torch.core import vol_io
    make_opt = reproduce._opt_for
    monkeypatch.setattr(reproduce, "_opt_for", lambda *a: dataclasses.replace(
        make_opt(*a), n_iter=2, batch_size=16, spp=2, primal_spp_factor=1,
        checkpoint_stride=1, preview_stride=0, render_initial=False, render_final=False))
    argv = ["--config", "tiny-cube", "--integrator", "volpathsimple-drt", "--device", "cpu",
            "--film-scale", "0.25", "--ref-spp", "1", "--outputs", str(tmp_path / "o")]
    with pytest.raises(ValueError, match="do not divide"):
        reproduce.main(argv + ["--mesh", "3"])
    reproduce.main(argv + ["--mesh", "2"])
    printed = capfd.readouterr().out
    digests = dict(re.findall(r"\[rank (\d)/2\] tiny-cube/volpathsimple-drt final grids "
                              r"sha256 ([0-9a-f]{16})", printed))
    assert sorted(digests) == ["0", "1"] and len(set(digests.values())) == 1, printed
    stage = tmp_path / "o" / "tiny-cube" / "volpathsimple-drt"
    with open(stage / "metrics.jsonl") as f:
        its = [r["it"] for r in map(json.loads, f) if "it" in r]
    assert its == [0, 1]
    assert sorted(os.listdir(stage / "params")) == sorted(
        f"{p}-medium1_{k}.vol" for p in ("initial", "00000001", "final") for k in FIELDS)
    refs = sorted(os.listdir(tmp_path / "o" / "tiny-cube" / "references"))
    assert refs == ["_refspp.json", "ref_000000.exr"]
    final, _ = vol_io.read_vol(str(stage / "params" / "final-medium1_sigma_t.vol"))
    initial, _ = vol_io.read_vol(str(stage / "params" / "initial-medium1_sigma_t.vol"))
    assert np.isfinite(final).all() and not np.array_equal(final, initial)
