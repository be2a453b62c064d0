"""The adjoint of the port against the JAX package, on the CPU.

- ``trilinear_scatter`` and ``resize_trilinear`` against uivr_tpu's;
- the wavefront tracking loops ``drt_distance`` and ``transmittance`` with
  the same global-counter Sampler: the same trip maxima (final counter) and
  per-lane results;
- the twin's primal resumed from a ``PathState``;
- the twin's ``sample_adjoint`` against JAX ``volpath_flat.sample_adjoint``
  (DRT preset on the smoke fixture), by the relative L1 rule of
  ``tests/test_pallas_adjoint.py``; the free-flight adjoint with shadow RR
  is held against the reference through the render op in
  tests/test_torch_train.py;
- a slice of rays keyed by their ray ids (``lane0``) walks as in the whole
  batch;
- the CUDA kernels' adjoint and delayed-DRT lane logic
  (``ops/csrc/volpath_adjoint.cuh``, ``volpath_drt.cuh``), compiled for the
  host with g++, against the twin on the cube fixture.

The twin matches the JAX engine on nearly every lane (1-2% flip at float
ties, see tests/test_torch_primal.py), so gradients are compared in
relative L1, not voxel by voxel.  Both adjoints replay the same primal
radiance (the twin's), which spares a JAX primal compile, and each JAX
reference runs as one jitted program, which compiles in about half the time
of its op-by-op form.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import assert_lanes_agree, both_scenes, camera_rays, host_library
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from uivr_tpu.config import cube_test_scene, smoke_scene
from uivr_tpu.core import grids as jgrids
from uivr_tpu.core.rng import make_sampler as j_make_sampler
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.integrators import volpath_flat as jflat
from uivr_tpu.integrators.volpathsimple import PathState as JPathState
from uivr_tpu.tracking import drt_distance as j_drt_distance
from uivr_tpu.tracking import transmittance as j_transmittance
from uivr_tpu_torch.core import grids as tgrids
from uivr_tpu_torch.core.rng import make_sampler, sample_tea_32
from uivr_tpu_torch.integrators import VolpathConfig, volpath_flat
from uivr_tpu_torch.integrators.volpathsimple import PathState, _reservoir_get
from uivr_tpu_torch.ops import volpath_step
from uivr_tpu_torch.scene.gradients import GradAccum, finalize_accum, init_accum
from uivr_tpu_torch.tracking import drt_distance, transmittance

SEED = 17
ADJ_CASES = {   # fixture, integrator settings
    "smoke-drt": ("smoke", dict(max_depth=4, trans_grad_samples=2)),
}
LANE_CASES = {   # the host-built lane logic against the twin, on the cube
    "cube-drt": ("cube", dict(max_depth=4, trans_grad_samples=2)),
    "cube-basic-rr": ("cube", dict(max_depth=4, trans_grad_samples=2, use_drt=False,
                                   shadow_rr=0.1)),
    "cube-drt-no-nee": ("cube", dict(max_depth=6, trans_grad_samples=3, use_nee=False)),
}


def rel_l1(ref, x):
    ref, x = np.asarray(ref), np.asarray(x)
    return np.abs(ref - x).sum() / max(np.abs(ref).sum(), 1e-30)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, jb in (("cube", cube_test_scene()),
                     ("smoke", smoke_scene(res=16, resx=32, resy=32, n_sensors=2))):
        jsc, _, tsc = both_scenes(jb)
        (jo, jd), (o, d) = camera_rays(jb, n=1024)
        dL = np.random.RandomState(2).rand(1024, 3).astype(np.float32) / 1024
        out[name] = dict(jsc=jsc, tsc=tsc, jo=jo, jd=jd, o=o, d=d, dL=dL)
    return out


@pytest.fixture(scope="module")
def twin(scenes):
    """Per case: the twin's replayed L, its adjoint walk (accumulator,
    reservoirs, stats) and its full gradients."""
    res = {}
    for case, (fx, kw) in dict(ADJ_CASES, **LANE_CASES).items():
        s = scenes[fx]
        cfg = VolpathConfig(**kw)
        L, _ = volpath_flat.sample_primal(cfg, s["tsc"], s["o"], s["d"], SEED)
        dL = torch.from_numpy(s["dL"])
        walk = volpath_flat.adjoint_walk(cfg, s["tsc"], s["o"], s["d"], SEED, dL, L)
        # sample_adjoint = the walk + the delayed DRT term, on a copy
        acc = GradAccum(*[a.clone() for a in walk[0]])
        if cfg.use_drt:
            volpath_flat._drt_backward_flat(cfg, s["tsc"], SEED, walk[1],
                                            _reservoir_get(walk[1]) * dL, acc)
        res[case] = dict(L=L, walk=walk, grads=finalize_accum(acc, s["tsc"].medium))
    return res


def test_trilinear_scatter_matches_jax():
    rs = np.random.RandomState(0)
    p = rs.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)
    mask = rs.rand(300) < 0.8
    for C, shape in ((1, (4, 5, 6)), (3, (2, 3, 7))):
        acc0 = rs.rand(*shape, C).astype(np.float32)
        cot = rs.randn(300, C).astype(np.float32)
        ref = jax.jit(jgrids.trilinear_scatter)(jnp.asarray(acc0), jnp.asarray(p),
                                                jnp.asarray(cot), jnp.asarray(mask))
        out = tgrids.trilinear_scatter(torch.from_numpy(acc0.copy()), torch.from_numpy(p),
                                       torch.from_numpy(cot), torch.from_numpy(mask))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_resize_trilinear_matches_jax():
    rs = np.random.RandomState(1)
    data = rs.rand(4, 5, 6, 2).astype(np.float32)
    for new in ((8, 10, 12), (3, 7, 4)):
        ref = np.asarray(jgrids.resize_trilinear(jnp.asarray(data), new))
        out = tgrids.resize_trilinear(torch.from_numpy(data), new).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def _local_rays(n, seed):
    """Random local rays inside the unit cube, as numpy."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rs.rand(n) < 0.9
    return o, d.astype(np.float32), active


def test_wavefront_trackers_match_jax(scenes):
    s = scenes["smoke"]
    jm, tm = s["jsc"].medium, s["tsc"].medium
    o, d, active = _local_rays(1024, 5)
    _, tf, _ = jflat.aabb.ray_unit_cube(jnp.asarray(o), jnp.asarray(d), 0.0, jflat.aabb.INF)
    maxt = np.asarray(tf)
    J = [jnp.asarray(x) for x in (o, d, maxt)]
    T = [torch.from_numpy(np.array(x)) for x in (o, d, maxt)]
    ja, ta = jnp.asarray(active), torch.from_numpy(active)
    js = j_make_sampler(jnp.uint32(77), n_lanes=1024)
    ts = make_sampler(77, n_lanes=1024)

    jt, jw, jf, js2 = jax.jit(lambda *a: j_drt_distance(jm, *a, max_steps=4096))(*J, js, ja)
    tt, tw, tf_, ts2 = drt_distance(tm, *T, ts, ta, max_steps=4096)
    assert int(js2.dim) == ts2.dim > 0              # the same longest walk
    assert np.mean(np.asarray(jf) == tf_.numpy()) > 0.975
    for a, b in ((jt, tt), (jw, tw)):
        a, b = np.asarray(a), b.numpy()
        assert np.mean(np.abs(a - b) <= 1e-5 * (1 + np.abs(a))) > 0.975

    jtr, js3 = jax.jit(lambda *a: j_transmittance(jm, *a, max_steps=4096))(*J, js2, ja)
    ttr, ts3 = transmittance(tm, *T, ts2, ta, max_steps=4096)
    assert int(js3.dim) == ts3.dim > ts2.dim
    assert np.mean(np.abs(np.asarray(jtr) - ttr.numpy()) <= 1e-5) > 0.975


def test_primal_from_path_state_matches_jax(scenes):
    s = scenes["smoke"]
    o, d_w, active = _local_rays(1024, 6)
    w2l = np.asarray(s["jsc"].medium.world_to_local)[:3, :3]
    d_l = (d_w @ w2l.T).astype(np.float32)
    _, tf, _ = jflat.aabb.ray_unit_cube(jnp.asarray(o), jnp.asarray(d_l), 0.0, jflat.aabb.INF)
    rs = np.random.RandomState(7)
    fields = dict(active=active, depth=rs.randint(0, 2, 1024).astype(np.int32), o_l=o,
                  d_l=d_l, d_w=d_w, maxt=np.asarray(tf),
                  last_pdf=rs.uniform(0.05, 1.0, 1024).astype(np.float32))
    cfg = dict(max_depth=4)
    Lj, ej = jax.jit(lambda ps: jflat.sample_primal(
        JCfg(**cfg), s["jsc"], None, None, jnp.uint32(SEED), path_state=ps))(
        JPathState(**{k: jnp.asarray(v) for k, v in fields.items()}))
    ps = PathState(**{k: torch.from_numpy(np.array(v)) for k, v in fields.items()})
    L, esc = volpath_flat.sample_primal(VolpathConfig(**cfg), s["tsc"], None, None, SEED,
                                        path_state=ps)
    assert_lanes_agree(np.asarray(Lj), L.numpy())
    assert np.mean(np.asarray(ej) == esc.numpy()) > 0.975


@pytest.mark.parametrize("case", list(ADJ_CASES))
def test_twin_adjoint_matches_jax(case, scenes, twin):
    fx, kw = ADJ_CASES[case]
    s = scenes[fx]
    gj = jax.jit(lambda dL, L: jflat.sample_adjoint(
        JCfg(**kw), s["jsc"], s["jo"], s["jd"], jnp.uint32(SEED), dL, L))(
        jnp.asarray(s["dL"]), jnp.asarray(twin[case]["L"].numpy()))
    g = twin[case]["grads"]
    assert float(np.abs(np.asarray(gj.sigma_t)).sum()) > 0
    assert rel_l1(gj.sigma_t, g.sigma_t.numpy()) < 0.05
    assert rel_l1(gj.albedo, g.albedo.numpy()) < 0.05
    assert not g.emission.any()


_HOST_SRC = r'''#define __host__
#define __device__
#include "volpath_drt.cuh"
extern "C" void adjoint_all(const uivr::AdjParams* a) {
  for (int64_t i = 0; i < a->P.n; ++i) uivr::adjoint_lane(*a, i);
}
extern "C" void primal_state_all(const uivr::PrimalParams* p) {
  for (int64_t i = 0; i < p->n; ++i) uivr::primal_lane(*p, i, true);
}
extern "C" void drt_all(const uivr::DrtParams* d, int which, int mis) {
  for (int64_t i = 0; i < d->P.n; ++i) {
    if (which == 0) uivr::drt_walk_lane(*d, i);
    else if (which == 1) uivr::drt_nee_lane(*d, i);
    else if (which == 2) uivr::drt_phase_lane(*d, i);
    else uivr::drt_scatter_lane(*d, i, mis);
  }
}
extern "C" int sizes(int which) {
  return which == 0 ? (int)sizeof(uivr::AdjParams) : (int)sizeof(uivr::DrtParams);
}
'''


def _host_lib():
    lib = host_library(_HOST_SRC, "adjoint-lane")
    lib.adjoint_all.argtypes = [ctypes.c_void_p]
    lib.primal_state_all.argtypes = [ctypes.c_void_p]
    lib.drt_all.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    assert lib.sizes(0) == ctypes.sizeof(volpath_step.AdjParams)
    assert lib.sizes(1) == ctypes.sizeof(volpath_step.DrtParams)
    return lib


def _host_drt(lib, cfg, tsc, res, adjoint):
    """The delayed DRT term through the host-built lane logic, launch by
    launch as ``drt_backward_kernel`` runs it."""
    acc = init_accum(tsc.medium, need_emission=False)
    D, out, ps, counts = volpath_step.drt_params(cfg, tsc, SEED, res, adjoint, acc)
    mis = int(cfg.use_drt_mis)
    lib.drt_all(ctypes.byref(D), 0, mis)
    if cfg.use_nee:
        lib.drt_all(ctypes.byref(D), 1, mis)
    lib.drt_all(ctypes.byref(D), 2, mis)
    n = res.o_l.shape[0]
    rec_L, esc = torch.empty(n, 3), torch.empty(n, dtype=torch.bool)
    P = volpath_step.primal_params(cfg, tsc, None, None, sample_tea_32(SEED, 0x7177)[0],
                                   rec_L, esc, path_state=ps)
    lib.primal_state_all(ctypes.byref(P))
    D.rec_L = rec_L.data_ptr()
    lib.drt_all(ctypes.byref(D), 3, mis)
    return acc, out, counts


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_kernel_lane_logic_matches_twin(case, scenes, twin):
    lib = _host_lib()
    fx, kw = LANE_CASES[case]
    s, t = scenes[fx], twin[case]
    cfg = VolpathConfig(**kw)
    dL = torch.from_numpy(s["dL"])
    acc = init_accum(s["tsc"].medium, need_emission=False)
    a, res, st = volpath_step.adjoint_params(cfg, s["tsc"], s["o"], s["d"], SEED, dL,
                                             t["L"], acc)
    lib.adjoint_all(ctypes.byref(a))
    acc_t, res_t, st_t = t["walk"]
    for k in ("dim", "alt_dim", "steps"):
        assert np.mean(st[k].numpy().astype(np.int64) == st_t[k].numpy()) > 0.975, k
    assert np.mean(res.depth.numpy() == res_t.depth.numpy()) > 0.975
    assert rel_l1(acc_t.sigma, acc.sigma) < 1e-4
    assert rel_l1(acc_t.albedo, acc.albedo) < 1e-4
    if not cfg.use_drt:
        return
    adjoint = _reservoir_get(res_t) * dL
    acc_d, stats = volpath_flat._drt_backward_flat(
        cfg, s["tsc"], SEED, res_t, adjoint, init_accum(s["tsc"].medium, need_emission=False),
        return_stats=True)
    acc_k, out, counts = _host_drt(lib, cfg, s["tsc"], res_t, adjoint)
    assert counts.tolist() == [stats["k_a"], stats["k_b"]]
    for k in ("t_sel", "wsum", "found"):
        assert np.mean(out[k].numpy() == stats[k].numpy()) > 0.975, k
    assert float(acc_d.sigma.abs().sum()) > 0
    assert rel_l1(acc_d.sigma, acc_k.sigma) < 1e-4
    assert rel_l1(acc_d.albedo, acc_k.albedo) < 1e-4


def test_adjoint_wrappers_on_cpu_are_the_twins(scenes, twin):
    s = scenes["cube"]
    cfg = VolpathConfig(**LANE_CASES["cube-basic-rr"][1])
    before = dict(volpath_step.LAUNCHES)
    calls = dict(volpath_flat.CALLS)
    L = twin["cube-basic-rr"]["L"]
    g = volpath_step.sample_adjoint_kernel(cfg, s["tsc"], s["o"], s["d"], SEED,
                                           torch.from_numpy(s["dL"]), L)
    assert volpath_flat.CALLS["volpath_adjoint"] == calls["volpath_adjoint"] + 1
    assert torch.equal(g.sigma_t, twin["cube-basic-rr"]["grads"].sigma_t)
    # the DRT wrapper hands return_stats to the twin
    t = twin["cube-drt"]
    res = t["walk"][1]
    adjoint = _reservoir_get(res) * torch.from_numpy(s["dL"])
    acc, st = volpath_step.drt_backward_kernel(
        VolpathConfig(**LANE_CASES["cube-drt"][1]), s["tsc"], SEED, res, adjoint,
        GradAccum(*[a.clone() for a in t["walk"][0]]), return_stats=True)
    assert torch.equal(finalize_accum(acc, s["tsc"].medium).sigma_t, t["grads"].sigma_t)
    assert st["k_a"] > 0 and st["rec_L"].shape == (1024, 3)
    assert volpath_step.LAUNCHES == before


def test_twin_keys_a_slice_by_ray_ids(scenes, twin):
    """Rays lane0.. of a batch, walked alone with ``lane0``, draw and
    return what the whole batch gave them."""
    s, t = scenes["cube"], twin["cube-drt"]
    cfg = VolpathConfig(**LANE_CASES["cube-drt"][1])
    k = 600
    L, _ = volpath_flat.sample_primal(cfg, s["tsc"], s["o"][k:], s["d"][k:], SEED, lane0=k)
    assert torch.equal(L, t["L"][k:])
    _, res, st = volpath_flat.adjoint_walk(cfg, s["tsc"], s["o"][k:], s["d"][k:], SEED,
                                           torch.from_numpy(s["dL"][k:]), L, lane0=k)
    _, res_all, st_all = t["walk"]
    for key in ("dim", "alt_dim", "steps"):
        assert torch.equal(st[key], st_all[key][k:]), key
    assert torch.equal(res.wsum, res_all.wsum[k:]) and torch.equal(res.depth, res_all.depth[k:])
    _, other = volpath_flat.adjoint_walk(cfg, s["tsc"], s["o"][k:], s["d"][k:], SEED,
                                         torch.from_numpy(s["dL"][k:]), L)[1:]
    assert not torch.equal(other["dim"], st["dim"])     # keyed from 0: other draws
