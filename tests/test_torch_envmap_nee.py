"""Deferred-radiance NEE (K3b) of the port against the JAX package, on the CPU.

- the coarse ``nee`` proxy: ``_area_downsample`` and the proxy's tables
  bit for bit, its ``sample_direction`` / ``pdf_direction`` to 1e-6, and
  ``nee_max_texels=0`` as the switch that builds none;
- the plain twin's deferred mode against the JAX flat engine on the
  ``smoke_bigenv`` scene of ``tests/pallas_common.py`` (a 128x128 sky,
  16,384 texels): the estimators differ by construction (proxy against
  full-resolution importance sampling), so only the channel means must
  agree, to the bound of ``tests/test_pallas_envmap_cls.py``;
- the deferred twin's free-flight sigma_t gradient against the JAX flat
  gradient, to the cosine floor of two JAX seeds, as that file measures it;
- the CUDA lane logic built with g++ against the deferred twin, lane for
  lane, primal and adjoint, and the delayed DRT term's NEE at full
  resolution (the reference's ``_nee_primal`` samples ``scene.emitter``).
"""
import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import assert_lanes_agree, both_scenes, host_library
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from uivr_tpu.config import smoke_scene
from uivr_tpu.config.scenes import procedural_sky
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.integrators import volpath_flat as jflat
from uivr_tpu.scene import emitters as jem
from uivr_tpu.scene.camera import sample_rays
from uivr_tpu_torch.integrators import VolpathConfig, volpath_flat
from uivr_tpu_torch.core.aabb import transform_dirs
from uivr_tpu_torch.integrators.volpathsimple import _exit_dist, _Reservoir
from uivr_tpu_torch.ops import volpath_step
from uivr_tpu_torch.scene import emitters as tem
from uivr_tpu_torch.scene.gradients import finalize_accum, init_accum

SEED = 42
DEPTH = 6


def _cos(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def bigenv():
    """``smoke_bigenv``: 16^3 plume, 128x128 sky (above the 8192-texel cap),
    8192 rays of sensor 0 on both sides."""
    jb = smoke_scene(res=16, resx=32, resy=32, n_sensors=2,
                     envmap=procedural_sky(128, 128))
    jsc, tb, tsc = both_scenes(jb)
    rng = np.random.RandomState(0)
    n = 8192
    uv = jnp.asarray(rng.rand(n, 2) * 0.6 + 0.2, jnp.float32)
    jo, jd = sample_rays(jb.cameras, jnp.zeros((n,), jnp.int32), uv)
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    return dict(jb=jb, jsc=jsc, tb=tb, tsc=tsc, jo=jo, jd=jd, o=o, d=d)


@pytest.mark.parametrize("hw, cap", [((8, 12), 6), ((128, 128), 2048), ((100, 150), 500)])
def test_area_downsample_matches_jax(hw, cap):
    x = np.random.RandomState(1).rand(*hw, 3).astype(np.float32) ** 3
    np.testing.assert_array_equal(tem._area_downsample(x, cap),
                                  jem._area_downsample(x, cap))


def test_proxy_tables_match_jax(bigenv):
    je, te = bigenv["jb"].emitter, bigenv["tb"].emitter
    assert je.nee is not None and te.nee is not None and te.nee.nee is None
    fields = ("alias_tab", "row_pmf", "cond_pmf", "flat_data", "data", "to_world")
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(je.nee, f)),
                                      getattr(te.nee, f).numpy(), f)
    # te is bundle_from_numpy's rebuild of the proxy (bigenv); make_envmap
    # builds the same tables, and nee_max_texels=0 none
    made = tem.make_envmap(np.asarray(je.data), np.asarray(je.to_world), device="cpu")
    off = tem.make_envmap(np.asarray(je.data), np.asarray(je.to_world), nee_max_texels=0,
                          device="cpu")
    assert off.nee is None
    for f in fields:
        assert torch.equal(getattr(made.nee, f), getattr(te.nee, f)), f
        assert torch.equal(getattr(off, f), getattr(te, f)), f


def test_proxy_queries_match_jax(bigenv):
    je, te = bigenv["jb"].emitter.nee, bigenv["tb"].emitter.nee
    rs = np.random.RandomState(5)
    u2 = rs.rand(4096, 2).astype(np.float32)
    d = rs.randn(4096, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ref = jax.jit(lambda u, w: (*je.sample_direction(u), je.pdf_direction(w)))(
        jnp.asarray(u2), jnp.asarray(d))
    got = (*te.sample_direction(torch.from_numpy(u2)), te.pdf_direction(torch.from_numpy(d)))
    for r, g in zip(ref, got):     # direction, pdf, weight; pdf of directions
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


LANES = 1024     # rays of the adjoint and of the lane-for-lane checks
DRT_LANES = 256  # reservoir vertices of the delayed DRT term's check


@pytest.fixture(scope="module")
def twin(bigenv):
    """The deferred twin on every ray (primal, with stats) and the
    free-flight adjoint walk of the first LANES rays (its sigma_t gradient:
    PRB in-scattering and transmittance, which see the NEE radiance)."""
    cfg = VolpathConfig(max_depth=DEPTH, trans_grad_samples=2, use_drt=False)
    o, d, tsc = bigenv["o"], bigenv["d"], bigenv["tsc"]
    L, esc, st = volpath_flat.sample_primal(cfg, tsc, o, d, SEED, True, deferred=True)
    dL = torch.from_numpy(np.random.RandomState(2).rand(LANES, 3).astype(np.float32) / LANES)
    walk = volpath_flat.adjoint_walk(cfg, tsc, o[:LANES], d[:LANES], SEED, dL,
                                     L[:LANES].contiguous(), deferred=True)
    grad = finalize_accum(walk[0], tsc.medium).sigma_t
    return dict(cfg=cfg, L=L, esc=esc, stats=st, dL=dL, walk=walk, grad=grad)


@pytest.fixture(scope="module")
def jax_flat(bigenv, twin):
    """JAX's flat engine, one compile: the primal of every ray and the
    free-flight sigma_t gradient of the first LANES rays (the twin's dL),
    at the twin's seed and at another one."""
    jcfg = JCfg(max_depth=DEPTH, trans_grad_samples=2, use_drt=False)
    jsc, jo, jd = bigenv["jsc"], bigenv["jo"], bigenv["jd"]
    jdL = jnp.asarray(twin["dL"].numpy())

    @jax.jit
    def run(seed):
        L, _ = jflat.sample_primal(jcfg, jsc, jo, jd, seed)
        g = jflat.sample_adjoint(jcfg, jsc, jo[:LANES], jd[:LANES], seed, jdL, L[:LANES])
        return L, g.sigma_t

    return [tuple(np.asarray(x) for x in run(jnp.uint32(s_))) for s_ in (SEED, SEED + 1)]


def test_deferred_twin_matches_jax_flat_means(twin, jax_flat):
    Lj = jax_flat[0][0]
    L = twin["L"].numpy()
    assert np.isfinite(L).all()
    np.testing.assert_allclose(Lj.mean(0), L.mean(0), rtol=0.08, atol=5e-3)


def test_deferred_gradient_matches_jax_flat(twin, jax_flat):
    """The deferred twin's sigma_t gradient against JAX's flat one on the
    same rays, seed and dL, to the noise floor of two JAX flat seeds
    (cosine > min(floor - 0.1, 0.98))."""
    (_, g_ref), (_, g_other) = jax_flat
    g = twin["grad"]
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    floor = _cos(g_ref, g_other)
    got = _cos(g.numpy(), g_ref)
    assert got > min(floor - 0.1, 0.98), (got, floor)


_HOST_SRC = r'''#define __host__
#define __device__
#include "volpath_drt.cuh"
extern "C" void primal_all(const uivr::PrimalParams* p) {
  for (int64_t i = 0; i < p->n; ++i) uivr::primal_lane(*p, i, false);
}
extern "C" void adjoint_all(const uivr::AdjParams* a) {
  for (int64_t i = 0; i < a->P.n; ++i) uivr::adjoint_lane(*a, i);
}
extern "C" void drt_all(const uivr::DrtParams* d, int which, int mis) {
  for (int64_t i = 0; i < d->P.n; ++i) {
    if (which == 0) uivr::drt_walk_lane(*d, i);
    else if (which == 1) uivr::drt_nee_lane(*d, i);
  }
}
extern "C" int sizes(int which) {
  return which == 0 ? (int)sizeof(uivr::PrimalParams)
       : which == 1 ? (int)sizeof(uivr::AdjParams) : (int)sizeof(uivr::DrtParams);
}
'''
@pytest.fixture(scope="module")
def lib():
    lib = host_library(_HOST_SRC, "deferred-lane")
    for f in (lib.primal_all, lib.adjoint_all):
        f.argtypes = [ctypes.c_void_p]
    lib.drt_all.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    for i, s in enumerate((volpath_step.PrimalParams, volpath_step.AdjParams,
                           volpath_step.DrtParams)):
        assert lib.sizes(i) == ctypes.sizeof(s)
    return lib


def test_kernel_lane_logic_matches_deferred_twin(bigenv, twin, lib):
    cfg, tsc = twin["cfg"], bigenv["tsc"]
    o, d = bigenv["o"][:LANES], bigenv["d"][:LANES]
    L = torch.empty(LANES, 3)
    esc = torch.empty(LANES, dtype=torch.bool)
    dims = torch.empty(LANES, dtype=torch.int32)
    steps = torch.empty(LANES, dtype=torch.int32)
    p = volpath_step.primal_params(cfg, tsc, o, d, SEED, L, esc, dims, steps)
    assert (p.nee_H, p.nee_W) == tuple(tsc.emitter.nee.data.shape[:2])
    lib.primal_all(ctypes.byref(p))
    Lt, st = twin["L"][:LANES], twin["stats"]
    assert_lanes_agree(Lt.numpy(), L.numpy())
    assert np.mean(dims.numpy().astype(np.int64) == st["dim"][:LANES].numpy()) > 0.975
    assert np.mean(steps.numpy() == st["steps"][:LANES].numpy()) > 0.975
    # the full-resolution block (deferred=False) is K3's lane, the flat twin's
    full = volpath_step.primal_params(cfg, tsc, o, d, SEED, L, esc, deferred=False)
    assert full.nee_H == 0
    lib.primal_all(ctypes.byref(full))
    Lf, _ = volpath_flat.sample_primal(cfg, tsc, o, d, SEED)
    assert_lanes_agree(Lf.numpy(), L.numpy())
    # K3b is another estimator: the lanes that take NEE differ from K3's
    assert np.mean(np.any(Lf.numpy() != Lt.numpy(), axis=-1)) > 0.05


def test_adjoint_lane_logic_matches_deferred_twin(bigenv, twin, lib):
    cfg, tsc = twin["cfg"], bigenv["tsc"]
    o, d, dL = bigenv["o"][:LANES], bigenv["d"][:LANES], twin["dL"][:LANES]
    Lin = twin["L"][:LANES].contiguous()
    acc = init_accum(tsc.medium, need_emission=False)
    a, res, st = volpath_step.adjoint_params(cfg, tsc, o, d, SEED, dL, Lin, acc)
    assert a.P.nee_H > 0
    lib.adjoint_all(ctypes.byref(a))
    acc_t, res_t, st_t = twin["walk"]
    for k in ("dim", "alt_dim", "steps"):
        assert np.mean(st[k].numpy().astype(np.int64) == st_t[k].numpy()) > 0.975, k
    assert np.mean(res.depth.numpy() == res_t.depth.numpy()) > 0.975
    for g, gt in ((acc.sigma, acc_t.sigma), (acc.albedo, acc_t.albedo)):
        assert float(gt.abs().sum()) > 0
        assert float((g - gt).abs().sum() / gt.abs().sum()) < 1e-4


def test_drt_nee_stays_full_resolution(bigenv, twin, lib):
    """The delayed DRT term's NEE samples the full-resolution map in both
    packages (volpathsimple._nee_primal takes ``scene.emitter``), also when
    its resumed primal runs deferred: the DRT kernels' block carries no
    proxy, and their NEE equals the twin's on every lane.  The reservoir
    vertices are random points and directions in the medium."""
    cfg, tsc = VolpathConfig(max_depth=DEPTH), bigenv["tsc"]
    rs = np.random.RandomState(8)
    o_l = torch.from_numpy(rs.uniform(0.2, 0.8, (DRT_LANES, 3)).astype(np.float32))
    d_w = torch.from_numpy(rs.randn(DRT_LANES, 3).astype(np.float32))
    d_w = d_w / d_w.norm(dim=-1, keepdim=True)
    d_l = transform_dirs(tsc.medium.world_to_local, d_w)
    ones = torch.ones(DRT_LANES, 3)
    res = _Reservoir(wsum=ones, cur_w=ones, depth=torch.zeros(DRT_LANES, dtype=torch.int32),
                     o_l=o_l, d_l=d_l, d_w=d_w, maxt=_exit_dist(o_l, d_l),
                     active=torch.ones(DRT_LANES, dtype=torch.bool))
    adjoint = twin["dL"][:DRT_LANES]

    def twin_drt(deferred):
        return volpath_flat._drt_backward_flat(
            cfg, tsc, SEED, res, adjoint, init_accum(tsc.medium, need_emission=False),
            return_stats=True, deferred=deferred)[1]

    st, st_full = twin_drt(True), twin_drt(False)
    assert torch.equal(st["nee"], st_full["nee"]) and float(st["nee"].abs().sum()) > 0
    assert not torch.equal(st["rec_L"], st_full["rec_L"])
    D, out, _, counts = volpath_step.drt_params(cfg, tsc, SEED, res, adjoint,
                                                init_accum(tsc.medium, need_emission=False))
    assert D.P.nee_H == 0
    lib.drt_all(ctypes.byref(D), 0, 1)
    lib.drt_all(ctypes.byref(D), 1, 1)
    assert counts.tolist() == [st["k_a"], st["k_b"]]
    assert_lanes_agree(st["nee"].numpy(), out["nee"].numpy())
