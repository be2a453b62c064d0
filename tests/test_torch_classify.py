"""K6, the subcell classification of the walking kernels, against the JAX
package and against itself with classification off, on the CPU.

- ``core.grids.cls_dims`` against ``uivr_tpu.ops.volpath_step._cls_dims``;
- the medium's subcell table against the reference's ``build_tables``
  formula, ``build_bound_grid(|sigma|) * (scale * 1.00001)``, on the sparse
  fixture of ``tests/pallas_common.py`` (a 32^3 smoke whose density lives
  only in a central block, so it has empty and occupied subcells);
- the CUDA lane logic (``ops/csrc/volpath_lane.cuh``, ``volpath_adjoint.cuh``)
  built for the host with g++: classification on equals classification off
  on every lane (radiance bit for bit, draws, steps; the adjoint's draws,
  reservoir and gradients), on the sparse fixture and on the same density
  under one global majorant with 16^3 subcells, where both classification
  branches (MAIN nulls, SHADOW events in empty subcells) fire;
- the classified lane against the JAX flat engine, by the rule of the
  Pallas kernel tests (``assert_lanes_agree``).

Classification decides an event from an upper bound of sigma only where
the fetch would decide the same, and takes the same draws, so the two
builds must agree exactly; any difference is a fault.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_common import assert_lanes_agree, both_scenes, camera_rays, host_library
from uivr_tpu.config import smoke_scene
from uivr_tpu.core.grids import build_bound_grid as j_build_bound_grid
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.integrators import volpath_flat as jflat
from uivr_tpu.ops.volpath_step import _cls_dims
from uivr_tpu_torch.core.grids import cls_dims
from uivr_tpu_torch.integrators import VolpathConfig
from uivr_tpu_torch.ops import volpath_step
from uivr_tpu_torch.scene.gradients import init_accum
from uivr_tpu_torch.scene.medium import finalize_medium
from uivr_tpu_torch.scene.scene import Scene

SEED = 29
N_RAYS = 1024
CFG = dict(max_depth=4, rr_depth=2, shadow_rr=0.05)
ADJ_CFG = dict(max_depth=4, trans_grad_samples=2, shadow_rr=0.05)


def _sparse_bundle(**kw):
    """tests/pallas_common.py's sparse fixture: a 32^3 smoke whose density
    (x4) lives only in the central block [10:22]^3."""
    b = smoke_scene(res=32, resx=32, resy=32, n_sensors=2, **kw)
    sig = np.asarray(b.params.sigma_t).copy()
    mask = np.zeros_like(sig)
    mask[10:22, 10:22, 10:22] = 1.0
    b.params = b.params._replace(sigma_t=jnp.asarray(sig * mask * 4.0))
    return b


@pytest.fixture(scope="module")
def fixtures():
    """{name: (JAX bundle, JAX scene, port scene on, port scene off, rays)}:
    the sparse fixture, and the same density under one global majorant
    (majorant factor 1 -> a single cell) with its 16^3 subcells.  On the
    sparse fixture every supercell with density has density in each of its
    subcells' supports, so shadow walks meet candidates only where hi > 0;
    under the global majorant they also meet them in empty subcells."""
    out = {}
    for name, jb in (("sparse", _sparse_bundle()),
                     ("global", _sparse_bundle(majorant_factor=1))):
        jsc, tb, on = both_scenes(jb)
        off = Scene(medium=finalize_medium(
            tb.params, dataclasses.replace(tb.medium_cfg, cls_cells=0), tb.to_world),
            emitter=tb.emitter, cameras=tb.cameras)
        out[name] = (jb, jsc, on, off, camera_rays(jb, n=N_RAYS))
    return out


_HOST_SRC = r'''#define __host__
#define __device__
#include "volpath_adjoint.cuh"
extern "C" void primal_all(const uivr::PrimalParams* p) {
  for (int64_t i = 0; i < p->n; ++i) uivr::primal_lane(*p, i, false);
}
extern "C" void adjoint_all(const uivr::AdjParams* a) {
  for (int64_t i = 0; i < a->P.n; ++i) uivr::adjoint_lane(*a, i);
}
extern "C" int sizes(int which) {
  return which == 0 ? (int)sizeof(uivr::PrimalParams) : (int)sizeof(uivr::AdjParams);
}
'''


@pytest.fixture(scope="module")
def lib():
    lib = host_library(_HOST_SRC, "classify-lane")
    lib.primal_all.argtypes = [ctypes.c_void_p]
    lib.adjoint_all.argtypes = [ctypes.c_void_p]
    assert lib.sizes(0) == ctypes.sizeof(volpath_step.PrimalParams)
    assert lib.sizes(1) == ctypes.sizeof(volpath_step.AdjParams)
    return lib


def _host_primal(lib, sc, o, d):
    n = o.shape[0]
    out = dict(L=torch.empty(n, 3), escaped=torch.empty(n, dtype=torch.bool),
               dim=torch.empty(n, dtype=torch.int32), steps=torch.empty(n, dtype=torch.int32),
               cls=torch.empty(n, len(volpath_step.CLS_COUNTERS), dtype=torch.int32))
    p = volpath_step.primal_params(VolpathConfig(**CFG), sc, o, d, SEED, out["L"],
                                   out["escaped"], out["dim"], out["steps"],
                                   cls_counts=out["cls"])
    lib.primal_all(ctypes.byref(p))
    return out


def _host_adjoint(lib, sc, o, d, dL, L):
    acc = init_accum(sc.medium, need_emission=False)
    a, res, st = volpath_step.adjoint_params(VolpathConfig(**ADJ_CFG), sc, o, d, SEED, dL,
                                             L, acc)
    lib.adjoint_all(ctypes.byref(a))
    return acc, res, st


def _counts(cls):
    return dict(zip(volpath_step.CLS_COUNTERS, cls.sum(0).tolist()))


@pytest.fixture(scope="module")
def primal(lib, fixtures):
    """Host-built primal lanes, classification on and off, per fixture."""
    out = {}
    for name, (_, _, on, off, (_, (o, d))) in fixtures.items():
        out[name] = (_host_primal(lib, on, o, d), _host_primal(lib, off, o, d))
    return out


@pytest.mark.parametrize("shape", [(3, 3, 3), (32, 32, 32), (128, 128, 128),
                                   (256, 256, 256), (264, 136, 136)])
def test_cls_dims_match_jax(shape):
    assert cls_dims(shape) == _cls_dims(shape)
    assert cls_dims(shape + (1,), 0) == (0, 0, 0)


def test_subcell_table_matches_jax(fixtures):
    _, jsc, on, off, _ = fixtures["sparse"]
    m = jsc.medium
    dims = _cls_dims(m.params.sigma_t.shape)
    hi = j_build_bound_grid(jnp.abs(m.params.sigma_t), dims) * (m.scale * jnp.float32(1.00001))
    hi = np.asarray(hi)
    assert on.medium.sub.shape == dims == (16, 16, 16)
    np.testing.assert_array_equal(on.medium.sub.numpy(), hi)
    # the fixture has empty and occupied subcells
    assert (hi == 0.0).mean() > 0.3 and (hi > 0.0).mean() > 0.02
    assert off.medium.sub is None
    assert fixtures["global"][2].medium.majorant_grid.shape == (1, 1, 1)
    assert fixtures["global"][2].medium.sub.shape == (16, 16, 16)


@pytest.mark.parametrize("name", ["sparse", "global"])
def test_classified_primal_lane_equals_unclassified(name, primal):
    on, off = primal[name]
    assert torch.equal(on["L"], off["L"])     # bit for bit
    for k in ("escaped", "dim", "steps"):
        assert torch.equal(on[k], off[k]), k
    c_on, c_off = _counts(on["cls"]), _counts(off["cls"])
    # the same candidates and nulls; off fetches at every candidate, on
    # fetches the rest
    assert c_off["candidates"] == c_on["candidates"] == c_off["fetches"] > 0
    assert c_off["main_nulls"] == c_on["main_nulls"] >= c_on["cls_main_nulls"] > 0
    assert c_off["cls_main_nulls"] == c_off["cls_shadow"] == 0
    assert c_on["candidates"] == c_on["cls_main_nulls"] + c_on["cls_shadow"] + c_on["fetches"]


def test_both_classification_branches_fire(primal):
    c = _counts(primal["global"][0]["cls"])
    assert c["cls_main_nulls"] > 0 and c["cls_shadow"] > 0, c
    assert _counts(primal["sparse"][0]["cls"])["cls_main_nulls"] > 0


@pytest.mark.parametrize("name", ["sparse", "global"])
def test_classified_adjoint_lane_equals_unclassified(name, lib, fixtures, primal):
    _, _, on, off, (_, (o, d)) = fixtures[name]
    dL = torch.from_numpy(np.random.RandomState(5).rand(N_RAYS, 3).astype(np.float32) / N_RAYS)
    L = primal[name][1]["L"]
    acc_on, res_on, st_on = _host_adjoint(lib, on, o, d, dL, L)
    acc_off, res_off, st_off = _host_adjoint(lib, off, o, d, dL, L)
    for k in ("dim", "alt_dim", "steps", "events"):
        assert torch.equal(st_on[k], st_off[k]), k
    for f in res_on._fields:
        assert torch.equal(getattr(res_on, f), getattr(res_off, f)), f
    # on the host the scatters run in lane order: gradients bit for bit
    assert float(acc_off.sigma.abs().sum()) > 0
    assert torch.equal(acc_on.sigma, acc_off.sigma)
    assert torch.equal(acc_on.albedo, acc_off.albedo)
    c_on, c_off = _counts(st_on["cls"]), _counts(st_off["cls"])
    assert c_on["cls_main_nulls"] > 0 and c_on["fetches"] < c_off["fetches"]
    assert c_on["main_nulls"] == c_off["main_nulls"]
    if name == "global":
        assert c_on["cls_shadow"] > 0


def test_classified_lane_matches_jax_flat(fixtures, primal):
    jb, jsc, _, _, ((jo, jd), _) = fixtures["sparse"]
    Lj, _ = jax.jit(lambda o, d: jflat.sample_primal(JCfg(**CFG), jsc, o, d,
                                                     jnp.uint32(SEED)))(jo, jd)
    assert_lanes_agree(np.asarray(Lj), primal["sparse"][0]["L"].numpy())
