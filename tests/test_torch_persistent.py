"""The persistent scheduling of the walking kernels, on the CPU.

The CUDA kernels ``volpath_primal_kernel`` and ``volpath_adjoint_kernel``
run the tasks of ``ops/csrc/persistent.cuh`` (``PrimalTask``,
``AdjointTask``: one tracking event per ``lane_step``) under a scheduler in
which a lane takes a new ray from a shared work counter as soon as its ray
ends.  Here the same tasks, built for the host with g++, run under an
emulation of that scheduler: warps of 32 lanes take turns, each claims
indices for its idle lanes in lane order from one counter, then steps its
busy lanes once.  Rays then occupy lanes in another order than one thread
per ray, and every ray must still come out as the one-ray-per-lane build
(``primal_lane``, ``adjoint_lane``) and the plain twin give it:

- the primal, from world rays and from a ``PathState``, on the cube and on
  the sparse smoke (K6 on): radiance bit for bit, escapes, draws, steps
  and K6's counters;
- the adjoint's per-ray outputs (draws, alt draws, steps, events,
  reservoir) bit for bit; its gradients, whose float sums run in another
  order, within ``tests/test_torch_adjoint.py``'s relative L1 (against the
  twin on the cube, whose walk takes seconds on the sparse smoke);
- the launch path reads nothing back from tensors: ``primal_params`` and
  ``adjoint_params`` build their blocks from host copies, with every
  device-to-host read refused.
"""
import ctypes

import numpy as np
import pytest
import torch

from torch_common import bundle_to_numpy, host_library, sparse_smoke_bundle
from torch_common import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from uivr_tpu.config import cube_test_scene
from uivr_tpu_torch.config import bundle_from_numpy
from uivr_tpu_torch.core.aabb import ray_unit_cube
from uivr_tpu_torch.integrators import VolpathConfig, volpath_flat
from uivr_tpu_torch.integrators.volpathsimple import PathState
from uivr_tpu_torch.ops import volpath_step
from uivr_tpu_torch.scene.camera import sample_rays
from uivr_tpu_torch.scene.gradients import init_accum
from uivr_tpu_torch.scene.medium import finalize_medium
from uivr_tpu_torch.scene.scene import Scene

SEED = 23
N_RAYS = 1024
WARPS = 3       # emulated warps taking turns on the counter
CFG = dict(max_depth=6, rr_depth=3, shadow_rr=0.05, trans_grad_samples=2)

_HOST_SRC = r'''#define __host__
#define __device__
#include <vector>
#include "persistent.cuh"

// run_persistent's schedule on the host: `warps` warps of 32 lanes take
// turns; a warp with idle lanes claims consecutive indices from the
// counter for them in lane order, then every busy lane runs one event,
// and a lane whose walk is over writes its ray.  refill_min > 1 makes a
// warp wait for that many idle lanes (or all) before it claims, which
// runs other rays on other lanes.  who[i]: the lane (warp * 32 + lane)
// that ran ray i.
template <class Task, class Make>
static void emulate(int64_t n, int warps, int refill_min, Make make, int32_t* who) {
  std::vector<Task> lanes;
  lanes.reserve(32 * warps);
  for (int k = 0; k < 32 * warps; ++k) lanes.push_back(make());
  std::vector<int64_t> ray(32 * warps, 0);
  std::vector<char> busy(32 * warps, 0), more(warps, 1), done(warps, 0);
  uint64_t counter = 0;
  for (int live = warps; live > 0;) {
    for (int w = 0; w < warps; ++w) {
      if (done[w]) continue;
      char* b = &busy[32 * w];
      if (more[w]) {
        int idle = 0;
        for (int l = 0; l < 32; ++l) idle += b[l] ? 0 : 1;
        if (idle >= refill_min || idle == 32) {
          const uint64_t base = counter;
          counter += idle;
          more[w] = base + idle < (uint64_t)n;
          uint64_t rank = 0;
          for (int l = 0; l < 32; ++l) {
            if (b[l]) continue;
            const uint64_t i = base + rank++;
            if (i < (uint64_t)n) {
              ray[32 * w + l] = (int64_t)i;
              lanes[32 * w + l].begin((int64_t)i);
              who[i] = 32 * w + l;
              b[l] = 1;
            }
          }
        }
      }
      bool any = false;
      for (int l = 0; l < 32; ++l) any = any || b[l];
      if (!any) {
        if (!more[w]) {
          done[w] = 1;
          --live;
        }
        continue;
      }
      for (int l = 0; l < 32; ++l) {
        if (!b[l]) continue;
        Task& t = lanes[32 * w + l];
        if (!t.finished()) t.step();
        if (t.finished()) {
          t.end(ray[32 * w + l]);
          b[l] = 0;
        }
      }
    }
  }
}

extern "C" void primal_persistent(const uivr::PrimalParams* p, int from_state, int warps,
                                  int refill_min, int32_t* who) {
  emulate<uivr::PrimalTask>(p->n, warps, refill_min,
                            [&] { return uivr::PrimalTask(*p, from_state != 0); }, who);
}
extern "C" void primal_direct(const uivr::PrimalParams* p, int from_state) {
  for (int64_t i = 0; i < p->n; ++i) uivr::primal_lane(*p, i, from_state != 0);
}
extern "C" void adjoint_persistent(const uivr::AdjParams* a, int warps, int refill_min,
                                   int32_t* who) {
  emulate<uivr::AdjointTask>(a->P.n, warps, refill_min,
                             [&] { return uivr::AdjointTask(*a); }, who);
}
extern "C" void adjoint_direct(const uivr::AdjParams* a) {
  for (int64_t i = 0; i < a->P.n; ++i) uivr::adjoint_lane(*a, i);
}
extern "C" int sizes(int which) {
  return which == 0 ? (int)sizeof(uivr::PrimalParams) : (int)sizeof(uivr::AdjParams);
}
'''


@pytest.fixture(scope="module")
def lib():
    lib = host_library(_HOST_SRC, "persistent-lane")
    lib.primal_persistent.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.primal_direct.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.adjoint_persistent.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.adjoint_direct.argtypes = [ctypes.c_void_p]
    assert lib.sizes(0) == ctypes.sizeof(volpath_step.PrimalParams)
    assert lib.sizes(1) == ctypes.sizeof(volpath_step.AdjParams)
    return lib


def _path_state(tsc, n, seed):
    """Resumed paths inside the medium's unit cube (90% active)."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d_w = rs.randn(n, 3).astype(np.float32)
    d_w /= np.linalg.norm(d_w, axis=1, keepdims=True)
    d_w = torch.from_numpy(d_w)
    d_l = (d_w @ tsc.medium.world_to_local[:3, :3].T).contiguous()
    o = torch.from_numpy(o)
    _, tf, _ = ray_unit_cube(o, d_l)
    return PathState(active=torch.from_numpy(rs.rand(n) < 0.9),
                     depth=torch.from_numpy(rs.randint(0, 2, n).astype(np.int32)),
                     o_l=o, d_l=d_l, d_w=d_w.contiguous(), maxt=tf.contiguous(),
                     last_pdf=torch.from_numpy(rs.uniform(0.05, 1.0, n).astype(np.float32)))


@pytest.fixture(scope="module")
def fixtures():
    """{name: (port scene, world rays o, d, path state)}: the reference cube
    and the sparse smoke with K6's subcell table, carried to the port (the
    JAX side is not run here: every comparison is within the port)."""
    out = {}
    rs = np.random.RandomState(4)
    for name, jb in (("cube", cube_test_scene()), ("sparse", sparse_smoke_bundle())):
        tb = bundle_from_numpy(bundle_to_numpy(jb), device="cpu")
        tsc = Scene(finalize_medium(tb.params, tb.medium_cfg, tb.to_world), tb.emitter,
                    tb.cameras)
        uv = torch.from_numpy((rs.rand(N_RAYS, 2) * 0.6 + 0.2).astype(np.float32))
        o, d = sample_rays(tb.cameras, torch.zeros(N_RAYS, dtype=torch.int64), uv)
        out[name] = (tsc, o.contiguous(), d.contiguous(), _path_state(tsc, N_RAYS, 8))
    return out


def _primal_out(n):
    return dict(L=torch.empty(n, 3), escaped=torch.empty(n, dtype=torch.bool),
                dim=torch.empty(n, dtype=torch.int32), steps=torch.empty(n, dtype=torch.int32),
                cls=torch.empty(n, len(volpath_step.CLS_COUNTERS), dtype=torch.int32))


def _host_primal(lib, tsc, o, d, ps, persistent, refill_min=1):
    n = N_RAYS
    out = _primal_out(n)
    p = volpath_step.primal_params(VolpathConfig(**CFG), tsc, o, d, SEED, out["L"],
                                   out["escaped"], out["dim"], out["steps"], path_state=ps,
                                   cls_counts=out["cls"])
    if persistent:
        who = torch.full((n,), -1, dtype=torch.int32)
        lib.primal_persistent(ctypes.byref(p), int(ps is not None), WARPS, refill_min,
                              who.data_ptr())
        out["who"] = who
    else:
        lib.primal_direct(ctypes.byref(p), int(ps is not None))
    return out


def _assert_refilled(who):
    """Every ray ran, lanes took several rays each, and not in the order of
    one thread per ray."""
    assert int(who.min()) >= 0
    assert len(set(who.tolist())) == 32 * WARPS
    assert not torch.equal(who, torch.arange(who.shape[0], dtype=torch.int32) % (32 * WARPS))


@pytest.mark.parametrize("name", ["cube", "sparse"])
def test_persistent_primal_equals_lanes_and_twin(name, lib, fixtures):
    """World rays and the path state, each against primal_lane and the
    twin; on the sparse smoke also a warp that waits for 8 idle lanes
    before it claims, which runs other rays on other lanes."""
    tsc, o, d, path_state = fixtures[name]
    for ps in (None, path_state):
        per = _host_primal(lib, tsc, o, d, ps, persistent=True)
        one = _host_primal(lib, tsc, o, d, ps, persistent=False)
        _assert_refilled(per["who"])
        for k in ("L", "escaped", "dim", "steps", "cls"):     # L bit for bit
            assert torch.equal(per[k], one[k]), k
        L, e, st = volpath_flat.sample_primal(VolpathConfig(**CFG), tsc, o, d, SEED,
                                              return_stats=True, path_state=ps, deferred=True)
        assert torch.equal(per["L"], L) and torch.equal(per["escaped"], e)
        assert torch.equal(per["dim"].long(), st["dim"])
        assert torch.equal(per["steps"], st["steps"])
        assert float(L.abs().sum()) > 0 and int(per["steps"].max()) > 8
    if name == "sparse":
        assert int(per["cls"][:, 2].sum()) > 0      # K6 classified MAIN nulls
        late = _host_primal(lib, tsc, o, d, ps, persistent=True, refill_min=8)
        assert not torch.equal(late["who"], per["who"])
        for k in ("L", "escaped", "dim", "steps", "cls"):
            assert torch.equal(late[k], per[k]), k


def _rel_l1(ref, x):
    return float((ref - x).abs().sum() / ref.abs().sum().clamp_min(1e-30))


@pytest.mark.parametrize("name", ["cube", "sparse"])
def test_persistent_adjoint_equals_lanes_and_twin(name, lib, fixtures):
    tsc, o, d, _ = fixtures[name]
    n = N_RAYS
    cfg = VolpathConfig(**CFG)
    dL = torch.from_numpy(np.random.RandomState(3).rand(n, 3).astype(np.float32) / n)
    L, _ = volpath_flat.sample_primal(cfg, tsc, o, d, SEED, deferred=True)
    runs = {}
    for tag in ("persistent", "direct"):
        acc = init_accum(tsc.medium, need_emission=False)
        a, res, st = volpath_step.adjoint_params(cfg, tsc, o, d, SEED, dL, L, acc)
        if tag == "persistent":
            who = torch.full((n,), -1, dtype=torch.int32)
            lib.adjoint_persistent(ctypes.byref(a), WARPS, 1, who.data_ptr())
            _assert_refilled(who)
        else:
            lib.adjoint_direct(ctypes.byref(a))
        runs[tag] = (acc, res, st)
    (acc_p, res_p, st_p), (acc_d, res_d, st_d) = runs["persistent"], runs["direct"]
    for k in ("dim", "alt_dim", "steps", "events", "cls"):
        assert torch.equal(st_p[k], st_d[k]), k
    for f in res_p._fields:
        assert torch.equal(getattr(res_p, f), getattr(res_d, f)), f
    # the scatters add in the schedule's order: sums, not bits
    assert float(acc_d.sigma.abs().sum()) > 0
    assert _rel_l1(acc_d.sigma, acc_p.sigma) < 1e-4
    assert _rel_l1(acc_d.albedo, acc_p.albedo) < 1e-4
    if name != "cube":   # the twin's walk on the sparse smoke takes seconds
        return
    acc_t, res_t, st_t = volpath_flat.adjoint_walk(cfg, tsc, o, d, SEED, dL, L, deferred=True)
    for k in ("dim", "alt_dim", "steps"):
        assert torch.equal(st_p[k].long() & 0xFFFFFFFF, st_t[k].long()), k
    assert torch.equal(res_p.depth, res_t.depth) and torch.equal(res_p.wsum, res_t.wsum)
    assert _rel_l1(acc_t.sigma, acc_p.sigma) < 1e-4
    assert _rel_l1(acc_t.albedo, acc_p.albedo) < 1e-4


def test_launch_blocks_read_nothing_back(fixtures, monkeypatch):
    """primal_params and adjoint_params take every constant from host
    copies: with reads from tensors refused, both blocks still build, with
    the transforms' and the emitter's values."""
    tsc, o, d, _ = fixtures["cube"]
    cfg = VolpathConfig(**CFG)
    n = o.shape[0]
    L, dL = torch.zeros(n, 3), torch.zeros(n, 3)
    acc = init_accum(tsc.medium, need_emission=False)
    w2l = tsc.medium.world_to_local[:3, :4].reshape(-1).tolist()
    rad = tsc.emitter.radiance.tolist()
    weight = tsc.emitter.weight.tolist()

    def refuse(*a, **k):
        raise AssertionError("a launch block read a tensor back")
    for name in ("tolist", "item", "cpu", "numpy", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    p = volpath_step.primal_params(cfg, tsc, o, d, SEED, L, torch.zeros(n, dtype=torch.bool))
    a, _, _ = volpath_step.adjoint_params(cfg, tsc, o, d, SEED, dL, L, acc)
    monkeypatch.undo()
    for blk in (p, a.P):
        assert list(blk.w2l) == w2l
        assert list(blk.radiance) == rad and list(blk.const_weight) == weight
