"""The primal path tracer of the port against the JAX package, on the CPU.

- the plain twin (``uivr_tpu_torch.integrators.volpath_flat``) against the
  JAX flat engine on the same 1024 camera rays, with the JAX bundle carried
  across by ``bundle_from_numpy``;
- the CUDA kernel's lane logic (``ops/csrc/volpath_lane.cuh``), compiled
  for the host with g++, against the plain twin.

Lanes may flip at float ties: a walk's cell exit and its medium exit are
computed by different formulas and often round to within an ulp of each
other, so an ulp of difference anywhere earlier (XLA:CPU's own log1p, sin
and cos, its fused multiply-adds) can add a crossing step, which shifts the
lane's draws.  Nearly every lane must match all the same (the rule of the
Pallas kernel tests); a draw-order fault would break most of them.  Paths
grow longer with depth and flips with them: the smoke fixture runs at
max_depth 4, where the twin matches the JAX engine on 98.7% of lanes
(97.1% at depth 8).
"""
import ctypes
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_common import assert_lanes_agree, both_scenes, camera_rays
from uivr_tpu.config import cube_test_scene, smoke_scene
from uivr_tpu.integrators import VolpathConfig as JCfg
from uivr_tpu.integrators import volpath_flat as jflat
from uivr_tpu_torch.integrators import VolpathConfig, volpath_flat
from uivr_tpu_torch.ops import volpath_step
from uivr_tpu_torch.render import batched

SEED = 42
CASES = {   # fixture, integrator settings
    "cube-nee": ("cube", dict(max_depth=8)),
    "cube-no-nee": ("cube", dict(max_depth=6, use_nee=False)),
    "smoke": ("smoke", dict(max_depth=4)),
}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, jb in (("cube", cube_test_scene()),
                     ("smoke", smoke_scene(res=16, resx=32, resy=32, n_sensors=2))):
        jsc, _, tsc = both_scenes(jb)
        out[name] = (jsc, tsc) + camera_rays(jb, n=1024)
    return out


@pytest.fixture(scope="module")
def twin(scenes):
    """The plain twin's result and stats for every case."""
    res = {}
    for case, (fx, kw) in CASES.items():
        _, tsc, _, (o, d) = scenes[fx]
        res[case] = volpath_flat.sample_primal(VolpathConfig(**kw), tsc, o, d, SEED,
                                               return_stats=True)
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_flat_engine(case, scenes, twin):
    fx, kw = CASES[case]
    jsc, _, (jo, jd), _ = scenes[fx]
    Lj, ej = jflat.sample_primal(JCfg(**kw), jsc, jo, jd, jnp.uint32(SEED))
    L, esc, _ = twin[case]
    assert_lanes_agree(np.asarray(Lj), L.numpy())
    assert np.mean(np.asarray(ej) == esc.numpy()) > 0.975


def _host_lane_library():
    """The kernel's lane logic built for the host (cached by source hash)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    src = ("#define __host__\n#define __device__\n#include \"volpath_lane.cuh\"\n"
           "extern \"C\" void trace_all(const uivr::PrimalParams* p) {\n"
           "  for (int64_t i = 0; i < p->n; ++i) uivr::primal_lane(*p, i, false);\n}\n"
           "extern \"C\" int params_size() { return (int)sizeof(uivr::PrimalParams); }\n")
    h = hashlib.sha256(src.encode())
    for name in ("rng.cuh", "volpath_lane.cuh"):
        h.update((volpath_step.CSRC / name).read_bytes())
    out = volpath_step.build_dir() / "host" / f"liblane-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".tmp")
        subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-I", str(volpath_step.CSRC), "-",
                        "-o", str(tmp)], input=src, text=True, check=True,
                       capture_output=True)
        tmp.replace(out)
    lib = ctypes.CDLL(str(out))
    lib.trace_all.argtypes = [ctypes.c_void_p]
    assert lib.params_size() == ctypes.sizeof(volpath_step.PrimalParams)
    return lib


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_lane_logic_matches_twin(case, scenes, twin):
    lib = _host_lane_library()
    fx, kw = CASES[case]
    _, tsc, _, (o, d) = scenes[fx]
    n = o.shape[0]
    L = torch.empty(n, 3)
    esc = torch.empty(n, dtype=torch.bool)
    dims = torch.empty(n, dtype=torch.int32)
    steps = torch.empty(n, dtype=torch.int32)
    p = volpath_step.primal_params(VolpathConfig(**kw), tsc, o, d, SEED, L, esc,
                                   dims, steps)
    lib.trace_all(ctypes.byref(p))
    Lt, et, st = twin[case]
    assert_lanes_agree(Lt.numpy(), L.numpy())
    assert np.mean(dims.numpy().astype(np.int64) == st["dim"].numpy()) > 0.975
    assert np.mean(steps.numpy() == st["steps"].numpy()) > 0.975


def test_kernel_wrapper_on_cpu_is_the_plain_twin(scenes, twin):
    _, tsc, _, (o, d) = scenes["cube"]
    before = dict(volpath_step.LAUNCHES)
    calls = volpath_flat.CALLS["volpath_primal"]
    L, esc, st = volpath_step.sample_primal_kernel(VolpathConfig(max_depth=8), tsc, o, d,
                                                   SEED, return_stats=True)
    assert volpath_step.LAUNCHES == before
    assert volpath_flat.CALLS["volpath_primal"] == calls + 1
    assert torch.equal(L, twin["cube-nee"][0])
    assert torch.equal(st["steps"], twin["cube-nee"][2]["steps"])


def test_step_bound_and_engine_resolution(scenes):
    _, tsc, _, (o, d) = scenes["smoke"]
    cfg = VolpathConfig(max_depth=8, max_steps=7)
    L, _, st = volpath_flat.sample_primal(cfg, tsc, o, d, SEED, return_stats=True)
    assert int(st["steps"].max()) == 7 and torch.isfinite(L).all()
    assert batched._resolve_engine(VolpathConfig(), o) == "flat"
    assert batched._resolve_engine(VolpathConfig(engine="pallas"), o) == "flat"
    assert batched._resolve_engine(VolpathConfig(engine="flat"), o) == "flat"
    with pytest.raises(NotImplementedError):
        batched._resolve_engine(VolpathConfig(engine="nested"), o)
