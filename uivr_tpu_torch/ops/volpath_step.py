"""The hand-written Hopper kernels of the path tracer: build, bind, wrap.

Port of ``uivr_tpu/ops/volpath_step.py`` (its step kernel in primal and
adjoint form, K-candidate batching in the primal, the host loops that run
it) and of the delayed DRT term around it
(``uivr_tpu/integrators/volpath_flat._drt_backward_flat``).
The CUDA sources live in ``csrc/``:

- ``rng.cuh``             TEA hash, unit float and the wavefront sampler's
                          draw (K1)
- ``volpath_lane.cuh``    one lane's tracking state machine with trilinear
                          sigma+albedo reads and emitter NEE (K2, K3), run
                          to completion per ray (K5's keying), a template on
                          its hooks; world-ray and PathState entries; the
                          subcell classification in front of the sigma
                          fetch (K6); deferred-radiance NEE from an
                          envmap's coarse proxy (K3b); the primal's
                          K-candidate batches (K7)
- ``volpath_adjoint.cuh`` the adjoint hooks: REPLAY walk, PRB and
                          transmittance cotangents, DRT reservoir (K4, K5)
- ``volpath_drt.cuh``     the delayed DRT term's lanes and tasks: the walk
                          (draws from a table of pre-hashes), the NEE, the
                          phase sampling, the scatter
- ``persistent.cuh``      the persistent scheduler of the walking kernels
                          (primal, K7 primal, adjoint, the DRT term's walk
                          and NEE): lanes take rays from a work counter and
                          a new one as soon as theirs ends
- ``nerf.cuh``            one ray of the NeRF stage's march, primal and
                          adjoint (wrapped by ``ops/nerf_step.py``)
- ``volpath_primal.cu``, ``volpath_adjoint.cu``, ``volpath_drt.cu``,
  ``nerf.cu``: the ``__global__`` kernels and ``extern "C"`` launchers, one
  library each

Each ``.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/uivr_tpu_torch/`` (keyed by a hash of the sources and flags);
the first use starts all missing builds at once, and the libraries are
loaded with ``ctypes``.  Each wrapper launches on PyTorch's current stream
and counts its launches in :data:`LAUNCHES`.  On ``cpu`` tensors a wrapper
runs the kernel's plain version instead (``core/rng.tea_plain`` and the
twins in ``integrators/volpath_flat.py``, in their deferred mode: the
walking kernels take K3b whenever the envmap has a proxy, as the
reference's ``_em_dims`` decides); on ``cuda`` tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..core.rng import _DRAW_ROUNDS, _M32, sample_tea_32, tea_plain
from ..integrators import volpath_flat
from ..integrators.volpathsimple import (PathState, VolpathConfig, _Reservoir,
                                         _reservoir_get)
from ..scene.emitters import ConstantEmitter, EnvmapEmitter
from ..scene.gradients import GradAccum, finalize_accum, init_accum
from ..scene.scene import Scene

# kernel launches, by kernel, since the process started (or a caller reset);
# "subcell_classification" counts the walking kernels' launches that ran K6
# (their medium had a subcell table), "deferred_nee" those that ran K3b
# (their envmap had a coarse proxy), "k_candidate" the primal launches that
# ran K7 (``volpath_primal_k_kernel``, k_cand > 1).  The ``*_direct``
# kernels are the one-ray-per-thread kernels that the persistent ones
# replaced, launched only when a caller asks (``direct``) to compare the
# two; ``volpath_primal_k_direct`` is K7's (it counts as a K7 launch too).
LAUNCHES = {"volpath_primal": 0, "volpath_primal_state": 0, "tea": 0,
            "volpath_adjoint": 0, "volpath_drt_walk": 0, "volpath_drt_nee": 0,
            "volpath_drt_phase": 0, "volpath_drt_scatter": 0,
            "subcell_classification": 0, "deferred_nee": 0, "k_candidate": 0,
            "volpath_primal_direct": 0, "volpath_primal_state_direct": 0,
            "volpath_primal_k_direct": 0, "volpath_adjoint_direct": 0,
            "volpath_drt_walk_direct": 0, "volpath_drt_nee_direct": 0,
            "nerf_primal": 0, "nerf_adjoint": 0}
# K6's per-lane counters (``cls`` of the walking kernels' stats), in order:
# candidate collisions of every walk (MAIN, SHADOW, REPLAY), MAIN null
# events, of which classified, classified SHADOW events, sigma fetches
CLS_COUNTERS = ("candidates", "main_nulls", "cls_main_nulls", "cls_shadow", "fetches")
# K7's per-lane counters, in order: dispatches (batches), cell steps of
# every batch, collision candidates fetched, of which past a terminal event
K7_COUNTERS = ("batches", "cell_steps", "fetched", "discarded")
# the instantiations of volpath_primal_k_kernel: the largest k_cand each takes
K7_BUILDS = (2, 4, 8)
# per-warp counters of a persistent launch's lane utilization, in order:
# events run by busy lanes, warp iterations (``util`` of the stats)
UTIL_COUNTERS = ("lane_steps", "iterations")
# None, or a list to which every launch appends (kernel, start, end): CUDA
# events recorded on the launch's stream just before and after it
TIMINGS = None

CSRC = Path(__file__).resolve().parent / "csrc"
HEADERS = ("rng.cuh", "volpath_lane.cuh", "volpath_adjoint.cuh",
           "volpath_drt.cuh", "persistent.cuh", "nerf.cuh")
# library -> its CUDA source
LIBS = {"primal": "volpath_primal.cu", "adjoint": "volpath_adjoint.cu",
        "drt": "volpath_drt.cu", "nerf": "nerf.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# what the last build of each library did: seconds (None when the library
# was cached), nvcc's output (ptxas' register and spill report) and path
BUILD = {name: {"seconds": None, "log": "", "path": None} for name in LIBS}

_libs = {}


def build_dir() -> Path:
    """``build/uivr_tpu_torch`` at the root of the checkout."""
    return CSRC.parents[2] / "build" / "uivr_tpu_torch"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def lib_path(name: str) -> Path:
    """Where library ``name`` is built, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in HEADERS + (LIBS[name],):
        h.update((CSRC / src).read_bytes())
    return build_dir() / f"libuivr_{name}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every library whose build is missing, one ``nvcc`` per
    source, all started together; returns {name: path}."""
    paths = {name: lib_path(name) for name in LIBS}
    jobs = {}
    for name, lib in paths.items():
        BUILD[name]["path"] = lib
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(CSRC / LIBS[name])],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs[name] = (proc, tmp, time.time())
    failed = []
    for name, (proc, tmp, t0) in jobs.items():
        out, _ = proc.communicate()
        BUILD[name]["seconds"] = time.time() - t0
        BUILD[name]["log"] = out
        if proc.returncode != 0:
            failed.append(f"{LIBS[name]}: nvcc failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


class PrimalParams(ctypes.Structure):
    """Mirror of ``uivr::PrimalParams`` in ``csrc/volpath_lane.cuh``."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "o", "d", "L", "escaped", "dims", "steps", "grid", "majorant",
            "env_data", "env_alias", "env_row_pmf", "env_cond_pmf",
            "nee_alias", "nee_row_pmf", "nee_cond_pmf", "ps_active", "ps_depth",
            "ps_o", "ps_d_l", "ps_d_w", "ps_maxt", "ps_last_pdf", "sub", "cls_counts",
            "kc_counts")]
        + [("n", ctypes.c_int64)]
        + [(f, ctypes.c_int32) for f in (
            "D", "H", "W", "Dc", "Hc", "Wc", "Ds", "Hs", "Ws", "env_H", "env_W",
            "nee_H", "nee_W", "emitter",
            "max_depth", "rr_depth", "max_steps", "draw_rounds", "use_nee",
            "hide_emitters", "k_cand", "cross_steps")]
        + [("seed", ctypes.c_uint32)]
        + [(f, ctypes.c_float) for f in (
            "scale", "phase_g", "shadow_rr", "inv_shadow_rr")]
        + [("w2l", ctypes.c_float * 12), ("env_to_world", ctypes.c_float * 9),
           ("radiance", ctypes.c_float * 3), ("const_weight", ctypes.c_float * 3)])


class AdjParams(ctypes.Structure):
    """Mirror of ``uivr::AdjParams`` in ``csrc/volpath_adjoint.cuh``."""
    _fields_ = (
        [("P", PrimalParams)]
        + [(f, ctypes.c_void_p) for f in (
            "L_in", "dL", "g_sigma", "g_albedo", "res_wsum", "res_cur_w",
            "res_depth", "res_o", "res_d_l", "res_d_w", "res_maxt",
            "res_active", "alt_dims", "events")]
        + [(f, ctypes.c_int32) for f in (
            "use_drt", "use_drt_subsampling", "use_drt_mis",
            "trans_grad_samples")])


class DrtParams(ctypes.Structure):
    """Mirror of ``uivr::DrtParams`` in ``csrc/volpath_drt.cuh``."""
    _fields_ = (
        [("P", PrimalParams)]
        + [(f, ctypes.c_void_p) for f in (
            "res_o", "res_d_l", "res_d_w", "res_maxt", "res_depth",
            "res_active", "adjoint", "t_sel", "wsum", "found", "trips_a", "p",
            "active", "sel_sig", "sel_alb", "nee", "trips_b", "ps_active",
            "ps_depth", "ps_d_l", "ps_d_w", "ps_maxt", "ps_last_pdf", "rec_L",
            "g_sigma", "g_albedo", "counts")]
        + [("drt_seed", ctypes.c_uint32)])


class NerfParams(ctypes.Structure):
    """Mirror of ``uivr::NerfParams`` in ``csrc/nerf.cuh``."""
    _fields_ = (
        [("P", PrimalParams)]
        + [(f, ctypes.c_void_p) for f in ("valid", "L_in", "dL", "g_grid")]
        + [(f, ctypes.c_int32) for f in (
            "steps", "jitter", "relu", "emission_scaled", "hide_emitters")])


# launcher name -> extra argument types after the params pointer (before
# the stream); the persistent launchers take the work counter and the
# utilization counters
_PERSISTENT = [ctypes.c_void_p, ctypes.c_void_p]
_LAUNCHERS = {
    "primal": {"volpath_primal_launch": [ctypes.c_int] + _PERSISTENT,
               "volpath_primal_direct_launch": [ctypes.c_int],
               "volpath_primal_k_launch": [ctypes.c_int] + _PERSISTENT,
               "volpath_primal_k_direct_launch": [ctypes.c_int], "tea_launch": None},
    "adjoint": {"volpath_adjoint_launch": _PERSISTENT,
                "volpath_adjoint_direct_launch": []},
    "drt": {"volpath_drt_launch": [ctypes.c_int, ctypes.c_int] + _PERSISTENT},
    "nerf": {"nerf_primal_launch": [], "nerf_adjoint_launch": []},
}
_SIZES = {"primal": ("primal_params_size", PrimalParams),
          "adjoint": ("adj_params_size", AdjParams),
          "drt": ("drt_params_size", DrtParams),
          "nerf": ("nerf_params_size", NerfParams)}


def bind(lib, key: str):
    """Set the argument types of library ``key``'s launchers on the ctypes
    library ``lib`` (the package's build of it, or a variant) and check its
    parameter block's layout; returns ``lib``."""
    for fn, extra in _LAUNCHERS[key].items():
        f = getattr(lib, fn)
        if extra is None:     # tea_launch
            f.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        else:
            f.argtypes = [ctypes.c_void_p, *extra, ctypes.c_void_p]
        f.restype = ctypes.c_int
    size_fn, struct = _SIZES[key]
    getattr(lib, size_fn).restype = ctypes.c_int
    if getattr(lib, size_fn)() != ctypes.sizeof(struct):
        raise RuntimeError(f"{struct.__name__} layout differs between "
                           "the CUDA source and its ctypes mirror")
    if key in ("primal", "adjoint"):
        lib.min_blocks.restype = ctypes.c_int
    if key == "primal":
        lib.uivr_error_string.argtypes = [ctypes.c_int]
        lib.uivr_error_string.restype = ctypes.c_char_p
        lib.persistent_max_warps.restype = ctypes.c_int
    return lib


def _load(name: str = "primal"):
    """The ctypes library ``name``; the first call builds all of them."""
    if name not in _libs:
        paths = build()
        for key, path in paths.items():
            if key not in _libs:
                _libs[key] = bind(ctypes.CDLL(str(path)), key)
    return _libs[name]


def _launch(key: str, launcher, *args, classified: bool = False,
            deferred: bool = False, k_candidate: bool = False) -> None:
    """Call the ``extern "C"`` launcher of kernel ``key`` (it returns a CUDA
    error code), raise on failure and count the launch (also as a K6 launch
    when ``classified``, as a K3b launch when ``deferred``, as a K7 launch
    when ``k_candidate``).  With :data:`TIMINGS` a list, also record CUDA
    events around it."""
    ev = None
    if TIMINGS is not None:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    rc = launcher(*args)
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: "
                           f"{_load('primal').uivr_error_string(rc).decode()} ({rc})")
    LAUNCHES[key] += 1
    if classified:
        LAUNCHES["subcell_classification"] += 1
    if deferred:
        LAUNCHES["deferred_nee"] += 1
    if k_candidate:
        LAUNCHES["k_candidate"] += 1
    if ev is not None:
        ev[1].record()
        TIMINGS.append((key, ev[0], ev[1]))


def _need(t: torch.Tensor, name: str, device, dtype=torch.float32,
          shape=None) -> int:
    """Validate a tensor the kernel reads or writes; returns its address."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return t.data_ptr()


def emitter_params(p: PrimalParams, em, dev, deferred: bool = True) -> None:
    """Fill the emitter's fields of ``p``, checking its tensors; with
    ``deferred`` an envmap's coarse proxy (K3b) goes in when it has one.
    The values come from the emitter's host copies: nothing is read back
    from the device."""
    if isinstance(em, ConstantEmitter):
        if em.host is None:
            raise ValueError("ConstantEmitter without host copies: make it with "
                             "scene.emitters.constant_emitter")
        p.emitter = 0
        p.radiance[:], p.const_weight[:] = em.host
    elif isinstance(em, EnvmapEmitter):
        p.emitter = 1
        eH, eW = em.data.shape[:2]
        p.env_H, p.env_W = eH, eW
        p.env_data = _need(em.data, "envmap data", dev, shape=(eH, eW, 3))
        p.env_alias = _need(em.alias_tab, "alias table", dev, shape=(eH * eW, 4))
        p.env_row_pmf = _need(em.row_pmf, "row pmf", dev, shape=(eH,))
        p.env_cond_pmf = _need(em.cond_pmf, "conditional pmf", dev, shape=(eH, eW))
        if em.to_world_host is None:
            raise ValueError("EnvmapEmitter without its host to_world: make it with "
                             "scene.emitters.make_envmap")
        p.env_to_world[:] = em.to_world_host
        if deferred and em.nee is not None:
            c = em.nee
            cH, cW = c.data.shape[:2]
            p.nee_H, p.nee_W = cH, cW
            p.nee_alias = _need(c.alias_tab, "proxy alias table", dev, shape=(cH * cW, 4))
            p.nee_row_pmf = _need(c.row_pmf, "proxy row pmf", dev, shape=(cH,))
            p.nee_cond_pmf = _need(c.cond_pmf, "proxy conditional pmf", dev, shape=(cH, cW))
    else:
        raise TypeError(f"unsupported emitter {type(em).__name__}")


def primal_params(cfg: VolpathConfig, scene: Scene, o, d, seed: int, L=None,
                  escaped=None, dims=None, steps=None, path_state=None,
                  n: int = None, device=None, cls_counts=None,
                  deferred: bool = True) -> PrimalParams:
    """Fill the kernels' common parameter block, checking every tensor it
    names.  The rays are ``o``, ``d`` (n, 3) or ``path_state``; a block
    with neither (the delayed DRT term's) gives ``n`` and ``device``.  The
    medium's subcell table (K6) goes in when it has one, and with
    ``deferred`` the envmap's coarse proxy (K3b) when it has one: the
    walking kernels then sample NEE from the proxy (the reference's
    ``_em_dims``: ``(fh, fw)`` are the map's own dims).  Nothing is read
    back from the device: the transforms and the constant emitter's values
    come from the host copies the scene keeps (``Medium.w2l``,
    ``EnvmapEmitter.to_world_host``, ``ConstantEmitter.host``), so a
    launch never waits for the card."""
    if path_state is not None:
        n, device = path_state.o_l.shape[0], path_state.o_l.device
    elif o is not None:
        n, device = o.shape[0], o.device
    dev = device
    m = scene.medium
    p = PrimalParams()

    def opt(t, name, dtype=torch.float32, shape=None):
        return None if t is None else _need(t, name, dev, dtype, shape)

    p.o = opt(o, "o", shape=(n, 3))
    p.d = opt(d, "d", shape=(n, 3))
    p.L = opt(L, "L", shape=(n, 3))
    p.escaped = opt(escaped, "escaped", torch.bool, (n,))
    p.dims = opt(dims, "dims", torch.int32, (n,))
    p.steps = opt(steps, "steps", torch.int32, (n,))
    p.cls_counts = opt(cls_counts, "cls_counts", torch.int32, (n, len(CLS_COUNTERS)))
    if path_state is not None:
        ps = path_state
        p.ps_active = _need(ps.active, "path_state.active", dev, torch.bool, (n,))
        p.ps_depth = _need(ps.depth, "path_state.depth", dev, torch.int32, (n,))
        p.ps_o = _need(ps.o_l, "path_state.o_l", dev, shape=(n, 3))
        p.ps_d_l = _need(ps.d_l, "path_state.d_l", dev, shape=(n, 3))
        p.ps_d_w = _need(ps.d_w, "path_state.d_w", dev, shape=(n, 3))
        p.ps_maxt = _need(ps.maxt, "path_state.maxt", dev, shape=(n,))
        p.ps_last_pdf = _need(ps.last_pdf, "path_state.last_pdf", dev, shape=(n,))
    if m.grid.ndim != 4 or m.grid.shape[-1] != 4:
        raise ValueError(f"medium grid must be (D, H, W, 4), got {tuple(m.grid.shape)}")
    p.grid = _need(m.grid, "medium grid", dev)
    p.D, p.H, p.W = m.grid.shape[:3]
    if m.majorant_grid.ndim != 3:
        raise ValueError("majorant grid must be (Dc, Hc, Wc)")
    p.majorant = _need(m.majorant_grid, "majorant grid", dev)
    p.Dc, p.Hc, p.Wc = m.majorant_grid.shape
    if m.sub is not None:
        if m.sub.ndim != 3:
            raise ValueError("subcell table must be (Ds, Hs, Ws)")
        p.sub = _need(m.sub, "subcell table", dev)
        p.Ds, p.Hs, p.Ws = m.sub.shape
    p.n = n
    emitter_params(p, scene.emitter, dev, deferred)
    p.max_depth, p.rr_depth, p.max_steps = cfg.max_depth, cfg.rr_depth, cfg.max_steps
    p.draw_rounds = _DRAW_ROUNDS
    p.use_nee, p.hide_emitters = int(cfg.use_nee), int(cfg.hide_emitters)
    p.seed = int(seed) & _M32
    p.scale, p.phase_g = m.scale, m.phase_g
    p.shadow_rr = cfg.shadow_rr
    p.inv_shadow_rr = 1.0 / cfg.shadow_rr if cfg.shadow_rr > 0 else 0.0
    p.w2l[:] = m.w2l
    return p


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _u32(t: torch.Tensor) -> torch.Tensor:
    """uint32 counters held in int32 -> int64 values in [0, 2**32)."""
    return t.to(torch.int64) & _M32


def persistent_args(dev, util: bool):
    """The scratch of a persistent launch: ``(counter, util)``.
    ``counter`` is the work counter (the launcher zeroes it on the stream);
    ``util`` the per-warp counters of :data:`UTIL_COUNTERS` (warps, 2)
    int64 where asked for, else None."""
    counter = torch.empty((1,), dtype=torch.int64, device=dev)
    if not util:
        return counter, None
    return counter, torch.zeros((_load("primal").persistent_max_warps(), len(UTIL_COUNTERS)),
                                dtype=torch.int64, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def k7_build(k_cand: int) -> int:
    """The instantiation of ``volpath_primal_k_kernel`` that takes
    ``k_cand`` (1 for the K=1 kernel); raises ValueError beyond the
    largest."""
    if k_cand == 1:
        return 1
    kmax = next((k for k in K7_BUILDS if k >= k_cand), None)
    if k_cand < 1 or kmax is None:
        raise ValueError(f"k_cand={k_cand}: the kernels take 1 to {K7_BUILDS[-1]}")
    return kmax


def sample_primal_kernel(cfg: VolpathConfig, scene: Scene, o, d, seed,
                         return_stats: bool = False,
                         path_state: PathState = None, k_cand: int = 1,
                         direct: bool = False):
    """Primal estimate of world rays ``o``, ``d`` (n, 3) float32, or of the
    paths resumed from ``path_state`` (then ``o``, ``d`` are unused).
    ``k_cand > 1``: K-candidate batching (K7; world rays only, K6 off, as
    in the reference).

    Returns ``(L (n,3), escaped (n,))`` and, with ``return_stats``, a dict of
    per-lane ``dim`` (draws consumed) and ``steps``, like the plain twin;
    the kernel adds ``cls``, K6's per-lane counters (n, 5) int32 in the
    order of :data:`CLS_COUNTERS`, with ``k_cand > 1`` the K7 counters of
    :data:`K7_COUNTERS`, each (n,) int32, and ``util``, the persistent
    kernel's per-warp counters of :data:`UTIL_COUNTERS`.
    On ``cpu`` tensors this is the plain twin (deferred mode); on ``cuda``
    tensors it launches the persistent ``volpath_primal_kernel`` (from the
    path state with one), with ``k_cand > 1`` the persistent
    ``volpath_primal_k_kernel``, and with ``direct`` the one-ray-per-thread
    kernel that the persistent one replaced (for comparison; no
    ``util``)."""
    kmax = k7_build(k_cand)
    if k_cand > 1 and path_state is not None:
        raise ValueError("K-candidate batching takes world rays, not a path state")
    ref = o if path_state is None else path_state.o_l
    if not ref.is_cuda:
        return volpath_flat.sample_primal(cfg, scene, o, d, seed, return_stats,
                                          path_state=path_state, deferred=True,
                                          k_cand=k_cand)
    n, dev = ref.shape[0], ref.device
    L = torch.empty((n, 3), dtype=torch.float32, device=dev)
    escaped = torch.empty((n,), dtype=torch.bool, device=dev)
    dims = steps = cls = kc = util = None
    if return_stats:
        dims = torch.empty((n,), dtype=torch.int32, device=dev)
        steps = torch.empty((n,), dtype=torch.int32, device=dev)
        cls = torch.empty((n, len(CLS_COUNTERS)), dtype=torch.int32, device=dev)
        if k_cand > 1:
            kc = torch.empty((n, len(K7_COUNTERS)), dtype=torch.int32, device=dev)
    params = primal_params(cfg, scene, o, d, seed, L, escaped, dims, steps,
                           path_state=path_state, cls_counts=cls)
    lib = _load("primal")
    if k_cand > 1:
        # K6 is off with K7, as the reference's _make_step decides
        params.sub, params.Ds, params.Hs, params.Ws = None, 0, 0, 0
        params.k_cand, params.cross_steps = k_cand, volpath_flat.CROSS_STEPS
        params.kc_counts = _ptr(kc)
    flags = dict(classified=params.Ds > 0, deferred=params.nee_H > 0,
                 k_candidate=k_cand > 1)
    key = "volpath_primal_state" if path_state is not None else "volpath_primal"
    from_state = int(path_state is not None)
    if direct:
        if k_cand > 1:
            _launch("volpath_primal_k_direct", lib.volpath_primal_k_direct_launch,
                    ctypes.byref(params), kmax, _stream(dev), **flags)
        else:
            _launch(key + "_direct", lib.volpath_primal_direct_launch, ctypes.byref(params),
                    from_state, _stream(dev), **flags)
    else:
        counter, util = persistent_args(dev, return_stats)
        if k_cand > 1:
            _launch(key, lib.volpath_primal_k_launch, ctypes.byref(params), kmax,
                    counter.data_ptr(), _ptr(util), _stream(dev), **flags)
        else:
            _launch(key, lib.volpath_primal_launch, ctypes.byref(params), from_state,
                    counter.data_ptr(), _ptr(util), _stream(dev), **flags)
    if return_stats:
        stats = {"dim": _u32(dims), "steps": steps, "cls": cls}
        if kc is not None:
            stats.update({k: kc[:, i] for i, k in enumerate(K7_COUNTERS)})
        if util is not None:
            stats["util"] = util
        return L, escaped, stats
    return L, escaped


def _empty_reservoir(n: int, dev) -> _Reservoir:
    def v3():
        return torch.empty((n, 3), dtype=torch.float32, device=dev)
    return _Reservoir(wsum=v3(), cur_w=v3(),
                      depth=torch.empty((n,), dtype=torch.int32, device=dev),
                      o_l=v3(), d_l=v3(), d_w=v3(),
                      maxt=torch.empty((n,), dtype=torch.float32, device=dev),
                      active=torch.empty((n,), dtype=torch.bool, device=dev))


def _grad_pointers(acc: GradAccum, m, dev):
    shp = tuple(m.params.sigma_t.shape[:3])
    return (_need(acc.sigma, "sigma gradient", dev, shape=shp + (1,)),
            _need(acc.albedo, "albedo gradient", dev, shape=shp + (3,)))


def adjoint_params(cfg: VolpathConfig, scene: Scene, o, d, seed, dL, state_in,
                   acc: GradAccum):
    """The adjoint kernel's parameter block and the tensors it writes:
    ``(params, res, stats)``; ``stats`` holds per-lane int32 counters:
    ``dim`` (primary draws), ``alt_dim`` (alt draws), ``steps``,
    ``events`` (n, 2) (real collisions, replay collisions that scatter) and
    ``cls`` (n, 5) (K6's counters, :data:`CLS_COUNTERS`).  No value is
    read back from the device (the emitter's and the medium's constants
    come from their host copies), so a launch does not wait for the
    card."""
    m = scene.medium
    n, dev = o.shape[0], o.device
    res = _empty_reservoir(n, dev)
    stats = {k: torch.empty((n,), dtype=torch.int32, device=dev)
             for k in ("dim", "alt_dim", "steps")}
    stats["events"] = torch.empty((n, 2), dtype=torch.int32, device=dev)
    stats["cls"] = torch.empty((n, len(CLS_COUNTERS)), dtype=torch.int32, device=dev)
    a = AdjParams()
    a.P = primal_params(cfg, scene, o, d, seed, dims=stats["dim"],
                        steps=stats["steps"], cls_counts=stats["cls"])
    a.L_in = _need(state_in, "state_in", dev, shape=(n, 3))
    a.dL = _need(dL, "dL", dev, shape=(n, 3))
    a.g_sigma, a.g_albedo = _grad_pointers(acc, m, dev)
    a.res_wsum, a.res_cur_w = res.wsum.data_ptr(), res.cur_w.data_ptr()
    a.res_depth, a.res_o = res.depth.data_ptr(), res.o_l.data_ptr()
    a.res_d_l, a.res_d_w = res.d_l.data_ptr(), res.d_w.data_ptr()
    a.res_maxt, a.res_active = res.maxt.data_ptr(), res.active.data_ptr()
    a.alt_dims = stats["alt_dim"].data_ptr()
    a.events = stats["events"].data_ptr()
    a.use_drt, a.use_drt_subsampling = int(cfg.use_drt), int(cfg.use_drt_subsampling)
    a.use_drt_mis, a.trans_grad_samples = int(cfg.use_drt_mis), int(cfg.trans_grad_samples)
    return a, res, stats


def adjoint_walk_kernel(cfg: VolpathConfig, scene: Scene, o, d, seed, dL,
                        state_in, k_cand: int = 1, direct: bool = False,
                        return_util: bool = False):
    """The adjoint's path-replay walk (``volpath_flat.adjoint_walk``):
    returns ``(acc, res, stats)``, the kernel's stats with ``events`` too
    (see :func:`adjoint_params`) and, with ``return_util``, ``util``, the
    persistent kernel's per-warp counters (:data:`UTIL_COUNTERS`).  On
    ``cuda`` tensors it launches the persistent ``volpath_adjoint_kernel``,
    which adds into a zero accumulator with atomics, and with ``direct`` the
    one-ray-per-thread kernel that it replaced (for comparison; no
    ``util``).  It replays K=1 paths only: ``k_cand`` other than 1 raises,
    as the reference's ``_make_call`` asserts."""
    if k_cand != 1:
        raise ValueError("K-candidate batching is primal only: the adjoint replays "
                         "k_cand=1 paths")
    if not o.is_cuda:
        return volpath_flat.adjoint_walk(cfg, scene, o, d, seed, dL, state_in,
                                         deferred=True)
    acc = init_accum(scene.medium, need_emission=False)
    a, res, stats = adjoint_params(cfg, scene, o, d, seed, dL, state_in, acc)
    lib = _load("adjoint")
    flags = dict(classified=a.P.Ds > 0, deferred=a.P.nee_H > 0)
    if direct:
        _launch("volpath_adjoint_direct", lib.volpath_adjoint_direct_launch, ctypes.byref(a),
                _stream(o.device), **flags)
    else:
        counter, util = persistent_args(o.device, return_util)
        _launch("volpath_adjoint", lib.volpath_adjoint_launch, ctypes.byref(a),
                counter.data_ptr(), _ptr(util), _stream(o.device), **flags)
        if util is not None:
            stats["util"] = util
    return acc, res, {k: _u32(v) if k in ("dim", "alt_dim") else v
                      for k, v in stats.items()}


def drt_params(cfg: VolpathConfig, scene: Scene, seed, res: _Reservoir,
               adjoint: torch.Tensor, acc: GradAccum):
    """The DRT kernels' parameter block and what they write:
    ``(params, out, path_state, counts)``; ``params.rec_L`` is set once
    the recursive primal has run."""
    m = scene.medium
    n, dev = res.o_l.shape[0], res.o_l.device

    def f(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {"t_sel": f(n), "wsum": f(n), "found": f(n, dtype=torch.bool),
           "trips_a": f(n, dtype=torch.int32), "p": f(n, 3),
           "active": f(n, dtype=torch.bool), "sel_sig": f(n), "sel_alb": f(n, 3),
           "nee": f(n, 3), "trips_b": f(n, dtype=torch.int32)}
    ps = PathState(active=f(n, dtype=torch.bool), depth=f(n, dtype=torch.int32),
                   o_l=out["p"], d_l=f(n, 3), d_w=f(n, 3), maxt=f(n),
                   last_pdf=f(n))
    counts = torch.zeros((2,), dtype=torch.int32, device=dev)
    D = DrtParams()
    # the term's own NEE samples the full-resolution map, as the
    # reference's volpathsimple._nee_primal does; its resumed primal takes K3b
    D.P = primal_params(cfg, scene, None, None, 0, n=n, device=dev, deferred=False)
    D.res_o = _need(res.o_l, "reservoir o_l", dev, shape=(n, 3))
    D.res_d_l = _need(res.d_l, "reservoir d_l", dev, shape=(n, 3))
    D.res_d_w = _need(res.d_w, "reservoir d_w", dev, shape=(n, 3))
    D.res_maxt = _need(res.maxt, "reservoir maxt", dev, shape=(n,))
    D.res_depth = _need(res.depth, "reservoir depth", dev, torch.int32, (n,))
    D.res_active = _need(res.active, "reservoir active", dev, torch.bool, (n,))
    D.adjoint = _need(adjoint, "adjoint", dev, shape=(n, 3))
    for k, v in out.items():
        setattr(D, k, v.data_ptr())
    D.ps_active, D.ps_depth = ps.active.data_ptr(), ps.depth.data_ptr()
    D.ps_d_l, D.ps_d_w = ps.d_l.data_ptr(), ps.d_w.data_ptr()
    D.ps_maxt, D.ps_last_pdf = ps.maxt.data_ptr(), ps.last_pdf.data_ptr()
    D.g_sigma, D.g_albedo = _grad_pointers(acc, m, dev)
    D.counts = counts.data_ptr()
    D.drt_seed = int(sample_tea_32(int(seed), 0x5151)[0])
    return D, out, ps, counts


def drt_backward_kernel(cfg: VolpathConfig, scene: Scene, seed, res: _Reservoir,
                        adjoint: torch.Tensor, acc: GradAccum,
                        return_stats: bool = False, direct: bool = False):
    """The delayed DRT term (``volpath_flat._drt_backward_flat``), adding
    into ``acc``.  On ``cuda`` tensors it runs the ``volpath_drt`` kernels
    (the walk and the NEE persistent, the phase sampling) and the
    recursive primal from the path state (``volpath_primal_state``), then
    the scatter from the sigma and albedo the walk kept; the wavefront
    counter's maxima stay on the device.  ``direct`` launches the
    one-thread-per-vertex walk and NEE kernels that the persistent ones
    replaced instead (for comparison).  ``return_stats`` returns the twin's
    stats too (``k_a`` and ``k_b`` read back from the device), with the walk's
    per-lane outputs (``trips_a``, ``p``, ``sel_sig``, ``sel_alb``), the
    NEE's ``trips_b``, the recursive primal's stats and, from the
    persistent walk, ``walk_util`` (its per-warp counters,
    :data:`UTIL_COUNTERS`)."""
    if not res.o_l.is_cuda:
        return volpath_flat._drt_backward_flat(cfg, scene, seed, res, adjoint, acc,
                                               return_stats, deferred=True)
    dev = res.o_l.device
    D, out, ps, counts = drt_params(cfg, scene, seed, res, adjoint, acc)
    lib = _load("drt")
    mis = int(cfg.use_drt_mis)

    def launch(which, key, counter=None, util=None):
        _launch(key, lib.volpath_drt_launch, ctypes.byref(D), which, mis, _ptr(counter),
                _ptr(util), _stream(dev))

    walk_util = None
    if direct:
        launch(5, "volpath_drt_walk_direct")
    else:
        counter, walk_util = persistent_args(dev, return_stats)
        launch(0, "volpath_drt_walk", counter, walk_util)
    if cfg.use_nee:
        if direct:
            launch(4, "volpath_drt_nee_direct")
        else:
            launch(1, "volpath_drt_nee", persistent_args(dev, False)[0])
    launch(2, "volpath_drt_phase")
    rec_seed, _ = sample_tea_32(int(seed), 0x7177)
    rec = sample_primal_kernel(cfg, scene, None, None, rec_seed, return_stats,
                               path_state=ps)
    D.rec_L = _need(rec[0], "recursive radiance", dev, shape=(res.o_l.shape[0], 3))
    launch(3, "volpath_drt_scatter")
    if not return_stats:
        return acc
    k_a, k_b = counts.tolist()
    stats = {k: out[k] for k in ("t_sel", "wsum", "found", "nee", "trips_a", "trips_b", "p",
                                 "sel_sig", "sel_alb")}
    stats.update({"k_a": k_a, "k_b": k_b, "path_state": ps, "rec_L": rec[0],
                  "rec_stats": rec[2]})
    if walk_util is not None:
        stats["walk_util"] = walk_util
    return acc, stats


def sample_adjoint_kernel(cfg: VolpathConfig, scene: Scene, o, d, seed, dL,
                          state_in):
    """Path-replay adjoint with the delayed DRT term
    (``volpath_flat.sample_adjoint``): MediumParams gradients (zero
    emission).  On ``cuda`` tensors it runs ``volpath_adjoint_kernel`` and
    the DRT kernels."""
    if not o.is_cuda:
        return volpath_flat.sample_adjoint(cfg, scene, o, d, seed, dL, state_in,
                                           deferred=True)
    acc, res, _ = adjoint_walk_kernel(cfg, scene, o, d, seed, dL, state_in)
    if cfg.use_drt and cfg.use_drt_subsampling:
        acc = drt_backward_kernel(cfg, scene, seed, res, _reservoir_get(res) * dL, acc)
    return finalize_accum(acc, scene.medium)


def tea_i32(v0, v1, rounds: int = 6):
    """TEA over uint32 values held in integer tensors (or Python ints),
    broadcasting; returns int64 tensors in [0, 2**32).  On ``cuda`` this
    launches ``tea_kernel``; its plain version is ``core/rng.tea_plain``."""
    ref = v0 if isinstance(v0, torch.Tensor) else v1
    v0 = torch.as_tensor(v0, dtype=torch.int64, device=ref.device)
    v1 = torch.as_tensor(v1, dtype=torch.int64, device=ref.device)
    if not ref.is_cuda:
        return tea_plain(v0, v1, rounds)
    v0, v1 = torch.broadcast_tensors(v0, v1)
    a = v0.to(torch.int32).contiguous()   # wraps: the same 32 bits
    b = v1.to(torch.int32).contiguous()
    o0, o1 = torch.empty_like(a), torch.empty_like(b)
    _launch("tea", _load("primal").tea_launch, a.data_ptr(), b.data_ptr(), o0.data_ptr(),
            o1.data_ptr(), a.numel(), int(rounds), _stream(a.device))
    return o0.to(torch.int64) & _M32, o1.to(torch.int64) & _M32
