"""The hand-written Hopper kernels of the primal render: build, bind, wrap.

Port of ``uivr_tpu/ops/volpath_step.py`` (its ``adjoint=False``, ``k_cand=1``
step kernel and the host loops that run it).  The CUDA sources live in
``csrc/``:

- ``rng.cuh``           TEA hash and unit float (K1)
- ``volpath_lane.cuh``  one lane's MAIN/SHADOW/DONE tracking state machine
                        with trilinear sigma+albedo reads and emitter NEE
                        (K2, K3), run to completion per ray (K5's keying)
- ``volpath_primal.cu`` the ``__global__`` kernels and ``extern "C"``
                        launchers

They are compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/uivr_tpu_torch/`` (keyed by a hash of the sources and flags) on
first use, and loaded with ``ctypes``.  Each wrapper launches on PyTorch's
current stream and counts its launches in :data:`LAUNCHES`.  On a ``cpu``
tensor a wrapper runs the kernel's plain version instead
(``core/rng.tea_plain``, ``integrators/volpath_flat.sample_primal``); on a
``cuda`` tensor it launches the kernel or raises.
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

from ..core.rng import _DRAW_ROUNDS, _M32, tea_plain
from ..integrators import volpath_flat
from ..integrators.volpathsimple import VolpathConfig
from ..scene.emitters import ConstantEmitter, EnvmapEmitter
from ..scene.scene import Scene

# kernel launches, by kernel, since the process started (or a caller reset)
LAUNCHES = {"volpath_primal": 0, "tea": 0}

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("rng.cuh", "volpath_lane.cuh", "volpath_primal.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# what the last build did: seconds (None when the library was cached) and
# nvcc's output, which holds ptxas' register and spill report
BUILD = {"seconds": None, "log": "", "path": None}

_lib = None


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


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    out_dir = build_dir()
    lib = out_dir / f"libuivr_primal-{h.hexdigest()[:16]}.so"
    BUILD["path"] = lib
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.time()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / "volpath_primal.cu")],
                          capture_output=True, text=True)
    BUILD["seconds"] = time.time() - t0
    BUILD["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD['log']}")
    os.replace(tmp, lib)
    return lib


class PrimalParams(ctypes.Structure):
    """Mirror of ``uivr::PrimalParams`` in ``csrc/volpath_lane.cuh``."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "o", "d", "L", "escaped", "dims", "steps", "grid", "majorant",
            "env_data", "env_alias", "env_row_pmf", "env_cond_pmf")]
        + [("n", ctypes.c_int64)]
        + [(f, ctypes.c_int32) for f in (
            "D", "H", "W", "Dc", "Hc", "Wc", "env_H", "env_W", "emitter",
            "max_depth", "rr_depth", "max_steps", "draw_rounds", "use_nee",
            "hide_emitters")]
        + [("seed", ctypes.c_uint32)]
        + [(f, ctypes.c_float) for f in (
            "scale", "phase_g", "shadow_rr", "inv_shadow_rr")]
        + [("w2l", ctypes.c_float * 12), ("env_to_world", ctypes.c_float * 9),
           ("radiance", ctypes.c_float * 3), ("const_weight", ctypes.c_float * 3)])


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.volpath_primal_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.volpath_primal_launch.restype = ctypes.c_int
        lib.tea_launch.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.tea_launch.restype = ctypes.c_int
        lib.uivr_error_string.argtypes = [ctypes.c_int]
        lib.uivr_error_string.restype = ctypes.c_char_p
        lib.primal_params_size.restype = ctypes.c_int
        if lib.primal_params_size() != ctypes.sizeof(PrimalParams):
            raise RuntimeError("PrimalParams layout differs between the CUDA "
                               "source and its ctypes mirror")
        _lib = lib
    return _lib


def _check_launch(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.uivr_error_string(rc).decode()} ({rc})")


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


def primal_params(cfg: VolpathConfig, scene: Scene, o: torch.Tensor,
                  d: torch.Tensor, seed: int, L: torch.Tensor,
                  escaped: torch.Tensor, dims=None, steps=None) -> PrimalParams:
    """Fill the kernel's parameter block, checking every tensor it names."""
    dev = o.device
    n = o.shape[0]
    m = scene.medium
    p = PrimalParams()
    p.o = _need(o, "o", dev, shape=(n, 3))
    p.d = _need(d, "d", dev, shape=(n, 3))
    p.L = _need(L, "L", dev, shape=(n, 3))
    p.escaped = _need(escaped, "escaped", dev, torch.bool, (n,))
    p.dims = None if dims is None else _need(dims, "dims", dev, torch.int32, (n,))
    p.steps = None if steps is None else _need(steps, "steps", dev, torch.int32, (n,))
    if m.grid.ndim != 4 or m.grid.shape[-1] != 4:
        raise ValueError(f"medium grid must be (D, H, W, 4), got {tuple(m.grid.shape)}")
    p.grid = _need(m.grid, "medium grid", dev)
    p.D, p.H, p.W = m.grid.shape[:3]
    if m.majorant_grid.ndim != 3:
        raise ValueError("majorant grid must be (Dc, Hc, Wc)")
    p.majorant = _need(m.majorant_grid, "majorant grid", dev)
    p.Dc, p.Hc, p.Wc = m.majorant_grid.shape
    p.n = n
    em = scene.emitter
    if isinstance(em, ConstantEmitter):
        p.emitter = 0
        p.radiance[:] = em.radiance.tolist()
        p.const_weight[:] = em.weight.tolist()
    elif isinstance(em, EnvmapEmitter):
        p.emitter = 1
        eH, eW = em.data.shape[:2]
        p.env_H, p.env_W = eH, eW
        p.env_data = _need(em.data, "envmap data", dev, shape=(eH, eW, 3))
        p.env_alias = _need(em.alias_tab, "alias table", dev, shape=(eH * eW, 4))
        p.env_row_pmf = _need(em.row_pmf, "row pmf", dev, shape=(eH,))
        p.env_cond_pmf = _need(em.cond_pmf, "conditional pmf", dev, shape=(eH, eW))
        p.env_to_world[:] = em.to_world.reshape(-1).tolist()
    else:
        raise TypeError(f"unsupported emitter {type(em).__name__}")
    p.max_depth, p.rr_depth, p.max_steps = cfg.max_depth, cfg.rr_depth, cfg.max_steps
    p.draw_rounds = _DRAW_ROUNDS
    p.use_nee, p.hide_emitters = int(cfg.use_nee), int(cfg.hide_emitters)
    p.seed = int(seed) & _M32
    p.scale, p.phase_g = m.scale, m.phase_g
    p.shadow_rr = cfg.shadow_rr
    p.inv_shadow_rr = 1.0 / cfg.shadow_rr if cfg.shadow_rr > 0 else 0.0
    p.w2l[:] = m.world_to_local[:3, :4].reshape(-1).tolist()
    return p


def sample_primal_kernel(cfg: VolpathConfig, scene: Scene, o: torch.Tensor,
                         d: torch.Tensor, seed, return_stats: bool = False):
    """Primal estimate of world rays ``o``, ``d`` (n, 3) float32.

    Returns ``(L (n,3), escaped (n,))`` and, with ``return_stats``, a dict of
    per-lane ``dim`` (draws consumed) and ``steps``, like the plain twin.
    On ``cpu`` tensors this is the plain twin; on ``cuda`` tensors it
    launches ``volpath_primal_kernel``."""
    if not o.is_cuda:
        return volpath_flat.sample_primal(cfg, scene, o, d, seed, return_stats)
    n = o.shape[0]
    L = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    escaped = torch.empty((n,), dtype=torch.bool, device=o.device)
    dims = steps = None
    if return_stats:
        dims = torch.empty((n,), dtype=torch.int32, device=o.device)
        steps = torch.empty((n,), dtype=torch.int32, device=o.device)
    params = primal_params(cfg, scene, o, d, seed, L, escaped, dims, steps)
    lib = _load()
    rc = lib.volpath_primal_launch(ctypes.byref(params),
                                   torch.cuda.current_stream(o.device).cuda_stream)
    _check_launch(lib, rc, "volpath_primal")
    LAUNCHES["volpath_primal"] += 1
    if return_stats:
        return L, escaped, {"dim": dims.to(torch.int64) & _M32, "steps": steps}
    return L, escaped


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
    lib = _load()
    rc = lib.tea_launch(a.data_ptr(), b.data_ptr(), o0.data_ptr(), o1.data_ptr(),
                        a.numel(), int(rounds),
                        torch.cuda.current_stream(a.device).cuda_stream)
    _check_launch(lib, rc, "tea")
    LAUNCHES["tea"] += 1
    return o0.to(torch.int64) & _M32, o1.to(torch.int64) & _M32
