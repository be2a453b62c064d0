"""The hand-written Hopper kernels of the NeRF bootstrap stage: bind, wrap.

The reference marches NeRF rays in XLA (``uivr_tpu/integrators/nerf.py``:
``sample_primal`` :61, ``sample_adjoint`` :95); the port runs each pass as
one launcher call, ``nerf_primal_launch`` and ``nerf_adjoint_launch``
(``csrc/nerf.cu`` over the march of ``csrc/nerf.cuh``): a kernel that lists
the rays inside the medium's box, then one that marches them, one listed
ray a thread (``nerf_primal_kernel``, ``nerf_adjoint_kernel``).  They are
built with the path tracer's libraries (library ``"nerf"`` of
``volpath_step.LIBS``) and counted in ``volpath_step.LAUNCHES``; with
``direct=True`` a wrapper launches instead the one-ray-per-thread kernel
over every ray that they replaced (``nerf_*_direct``, for comparison).
Both read one interleaved (D, H, W, 4) grid [sigma, emission], made once
per call by :func:`nerf_grid`; the adjoint adds into a zeroed grid of the
same layout, which it splits into the sigma and emission gradients.  The
march kernels index that grid in int32 offsets, or in int64 ones on grids
of 2^29 voxels and more (:func:`index64_for`: the wrappers' ``index64``
keyword picks by size when None and forces int64 when True); their
launches count as ``nerf_primal_i64`` and ``nerf_adjoint_i64`` then.  The
list of rays is int32: at most 2^31 - 1 rays a call.

On ``cpu`` tensors a wrapper runs the plain version
(``integrators/nerf.py``); on ``cuda`` tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.rng import _M32, make_sampler
from ..integrators import nerf
from ..integrators.nerf import NerfConfig
from ..scene.medium import MediumParams
from ..scene.scene import Scene
from . import volpath_step as vs

_ACTIVATIONS = {"identity": 0, "relu": 1}


def nerf_grid(m) -> torch.Tensor:
    """The (D, H, W, 4) [sigma (unscaled), emission rgb] grid the kernels
    read, one float4 a corner."""
    return torch.cat([m.params.sigma_t, m.params.emission], dim=-1).to(torch.float32).contiguous()


def index64_for(shape, index64: Optional[bool] = None) -> bool:
    """Whether the march kernels index a grid of ``shape`` (D, H, W, ...)
    in int64 offsets: None picks them where its floats need more than 31
    bits (D*H*W*4 >= 2^31, as ``nerf_needs_index64`` in ``nerf.cuh``),
    True forces them; False on such a grid raises ValueError."""
    D, H, W = (int(x) for x in shape[:3])
    needs = D * H * W * 4 >= 2 ** 31
    if index64 is False and needs:
        raise ValueError(f"NeRF grid of {D}x{H}x{W} voxels: its offsets need int64 indices "
                         f"(index64=False)")
    return needs if index64 is None else bool(index64)


def nerf_params(cfg: NerfConfig, scene: Scene, o, d, seed, grid,
                index64: Optional[bool] = None):
    """The kernels' parameter block for rays ``o``, ``d`` (n, 3) on the
    interleaved ``grid``, checking every tensor it names, with the
    kernels' scratch (the list of rays inside the box and its length):
    ``(params, scratch tensors)``; the caller sets the outputs.
    ``index64`` as in :func:`index64_for`.  Nothing is read back from the
    device."""
    if cfg.activation not in _ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {cfg.activation}")
    m = scene.medium
    n, dev = o.shape[0], o.device
    if n >= 2 ** 31:
        # the list of rays inside the box is int32 (nerf.cu, nerf_compact_kernel)
        raise ValueError(f"{n} NeRF rays: the kernels take at most 2^31 - 1 rays a call")
    wide = index64_for(m.params.sigma_t.shape, index64)
    P = vs.PrimalParams()
    P.o = vs._need(o, "o", dev, shape=(n, 3))
    P.d = vs._need(d, "d", dev, shape=(n, 3))
    P.grid = vs._need(grid, "nerf grid", dev, shape=tuple(m.params.sigma_t.shape[:3]) + (4,))
    P.D, P.H, P.W = grid.shape[:3]
    P.n = n
    P.seed = int(seed) & _M32
    P.scale = m.scale
    P.w2l[:] = m.w2l
    vs.emitter_params(P, scene.emitter, dev, deferred=False)
    p = vs.NerfParams()
    p.P = P
    p.steps, p.jitter = cfg.queries_per_ray, int(cfg.jitter)
    p.relu = _ACTIVATIONS[cfg.activation]
    p.emission_scaled, p.hide_emitters = int(cfg.emission_scaled), int(cfg.hide_emitters)
    p.index64 = int(wide)
    order = torch.empty((n,), dtype=torch.int32, device=dev)
    listed = torch.empty((1,), dtype=torch.int64, device=dev)
    p.order, p.listed = order.data_ptr(), listed.data_ptr()
    return p, (order, listed)


def _launch(key: str, p, dev, direct: bool) -> None:
    """Launch ``key`` (``nerf_primal`` or ``nerf_adjoint``), or with
    ``direct`` its one-ray-per-thread twin, on the current stream; a march
    in int64 offsets counts as ``key + "_i64"``."""
    name = f"{key}_direct" if direct else key
    count = f"{key}_i64" if p.index64 and not direct else name
    vs._launch(count, getattr(vs._load("nerf"), f"{name}_launch"), ctypes.byref(p),
               vs._stream(dev))


def sample_primal_kernel(cfg: NerfConfig, scene: Scene, o, d, seed, direct: bool = False,
                         index64: Optional[bool] = None):
    """NeRF radiance of world rays ``o``, ``d`` (n, 3) float32 with the
    jitter of sampler ``seed``: ``(L (n, 3), valid (n,))``.  On ``cuda``
    tensors it launches ``nerf_primal_kernel`` (``direct``: the
    one-ray-per-thread ``nerf_primal_direct_kernel``), in int64 offsets
    where :func:`index64_for` says so."""
    n, dev = o.shape[0], o.device
    if not o.is_cuda:
        L, valid, _ = nerf.sample_primal(cfg, scene, o, d,
                                         make_sampler(seed, n_lanes=n, device=dev))
        return L, valid
    L = torch.empty((n, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    p, _ = nerf_params(cfg, scene, o, d, seed, nerf_grid(scene.medium), index64)
    p.P.L, p.valid = L.data_ptr(), valid.data_ptr()
    _launch("nerf_primal", p, dev, direct)
    return L, valid


def sample_adjoint_kernel(cfg: NerfConfig, scene: Scene, o, d, seed, dL,
                          state_in, direct: bool = False,
                          index64: Optional[bool] = None) -> MediumParams:
    """Path-replay adjoint of the same rays and ``seed`` given ``dL`` and
    the primal radiance ``state_in`` (n, 3): the grids' gradients (zero
    albedo).  On ``cuda`` tensors it launches ``nerf_adjoint_kernel``
    (``direct``: ``nerf_adjoint_direct_kernel``), which adds into a zero
    grid with atomics, in int64 offsets where :func:`index64_for` says
    so."""
    n, dev = o.shape[0], o.device
    m = scene.medium
    if not o.is_cuda:
        g, _ = nerf.sample_adjoint(cfg, scene, o, d, make_sampler(seed, n_lanes=n, device=dev),
                                   dL, state_in)
        return g
    grid = nerf_grid(m)
    g4 = torch.zeros_like(grid)
    p, _ = nerf_params(cfg, scene, o, d, seed, grid, index64)
    p.L_in = vs._need(state_in, "state_in", dev, shape=(n, 3))
    p.dL = vs._need(dL, "dL", dev, shape=(n, 3))
    p.g_grid = g4.data_ptr()
    _launch("nerf_adjoint", p, dev, direct)
    return MediumParams(sigma_t=g4[..., :1].contiguous(), albedo=torch.zeros_like(m.params.albedo),
                        emission=g4[..., 1:].contiguous())
