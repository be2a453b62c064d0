"""The hand-written Hopper kernels of the NeRF bootstrap stage: bind, wrap.

The reference marches NeRF rays in XLA (``uivr_tpu/integrators/nerf.py``:
``sample_primal`` :61, ``sample_adjoint`` :95); the port runs each pass as
one CUDA kernel, ``nerf_primal_kernel`` and ``nerf_adjoint_kernel``
(``csrc/nerf.cu`` over the per-ray march of ``csrc/nerf.cuh``), built with
the path tracer's libraries (library ``"nerf"`` of ``volpath_step.LIBS``)
and counted in ``volpath_step.LAUNCHES``.  Both read one interleaved
(D, H, W, 4) grid [sigma, emission], made once per call by
:func:`nerf_grid`; the adjoint adds into a zeroed grid of the same layout,
which it splits into the sigma and emission gradients.

On ``cpu`` tensors a wrapper runs the plain version
(``integrators/nerf.py``); on ``cuda`` tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

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


def nerf_params(cfg: NerfConfig, scene: Scene, o, d, seed, grid) -> vs.NerfParams:
    """The kernels' parameter block for rays ``o``, ``d`` (n, 3) on the
    interleaved ``grid``, checking every tensor it names; the caller sets
    the outputs.  Nothing is read back from the device."""
    if cfg.activation not in _ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {cfg.activation}")
    m = scene.medium
    n, dev = o.shape[0], o.device
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
    return p


def sample_primal_kernel(cfg: NerfConfig, scene: Scene, o, d, seed):
    """NeRF radiance of world rays ``o``, ``d`` (n, 3) float32 with the
    jitter of sampler ``seed``: ``(L (n, 3), valid (n,))``.  On ``cuda``
    tensors it launches ``nerf_primal_kernel``."""
    n, dev = o.shape[0], o.device
    if not o.is_cuda:
        L, valid, _ = nerf.sample_primal(cfg, scene, o, d,
                                         make_sampler(seed, n_lanes=n, device=dev))
        return L, valid
    L = torch.empty((n, 3), dtype=torch.float32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    p = nerf_params(cfg, scene, o, d, seed, nerf_grid(scene.medium))
    p.P.L, p.valid = L.data_ptr(), valid.data_ptr()
    vs._launch("nerf_primal", vs._load("nerf").nerf_primal_launch, ctypes.byref(p),
               vs._stream(dev))
    return L, valid


def sample_adjoint_kernel(cfg: NerfConfig, scene: Scene, o, d, seed, dL,
                          state_in) -> MediumParams:
    """Path-replay adjoint of the same rays and ``seed`` given ``dL`` and
    the primal radiance ``state_in`` (n, 3): the grids' gradients (zero
    albedo).  On ``cuda`` tensors it launches ``nerf_adjoint_kernel``,
    which adds into a zero grid with atomics."""
    n, dev = o.shape[0], o.device
    m = scene.medium
    if not o.is_cuda:
        g, _ = nerf.sample_adjoint(cfg, scene, o, d, make_sampler(seed, n_lanes=n, device=dev),
                                   dL, state_in)
        return g
    grid = nerf_grid(m)
    g4 = torch.zeros_like(grid)
    p = nerf_params(cfg, scene, o, d, seed, grid)
    p.L_in = vs._need(state_in, "state_in", dev, shape=(n, 3))
    p.dL = vs._need(dL, "dL", dev, shape=(n, 3))
    p.g_grid = g4.data_ptr()
    vs._launch("nerf_adjoint", vs._load("nerf").nerf_adjoint_launch, ctypes.byref(p),
               vs._stream(dev))
    return MediumParams(sigma_t=g4[..., :1].contiguous(), albedo=torch.zeros_like(m.params.albedo),
                        emission=g4[..., 1:].contiguous())
