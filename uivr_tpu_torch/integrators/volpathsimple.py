"""Volumetric path tracer configuration, resumable path state and the
pieces of the nested engine that the flat engine's adjoint uses.

Port of the parts of ``uivr_tpu/integrators/volpathsimple.py`` that the
flat engine uses: the configuration, :class:`PathState`, :func:`_exit_dist`,
the primal NEE estimate :func:`_nee_primal` (the delayed DRT term's direct
light) and the DRT subsampling reservoir.  The nested engine itself
(``sample_primal``/``sample_adjoint``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core import aabb
from ..core.rng import Sampler, next_2d
from ..scene.phase import phase_eval
from ..scene.scene import Scene
from ..tracking import transmittance
from .common import mis_weight


@dataclass(frozen=True)
class VolpathConfig:
    max_depth: int = 64
    rr_depth: int = 1064          # > max_depth: Russian roulette off
    use_nee: bool = True
    use_drt: bool = True
    use_drt_subsampling: bool = True
    use_drt_mis: bool = True
    hide_emitters: bool = False
    max_steps: int = 4096         # tracking steps per lane
    trans_grad_samples: int = 4
    # Russian roulette on shadow-walk transmittance below this threshold
    # (0 = off); reuses the shadow lane's event draw.
    shadow_rr: float = 0.0
    # 'auto' / 'pallas' = the CUDA kernel on cuda tensors, the plain twin on
    # cpu tensors; 'flat' = the plain twin on any device; 'nested' is not
    # ported.
    engine: str = "auto"


class PathState(NamedTuple):
    """Resumable mid-path state (local frame)."""
    active: torch.Tensor    # (n,) bool
    depth: torch.Tensor     # (n,) int32
    o_l: torch.Tensor       # (n,3)
    d_l: torch.Tensor       # (n,3)
    d_w: torch.Tensor       # (n,3)
    maxt: torch.Tensor      # (n,)
    last_pdf: torch.Tensor  # (n,)


def _exit_dist(o_l: torch.Tensor, d_l: torch.Tensor) -> torch.Tensor:
    """Distance to the unit-cube exit from a point inside (or on) it."""
    _, tf, _ = aabb.ray_unit_cube(o_l, d_l, 0.0, aabb.INF)
    return tf


def _nee_primal(cfg: VolpathConfig, scene: Scene, p, d_w, throughput,
                sampler: Sampler, active_e):
    """Primal NEE estimate from local points ``p`` with incident world
    direction ``d_w``: two draws for the emitter direction, then ratio
    tracking on the same wavefront sampler.  Returns
    ``(contrib (n,3), (dln, tmax, active_e), sampler)``."""
    m = scene.medium
    u2, sampler = next_2d(sampler)
    ds_d, ds_pdf, em_weight = scene.emitter.sample_direction(u2)
    active_e = active_e & (ds_pdf > 0.0)
    dln = aabb.transform_dirs(m.world_to_local, ds_d)
    tmax = _exit_dist(p, dln)
    tr, sampler = transmittance(m, p, dln, tmax, sampler, active_e,
                                max_steps=cfg.max_steps)
    ph = phase_eval(m.phase_g, d_w, ds_d)
    w = mis_weight(ds_pdf, ph)
    contrib = throughput * (ph * w * tr)[:, None] * em_weight
    contrib = torch.where(active_e[:, None], contrib, 0.0)
    return contrib, (dln, tmax, active_e), sampler


class _Reservoir(NamedTuple):
    """Per-lane reservoir over path vertices for DRT subsampling: one
    vertex is kept with probability proportional to its throughput."""
    wsum: torch.Tensor      # (n,3)
    cur_w: torch.Tensor     # (n,3)
    depth: torch.Tensor     # (n,) int32
    o_l: torch.Tensor       # (n,3) segment origin
    d_l: torch.Tensor       # (n,3)
    d_w: torch.Tensor       # (n,3)
    maxt: torch.Tensor      # (n,)
    active: torch.Tensor    # (n,) bool


def _mean3(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis of (n, 3), summed left to right (the CUDA
    kernels repeat this order)."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) / 3.0


def _reservoir_init(ref3: torch.Tensor) -> _Reservoir:
    """Empty reservoirs shaped like the (n, 3) tensor ``ref3``."""
    def z3():
        return torch.zeros_like(ref3)
    z1 = torch.zeros_like(ref3[:, 0])
    return _Reservoir(wsum=z3(), cur_w=z3(),
                      depth=torch.full_like(z1, -1, dtype=torch.int32),
                      o_l=z3(), d_l=z3(), d_w=z3(), maxt=z1,
                      active=torch.zeros_like(z1, dtype=torch.bool))


def _reservoir_update(r: _Reservoir, weight, u, active, depth, o_l, d_l, d_w,
                      maxt) -> _Reservoir:
    w = torch.where(active[:, None], weight, 0.0)
    wsum = r.wsum + w
    ratio = _mean3(torch.where(wsum > 0, w / torch.clamp(wsum, min=1e-30), 0.0))
    change = active & (u <= ratio)
    sel = change[:, None]
    return _Reservoir(
        wsum=wsum,
        cur_w=torch.where(sel, w, r.cur_w),
        depth=torch.where(change, depth, r.depth),
        o_l=torch.where(sel, o_l, r.o_l),
        d_l=torch.where(sel, d_l, r.d_l),
        d_w=torch.where(sel, d_w, r.d_w),
        maxt=torch.where(change, maxt, r.maxt),
        active=r.active | change)


def _reservoir_get(r: _Reservoir) -> torch.Tensor:
    """The kept vertex's sampling weight (n, 3): mean(wsum) cur_w / mean(cur_w)."""
    d = _mean3(r.cur_w)
    w = _mean3(r.wsum)[:, None] * r.cur_w / torch.clamp(d, min=1e-30)[:, None]
    return torch.where((d > 0)[:, None], w, 0.0)
