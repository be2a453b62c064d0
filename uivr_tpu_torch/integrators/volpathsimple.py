"""Volumetric path tracer configuration and resumable path state.

Port of the parts of ``uivr_tpu/integrators/volpathsimple.py`` that the
flat engine uses: the configuration, :class:`PathState` and
:func:`_exit_dist`.  The nested reference engine and the adjoint are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core import aabb


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
