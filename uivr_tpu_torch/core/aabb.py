"""Ray <-> unit-cube intersection for the single medium bounding volume.

Port of ``uivr_tpu/core/aabb.py``.  Rays are moved into the medium's local
frame without renormalising the direction, so ray parameters ``t`` agree
between frames.  A transform is a forward chain of fused multiply-adds per
component, as the reference's dot compiles, so the CUDA kernel repeats it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .fmath import fma

INF = math.inf
EPS = 1e-6


class Rays(NamedTuple):
    """A wavefront of rays (SoA). ``maxt`` is the far clip distance."""
    o: torch.Tensor      # (n, 3)
    d: torch.Tensor      # (n, 3) unit length in world space
    maxt: torch.Tensor   # (n,)


def transform_dirs(mat: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Linear part of a 4x4 (or 3x3) transform applied to (n, 3) vectors:
    ``out_i = fma(d_2, m_i2, fma(d_1, m_i1, d_0 m_i0))``."""
    cols = [fma(d[..., 2], mat[i, 2], fma(d[..., 1], mat[i, 1], d[..., 0] * mat[i, 0]))
            for i in range(3)]
    return torch.stack(cols, dim=-1)


def transform_points(mat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """4x4 affine transform of (n, 3) points."""
    return transform_dirs(mat, p) + mat[:3, 3]


def ray_unit_cube(o: torch.Tensor, d: torch.Tensor, tmin=0.0, tmax=INF
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab test of local-frame rays against [0,1]^3.  Returns
    ``(t_near, t_far, hit)`` with the interval clipped to [tmin, tmax]."""
    tiny = torch.where(d >= 0, 1e-20, -1e-20).to(d.dtype)
    inv_d = 1.0 / torch.where(d.abs() < 1e-20, tiny, d)
    t0 = (0.0 - o) * inv_d
    t1 = (1.0 - o) * inv_d
    t_lo = torch.minimum(t0, t1)
    t_hi = torch.maximum(t0, t1)
    t_near = torch.clamp(t_lo.amax(dim=-1), min=tmin)
    t_far = torch.clamp(t_hi.amin(dim=-1), max=tmax)
    return t_near, t_far, t_near <= t_far
