"""Gradient accumulators of the hand-written adjoints (grid mode).

Port of the grid-mode half of ``uivr_tpu/scene/gradients.py``: cotangents
are scatter-added at a point into the 8 trilinear corners of (D,H,W,C)
grids.  The TPU's corner-table row accumulators are not ported; the CUDA
kernels add into the same grids with ``atomicAdd``.

The accumulators are updated in place.  A scatter touches only the lanes
its mask selects, as the kernels do (the reference multiplies the weights
by the mask, which differs only for a non-finite cotangent on a masked
lane).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.grids import trilinear_scatter
from .medium import Medium, MediumParams


class GradAccum(NamedTuple):
    """sigma (D,H,W,1), albedo (D,H,W,3); emission (D,H,W,3), or a 0-d
    zero when the adjoint never scatters emission cotangents."""
    sigma: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor


def init_accum(m: Medium, need_emission: bool = True) -> GradAccum:
    """Zero accumulator on the medium's device."""
    p = m.params
    emission = (torch.zeros_like(p.emission) if need_emission
                else torch.zeros((), dtype=p.emission.dtype,
                                 device=p.emission.device))
    return GradAccum(sigma=torch.zeros_like(p.sigma_t),
                     albedo=torch.zeros_like(p.albedo), emission=emission)


def finalize_accum(acc: GradAccum, m: Medium) -> MediumParams:
    """Accumulator -> gradients shaped like MediumParams (zero emission
    when it was not accumulated)."""
    emission = (acc.emission if acc.emission.ndim
                else torch.zeros_like(m.params.emission))
    return MediumParams(sigma_t=acc.sigma, albedo=acc.albedo,
                        emission=emission)


def scatter_sigma_albedo(acc: GradAccum, m: Medium, p: torch.Tensor,
                         cot_sigma: torch.Tensor, cot_albedo: torch.Tensor,
                         mask: torch.Tensor) -> GradAccum:
    """Accumulate sigma_t (n,) and albedo (n,3) cotangents at points ``p``.
    sigma_t = scale * grid, so the sigma cotangent takes the chain factor
    ``m.scale``; the albedo's does not."""
    idx = torch.nonzero(mask).flatten()
    pm = p[idx]
    trilinear_scatter(acc.sigma, pm, (cot_sigma[idx] * m.scale)[:, None])
    trilinear_scatter(acc.albedo, pm, cot_albedo[idx])
    return acc


def scatter_sigma(acc: GradAccum, m: Medium, p: torch.Tensor,
                  cot_sigma: torch.Tensor, mask: torch.Tensor) -> GradAccum:
    """Accumulate a cotangent on sigma_t(p) (n,)."""
    idx = torch.nonzero(mask).flatten()
    trilinear_scatter(acc.sigma, p[idx], (cot_sigma[idx] * m.scale)[:, None])
    return acc


def scatter_emission(acc: GradAccum, m: Medium, p: torch.Tensor,
                     cot: torch.Tensor, mask: torch.Tensor,
                     scaled: bool = True) -> GradAccum:
    """Accumulate a cotangent on emission(p) (n, 3); with ``scaled``
    (emission = scale * grid) it takes the chain factor ``m.scale``."""
    idx = torch.nonzero(mask).flatten()
    c = cot[idx] * m.scale if scaled else cot[idx]
    trilinear_scatter(acc.emission, p[idx], c)
    return acc
