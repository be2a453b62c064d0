"""Phase functions: isotropic and Henyey-Greenstein.

Port of ``uivr_tpu/scene/phase.py``.  ``g`` is a Python float (a float32
value); ``|g| < 1e-4`` selects the isotropic branch.  Perfect importance
sampling: the phase value equals its pdf.  Fused multiply-adds sit where
the reference's XLA build fuses them (see ``core/fmath.py``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core import fmath
from ..core.fmath import fma

_INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return fmath.sqrt(fma(v[..., 2], v[..., 2],
                          fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _build_frame(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis around unit vectors ``n`` (n, 3)
    (Duff et al. 2017)."""
    x, y, z = n.unbind(-1)
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + z)
    b = x * y * a
    t = torch.stack([fma(sign * (x * x), a, 1.0), sign * b, -sign * x], dim=-1)
    s = torch.stack([b, fma(y * y, a, sign), -y], dim=-1)
    return t, s


def hg_eval(g: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    """HG phase value (= pdf); ``g`` is a tensor shaped like ``cos_theta``."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_theta
    return _INV_FOUR_PI * (1.0 - g2) / torch.clamp(
        denom * fmath.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def _is_iso(g: float) -> bool:
    return abs(g) < 1e-4


def phase_eval(g: float, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    cos_theta = _dot3(wi, wo)
    if _is_iso(g):
        return torch.full_like(cos_theta, _INV_FOUR_PI)
    return hg_eval(torch.full_like(cos_theta, g), cos_theta)


def phase_sample(g: float, wi: torch.Tensor, u1: torch.Tensor,
                 u2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample an outgoing direction around the propagation direction
    ``wi``.  Returns (wo, pdf)."""
    if _is_iso(g):
        cos_theta = 1.0 - 2.0 * u1
    else:
        gt = torch.full_like(u1, g)
        sqr = (1.0 - gt * gt) / (1.0 - gt + 2.0 * gt * u1)
        cos_theta = torch.clamp((1.0 + gt * gt - sqr * sqr) / (2.0 * gt),
                                -1.0, 1.0)
    sin_theta = fmath.sqrt(torch.clamp(fma(-cos_theta, cos_theta, 1.0), min=0.0))
    phi = 2.0 * math.pi * u2
    t, s = _build_frame(wi)
    a = (sin_theta * fmath.cos(phi))[..., None]
    b = (sin_theta * fmath.sin(phi))[..., None]
    wo = fma(cos_theta[..., None], wi, fma(a, t, b * s))
    wo = wo / _norm3(wo)[..., None]
    if _is_iso(g):
        pdf = torch.full_like(cos_theta, _INV_FOUR_PI)
    else:
        pdf = hg_eval(torch.full_like(cos_theta, g), cos_theta)
    return wo, pdf
