"""float32 arithmetic with one rounding per operation.

The port fixes its float32 results so the CUDA kernel and the plain twin
compute the same bits on the card, and so they stay close to the reference:

- ``fma``: ``a * b + c`` rounded once, at the sites where the reference's
  XLA build fuses them (dot products, trilinear sums, phase sampling).  The
  kernel calls ``fmaf`` there and is built with ``--fmad=false`` so
  nothing else fuses.
- ``ray_point``: ``o + t * d`` for (n, 3) rays, fused per component as
  XLA's CPU build vectorises that expression at each site (measured: x and
  y fused in the tracking step, z alone at the medium entry).
- ``sqrt``, ``sin``, ``cos``, ``log1p``, ``atan2``, ``acos``: evaluated in
  float64 and rounded once, i.e. the correctly rounded float32 value bar
  rare ties.  PyTorch's own float32 versions differ between CPU and CUDA
  builds; the kernel evaluates the same float64 functions.

The float64 product of two float32 values is exact, so the emulated FMA
differs from a true one only when the float64 sum lands exactly halfway
between two float32 values.
"""
from __future__ import annotations

import torch


def _f64(x):
    return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(x)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (tensors or Python floats)."""
    return (_f64(a) * _f64(b) + _f64(c)).to(torch.float32)


def ray_point(o: torch.Tensor, t: torch.Tensor, d: torch.Tensor,
              fused=(True, True, False)) -> torch.Tensor:
    """``o + t[:, None] * d`` for (n, 3) ``o``, ``d`` and (n,) ``t``, with
    component i fused when ``fused[i]``."""
    return torch.stack([fma(t, d[:, i], o[:, i]) if f else o[:, i] + t * d[:, i]
                        for i, f in enumerate(fused)], dim=1)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_f64(x)).to(torch.float32)


def sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(_f64(x)).to(torch.float32)


def cos(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(_f64(x)).to(torch.float32)


def log1p(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(_f64(x)).to(torch.float32)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.atan2(_f64(y), _f64(x)).to(torch.float32)


def acos(x: torch.Tensor) -> torch.Tensor:
    return torch.acos(_f64(x)).to(torch.float32)
