"""Shared integrator utilities (port of ``uivr_tpu/integrators/common.py``)."""
from __future__ import annotations

import torch

from ..scene.medium import MediumParams


def mis_weight(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta = 2)."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-30)
    return torch.where(pdf_a > 0.0, w, 0.0)


def zero_grads(params: MediumParams) -> MediumParams:
    """Zero gradients shaped like ``params``."""
    return MediumParams(sigma_t=torch.zeros_like(params.sigma_t),
                        albedo=torch.zeros_like(params.albedo),
                        emission=torch.zeros_like(params.emission))
