"""Learning-rate schedules, parameter projection, multires upsampling.

Port of ``uivr_tpu/opt/schedule.py``: the ``Last25`` halvings at 75/85/95%
of the run, per-key learning-rate factors (albedo x2 by default), the
projection of the grids to their legal ranges and x2 trilinear upsampling.
"""
from __future__ import annotations

from enum import IntEnum
from typing import Dict, Set

import torch

from ..core.grids import resize_trilinear
from ..scene.medium import MediumParams


class Schedule(IntEnum):
    Constant = 0
    Last25 = 1


def schedule_factor(schedule: Schedule, it: int, n_iter: int) -> float:
    if schedule in (None, Schedule.Constant):
        return 1.0
    if schedule == Schedule.Last25:
        t = it / max(n_iter - 1, 1)
        f = 1.0
        for s in (0.75, 0.85, 0.95):
            if t >= s:
                f *= 0.5
        return f
    raise ValueError(f"Unsupported schedule: {schedule}")


def learning_rates(base_lr: float, schedule: Schedule, it: int, n_iter: int,
                   lr_factors: Dict[str, float]) -> MediumParams:
    """Per-key learning rates (Python floats) for iteration ``it``."""
    f = schedule_factor(schedule, it, n_iter)
    return MediumParams(
        sigma_t=f * base_lr * lr_factors.get("sigma_t", 1.0),
        albedo=f * base_lr * lr_factors.get("albedo", 2.0),
        emission=f * base_lr * lr_factors.get("emission", 1.0))


def upsample_iterations(fractions, n_iter: int) -> Set[int]:
    out = set()
    for t in (fractions or []):
        if not 0 <= t <= 1:
            raise ValueError(f"upsample fraction {t} outside [0, 1]")
        out.add(int(t * n_iter))
    return out


def enforce_valid_params(params: MediumParams, max_density: float
                         ) -> MediumParams:
    """Project the grids back to their legal ranges."""
    return MediumParams(
        sigma_t=torch.clamp(params.sigma_t, 0.0, max_density),
        albedo=torch.clamp(params.albedo, 0.0, 1.0),
        emission=torch.clamp(params.emission, min=0.0))


def upsample_params(params: MediumParams) -> MediumParams:
    """Double each grid's resolution by trilinear interpolation."""
    def up(g):
        D, H, W, _ = g.shape
        return resize_trilinear(g, (2 * D, 2 * H, 2 * W))
    return MediumParams(sigma_t=up(params.sigma_t), albedo=up(params.albedo),
                        emission=up(params.emission))


def initial_resolution(final_shape, n_upsamples: int):
    """Start resolution so that n x2 upsamples land on ``final_shape``."""
    f = 2 ** n_upsamples
    res = tuple(max(1, s // f) for s in final_shape[:3]) + (final_shape[3],)
    if 1 in res[:3]:
        raise ValueError(f"Initial resolution not supported: {res}; "
                         f"reduce upsample steps")
    return res
