"""Adam and SGD with per-parameter learning rates and state reset.

Port of ``uivr_tpu/opt/optimizer.py``, with its update formula (bias
corrections ``1 - beta**t`` and ``eps`` added to ``sqrt(v_hat)``); not
``torch.optim.Adam``, which places ``eps`` and rounds differently.  Params,
gradients and moments are :class:`MediumParams` of tensors (or any tuple of
tensors); updates are out of place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    step: int            # updates taken
    mu: tuple            # first moments, shaped like params
    nu: tuple            # second moments


def adam_init(params) -> AdamState:
    return AdamState(step=0,
                     mu=type(params)(*[torch.zeros_like(p) for p in params]),
                     nu=type(params)(*[torch.zeros_like(p) for p in params]))


def _lrs(lr, params):
    if isinstance(lr, (int, float)):
        return [lr] * len(params)
    return list(lr)


def adam_step(params, grads, state: AdamState, lr,
              beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8):
    """One Adam update; ``lr`` is a scalar or a tuple like ``params``."""
    step = state.step + 1
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(beta1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(beta2, dtype=torch.float32) ** t)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, a in zip(params, grads, state.mu, state.nu, _lrs(lr, params)):
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        new_p.append(p - a * mh / (torch.sqrt(vh) + eps))
        new_m.append(m)
        new_v.append(v)
    kind = type(params)
    return kind(*new_p), AdamState(step=step, mu=kind(*new_m), nu=kind(*new_v))


def sgd_step(params, grads, state: AdamState, lr, momentum: float = 0.0):
    """SGD, with optional momentum kept in ``mu``."""
    new_p, new_m = [], []
    for p, g, m, a in zip(params, grads, state.mu, _lrs(lr, params)):
        m = momentum * m + g
        new_p.append(p - a * m)
        new_m.append(m)
    kind = type(params)
    return kind(*new_p), AdamState(step=state.step + 1, mu=kind(*new_m),
                                   nu=state.nu)


def reset_state_like(params) -> AdamState:
    """Fresh optimizer state after a resolution change (upsampling)."""
    return adam_init(params)
