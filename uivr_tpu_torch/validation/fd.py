"""Finite-difference gradient oracle.

Port of ``uivr_tpu/validation/fd.py``: single-sided forward differences
(or central differences) over every entry of the requested grids, with
common random numbers (the loss renders with a fixed seed, so the centre
and the offset renders trace the same paths), which makes FD usable at
modest spp for stochastic estimators.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..scene.medium import MediumParams


def fd_gradients(loss_of_params: Callable[[MediumParams], float],
                 params: MediumParams, eps: float = 5e-3,
                 keys=("sigma_t", "albedo", "emission"),
                 progress: bool = False,
                 central: bool = False) -> Dict[str, np.ndarray]:
    """dloss/dgrid by FD for each entry of each requested grid.

    ``loss_of_params`` must be deterministic given the grids (a fixed seed
    inside).  Each offset grid is made in float32 numpy, as the reference
    makes it, and moved to the device of ``params``.  Returns float64 numpy
    arrays shaped like the grids.  ``central=True`` takes second-order
    central differences (twice the renders)."""
    loss_center = float(loss_of_params(params))
    out = {}
    for key in keys:
        g0 = getattr(params, key)
        v0 = g0.detach().cpu().numpy()
        grads = np.full(v0.shape, np.nan, np.float64)

        def loss_at(v):
            t = torch.as_tensor(v, device=g0.device)
            return float(loss_of_params(params._replace(**{key: t})))

        for idx in np.ndindex(*v0.shape):
            v = v0.copy()
            v[idx] += eps
            loss_hi = loss_at(v)
            if central:
                v = v0.copy()
                v[idx] -= eps
                grads[idx] = (loss_hi - loss_at(v)) / (2 * eps)
            else:
                grads[idx] = (loss_hi - loss_center) / eps
            if progress:
                print(key, idx, grads[idx])
        out[key] = grads
    return out
