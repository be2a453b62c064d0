"""Full-state checkpoints: params, Adam moments and iteration.

Port of ``uivr_tpu/opt/checkpoint.py`` in its ``.npz`` layout (keys
``params.<grid>``, ``mu.<grid>``, ``nu.<grid>``, ``step`` int32, ``it``
int64), so a state saved by either package loads in the other.  There is no
orbax here.
"""
from __future__ import annotations

import os
from os.path import isfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..scene.medium import MediumParams
from .optimizer import AdamState


def _flatten_state(params: MediumParams, opt_state: AdamState, it: int) -> dict:
    flat = {}
    for prefix, grids in (("params", params), ("mu", opt_state.mu),
                          ("nu", opt_state.nu)):
        for k in MediumParams._fields:
            flat[f"{prefix}.{k}"] = getattr(grids, k).detach().cpu().numpy()
    flat["step"] = np.asarray(opt_state.step, np.int32)
    flat["it"] = np.int64(it)
    return flat


def save_state(path: str, params: MediumParams, opt_state: AdamState,
               it: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **_flatten_state(params, opt_state, it))


def load_state(path: str, device=None
               ) -> Optional[Tuple[MediumParams, AdamState, int]]:
    """``(params, opt_state, iteration)`` from ``path.npz``, or None."""
    if not isfile(path + ".npz"):
        return None
    z = np.load(path + ".npz")

    def grids(prefix):
        return MediumParams(**{k: torch.as_tensor(z[f"{prefix}.{k}"], device=device)
                               for k in MediumParams._fields})

    opt_state = AdamState(step=int(z["step"]), mu=grids("mu"), nu=grids("nu"))
    return grids("params"), opt_state, int(z["it"])
