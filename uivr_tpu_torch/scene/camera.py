"""Batched pinhole perspective cameras.

Port of ``uivr_tpu/scene/camera.py``: all sensors of a scene are one
stacked tuple, so a batch mixing rays from many cameras is one gather.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import fmath
from ..core.fmath import fma


class Cameras(NamedTuple):
    """Stack of N pinhole cameras; camera space is x-right, y-up, looking
    down +z.  ``tan_half_fov`` is along x; y follows the film aspect."""
    cam_to_world: torch.Tensor   # (N, 4, 4)
    tan_half_fov: torch.Tensor   # (N,)
    aspect: torch.Tensor         # (N,) = resy / resx

    @property
    def n_sensors(self) -> int:
        return self.cam_to_world.shape[0]


def look_at(origin, target, up) -> np.ndarray:
    """4x4 camera-to-world transform (host-side helper)."""
    origin = np.asarray(origin, np.float64)
    fwd = np.asarray(target, np.float64) - origin
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    new_up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = fwd
    m[:3, 3] = origin
    return m.astype(np.float32)


def make_cameras(to_world: np.ndarray, fov_x_deg, resx: int, resy: int,
                 device=None) -> Cameras:
    to_world = torch.as_tensor(np.asarray(to_world, np.float32), device=device)
    if to_world.ndim == 2:
        to_world = to_world[None]
    n = to_world.shape[0]
    fov = torch.as_tensor(np.broadcast_to(np.asarray(fov_x_deg, np.float32),
                                          (n,)).copy(), device=device)
    return Cameras(cam_to_world=to_world,
                   tan_half_fov=torch.tan(torch.deg2rad(fov) * 0.5),
                   aspect=torch.full((n,), resy / resx, dtype=torch.float32,
                                     device=device))


def sample_rays(cams: Cameras, sensor_idx: torch.Tensor,
                uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-space rays for film positions ``uv`` (n, 2) in [0,1]^2
    (u right, v down) of cameras ``sensor_idx`` (n,).  Returns
    (origins (n,3), unit directions (n,3)); rounding as the reference's
    XLA build (fused dot and norm, see ``core/fmath.py``)."""
    m = cams.cam_to_world[sensor_idx]                  # (n, 4, 4)
    thf = cams.tan_half_fov[sensor_idx]
    asp = cams.aspect[sensor_idx]
    x = (2.0 * uv[:, 0] - 1.0) * thf
    y = (1.0 - 2.0 * uv[:, 1]) * thf * asp
    d = torch.stack([fma(y, m[:, i, 1], x * m[:, i, 0]) + m[:, i, 2]
                     for i in range(3)], dim=-1)
    norm = fmath.sqrt(fma(d[:, 2], d[:, 2], fma(d[:, 1], d[:, 1], d[:, 0] * d[:, 0])))
    return m[:, :3, 3].contiguous(), d / norm[:, None]


def orbit_cameras(n: int, radius: float, target=(0.0, 0.0, 0.0),
                  elevation_deg: float = 20.0, fov_x_deg: float = 45.0,
                  resx: int = 128, resy: int = 128,
                  up=(0.0, 1.0, 0.0), device=None) -> Cameras:
    """N cameras on an orbit around ``target``."""
    mats = []
    el = math.radians(elevation_deg)
    tgt = np.asarray(target, np.float64)
    for i in range(n):
        az = 2.0 * math.pi * i / n
        o = tgt + radius * np.array([
            math.cos(el) * math.cos(az),
            math.sin(el),
            math.cos(el) * math.sin(az)])
        mats.append(look_at(o, tgt, up))
    return make_cameras(np.stack(mats), fov_x_deg, resx, resy, device=device)
