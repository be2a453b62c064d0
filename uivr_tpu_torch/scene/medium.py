"""The heterogeneous participating medium: voxel grids + majorant supergrid.

Port of ``uivr_tpu/scene/medium.py``.  The medium fills the unit cube
[0,1]^3 of its local frame; ``to_world`` is an arbitrary affine transform.
Instead of the reference's TPU corner tables, ``Medium.grid`` holds one
interleaved (D, H, W, 4) float32 grid [sigma, albedo_rgb] whose corners the
CUDA kernel reads as one ``float4`` each.  ``Medium.sub`` is the subcell
classification bound of the reference's step kernel (``build_tables``'s
``sub``): a conservative upper bound of sigma_t over each cell of a fine
uniform grid, which lets the walking kernels decide most null events
without reading the grid.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.grids import (build_bound_grid, build_majorant_grid, cls_dims,
                          trilinear_sample)


class MediumParams(NamedTuple):
    """Voxel grids (D, H, W, C)."""
    sigma_t: torch.Tensor   # (D, H, W, 1)
    albedo: torch.Tensor    # (D, H, W, 3)
    emission: torch.Tensor  # (D, H, W, 3)


@dataclass(frozen=True)
class MediumConfig:
    majorant_factor: int = 8        # supergrid factor; <=1 -> one global cell
    scale: float = 1.0              # sigma_t = scale * grid
    emission_scaled: bool = True    # emission = scale * grid
    phase_g: float = 0.0            # HG anisotropy; 0 = isotropic
    # The factor is doubled until the supergrid has at most this many cells
    # (the reference's kernel-resident budget).  The supergrid decides
    # where walks cross cells, and each crossing consumes two draws, so the
    # same budget keeps the port's paths identical to the reference's.
    # 0 keeps the requested factor.
    kernel_majorant_max_cells: int = 2048
    # Cell budget of the subcell classification grid (the reference's
    # UIVR_CLASS_CELLS, default 8192); 0 turns classification off.  It
    # changes no path, only which events skip the sigma fetch.
    cls_cells: int = 8192


class Medium(NamedTuple):
    params: MediumParams
    scale: float                 # float32 value
    local_to_world: torch.Tensor  # (4, 4)
    world_to_local: torch.Tensor  # (4, 4)
    majorant_grid: torch.Tensor   # (Dc, Hc, Wc), scaled
    phase_g: float               # float32 value
    grid: torch.Tensor            # (D, H, W, 4) [sigma (unscaled), albedo]
    sub: Optional[torch.Tensor]   # (Ds, Hs, Ws) scaled sigma bound, or None (off)


def _effective_factor(requested: int, shape: Tuple[int, ...]) -> int:
    """Shrink the factor until the supergrid has a meaningful resolution
    (min_side // factor >= 4), else disable (0 = single cell)."""
    f = int(requested)
    min_side = min(int(s) for s in shape[:3])
    while f > 1 and (min_side // f) < 4:
        f -= 1
    return max(f, 1) if f > 1 else 0


def finalize_medium(params: MediumParams, cfg: MediumConfig,
                    to_world=None) -> Medium:
    """Build the medium (majorant supergrid, interleaved grid, transforms)
    from the grids and the static config, on the grids' device."""
    dev = params.sigma_t.device
    if to_world is None:
        to_world = np.eye(4, dtype=np.float32)
    if isinstance(to_world, torch.Tensor):
        to_world = to_world.detach().cpu().numpy()
    to_world = np.asarray(to_world, np.float32)
    inv = np.linalg.inv(to_world.astype(np.float64)).astype(np.float32)

    f = _effective_factor(cfg.majorant_factor, params.sigma_t.shape)
    if f > 0 and cfg.kernel_majorant_max_cells:
        D_, H_, W_, _ = params.sigma_t.shape

        def n_cells(fac):
            return int(np.prod([-(-max(int(x) - 1, 1) // fac)
                                for x in (D_, H_, W_)]))

        min_side = min(D_, H_, W_)
        while n_cells(f) > cfg.kernel_majorant_max_cells and 2 * f < min_side:
            f *= 2
    sig = params.sigma_t.detach()
    if f == 0:
        maj = sig.max().reshape(1, 1, 1)
    else:
        maj = build_majorant_grid(sig, f)
    scale = float(np.float32(cfg.scale))
    maj = maj * scale
    sub = None
    dims = cls_dims(params.sigma_t.shape, cfg.cls_cells)
    if dims[0] > 0:
        # detached like the majorant; |sigma| so that hi == 0 certifies
        # sigma == 0, and the 1e-5 margin keeps hi above the rounded
        # trilinear sigma, so a real collision never classifies as null
        margin = np.float32(np.float32(scale) * np.float32(1.00001))
        sub = (build_bound_grid(sig.abs(), dims) * float(margin)).contiguous()
    grid = torch.cat([params.sigma_t, params.albedo], dim=-1).to(torch.float32)
    return Medium(
        params=params, scale=scale,
        local_to_world=torch.as_tensor(to_world, device=dev),
        world_to_local=torch.as_tensor(inv, device=dev),
        majorant_grid=maj.contiguous(),
        phase_g=float(np.float32(cfg.phase_g)),
        grid=grid.contiguous(), sub=sub)


def sigma_albedo_at(m: Medium, p: torch.Tensor):
    """(sigma (n,), albedo (n,3)) at local points (n, 3): one trilinear
    lookup of the interleaved grid."""
    v = trilinear_sample(m.grid, p)
    return v[:, 0] * m.scale, v[:, 1:]
