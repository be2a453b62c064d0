"""Trilinearly interpolated voxel grids and majorant supergrids.

Port of ``uivr_tpu/core/grids.py`` (sampling, its explicit pullback,
majorant construction and trilinear resizing).
Layout: ``data[D, H, W, C]`` with D = z slowest; positions in the local unit
cube [0,1]^3 in (x, y, z) order; node-centred, clamped at the boundary.
The TPU corner tables (row-gather workaround) have no counterpart here: the
CUDA kernel reads the 8 corners of one interleaved (D, H, W, 4) grid.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _cell_res(shape: Tuple[int, int, int], dtype, device):
    """Per-axis constants of a (D, H, W) grid's trilinear lookup, made
    once per grid shape and device (a copy from the host would wait for
    the device at every lookup): ``res`` (W-1, H-1, D-1), ``res - 1`` and
    ``res`` clamped at 0, ``res > 0``."""
    D, H, W = shape
    res = torch.tensor([W - 1, H - 1, D - 1], dtype=dtype, device=device)
    return (res, torch.clamp(res - 1.0, min=0.0), torch.clamp(res, min=0.0).to(torch.int64),
            res > 0)


def _corner_indices_weights(shape: Tuple[int, ...], p: torch.Tensor):
    """Flat node indices (n, 8) int64 and weights (n, 8) for trilinear
    interpolation at points ``p`` (n, 3).  Corner k takes the upper node
    on z, y, x where bits 2, 1, 0 of k are set; its weight is
    ``(wz * wy) * wx``."""
    D, H, W = int(shape[0]), int(shape[1]), int(shape[2])
    res, top, top_i, pos = _cell_res((D, H, W), p.dtype, p.device)
    x = torch.clamp(p, 0.0, 1.0) * res
    i0 = torch.minimum(torch.clamp(torch.floor(x), min=0.0), top)
    f = torch.where(pos, x - i0, 0.0)
    i0 = i0.to(torch.int64)
    i = torch.stack([i0, torch.minimum(i0 + 1, top_i)], dim=-1)    # (n, 3, 2)
    wt = torch.stack([1.0 - f, f], dim=-1)                         # (n, 3, 2)
    # corner k: z from bit 2, y from bit 1, x from bit 0
    iz, iy, ix = i[:, 2].repeat_interleave(4, 1), i[:, 1].repeat_interleave(2, 1).repeat(1, 2), \
        i[:, 0].repeat(1, 4)
    wz, wy, wx = wt[:, 2].repeat_interleave(4, 1), wt[:, 1].repeat_interleave(2, 1).repeat(1, 2), \
        wt[:, 0].repeat(1, 4)
    return (iz * H + iy) * W + ix, (wz * wy) * wx


def trilinear_sample(data: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sample ``data`` (D,H,W,C) at points ``p`` (n,3) -> (n,C).  The eight
    corner terms are a forward chain of fused multiply-adds in corner
    order, as the reference's sum compiles and the kernel repeats."""
    C = data.shape[-1]
    idx, w = _corner_indices_weights(data.shape, p)
    vals = data.reshape(-1, C)[idx]          # (n, 8, C)
    out = vals[:, 0] * w[:, :1]
    # fma(vals_k, w_k, out): the float64 product of float32 values is
    # exact, and the sum is rounded to float32 once (core/fmath.fma)
    prod = vals.to(torch.float64) * w.to(torch.float64)[..., None]
    for k in range(1, 8):
        out = (prod[:, k] + out.to(torch.float64)).to(torch.float32)
    return out


def trilinear_scatter(grad_acc: torch.Tensor, p: torch.Tensor,
                      cot: torch.Tensor, mask: torch.Tensor = None
                      ) -> torch.Tensor:
    """Pullback of :func:`trilinear_sample`: add ``cot`` (n, C) times the
    trilinear weights into the 8 corner nodes of ``grad_acc`` (D,H,W,C) at
    points ``p`` (n, 3); ``mask`` (n,) zeroes lanes.  Unlike the reference,
    which returns a new grid, this accumulates into ``grad_acc`` in place
    and returns it (the adjoint's accumulators are private to it)."""
    C = grad_acc.shape[-1]
    idx, w = _corner_indices_weights(grad_acc.shape, p.to(grad_acc.dtype))
    if mask is not None:
        w = w * mask.to(w.dtype)[:, None]
    contrib = w[..., None] * cot[:, None, :]            # (n, 8, C)
    grad_acc.view(-1, C).index_add_(0, idx.reshape(-1), contrib.reshape(-1, C))
    return grad_acc


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of the reference's trilinear resize
    (``jax.image.resize``: half-pixel centres, a triangle kernel widened by
    the scale when shrinking, columns normalised to sum 1, samples outside
    the input zeroed)."""
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_trilinear(data: torch.Tensor, new_res: Tuple[int, int, int]
                     ) -> torch.Tensor:
    """Trilinear resampling of a (D,H,W,C) grid to ``new_res`` (D',H',W'),
    as the reference's multi-resolution schedule does it."""
    out = data
    for axis, n_out in enumerate(new_res):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = torch.as_tensor(_resize_weights(n_in, int(n_out)),
                            device=data.device)
        out = torch.movedim(torch.tensordot(out, w, dims=([axis], [0])), -1, axis)
    return out.contiguous()


def _axis_window_max(arr: torch.Tensor, axis: int, n_nodes: int,
                     n_cells: int) -> torch.Tensor:
    """Per-axis conservative max-pool onto ``n_cells`` uniform-p cells: cell
    ``s`` bounds nodes [floor(s(N-1)/c), floor((s+1)(N-1)/c) + 1]."""
    N, c = int(n_nodes), int(n_cells)
    s = np.arange(c, dtype=np.int64)
    lo = (s * (N - 1)) // c
    hi = np.minimum(((s + 1) * (N - 1)) // c + 1, N - 1)
    win = int((hi - lo).max()) + 1
    idx = np.minimum(lo[:, None] + np.arange(win)[None, :], hi[:, None])
    g = torch.index_select(arr, axis,
                           torch.as_tensor(idx.reshape(-1), device=arr.device))
    shp = list(g.shape)
    shp[axis:axis + 1] = [c, win]
    return g.reshape(shp).amax(dim=axis + 1)


def build_bound_grid(sigma: torch.Tensor, dims: Tuple[int, int, int]
                     ) -> torch.Tensor:
    """Conservative per-cell bound of trilinear(sigma) on a (Dc,Hc,Wc)
    uniform-p cell grid, from the (D,H,W,1) node grid."""
    D, H, W, C = sigma.shape
    if C != 1:
        raise ValueError(f"bound grid needs a 1-channel grid, got {C}")
    s = sigma[..., 0]
    s = _axis_window_max(s, 0, D, dims[0])
    s = _axis_window_max(s, 1, H, dims[1])
    s = _axis_window_max(s, 2, W, dims[2])
    return s


def majorant_dims(shape: Tuple[int, ...], factor: int) -> Tuple[int, int, int]:
    """Supergrid dims for a (D,H,W,...) grid: Xc = ceil(max(X-1,1)/factor)."""
    return tuple(-(-max(int(n) - 1, 1) // factor) for n in shape[:3])


def cls_dims(shape: Tuple[int, ...], budget: int = 8192) -> Tuple[int, int, int]:
    """Dims of the subcell classification grid (the reference's
    ``ops/volpath_step._cls_dims``): the ``majorant_dims`` of the smallest
    power-of-two factor whose cell count fits ``budget``; (0, 0, 0) when
    ``budget`` <= 0 (classification off)."""
    if budget <= 0:
        return (0, 0, 0)
    f = 1
    while True:
        dims = majorant_dims(shape, f)
        if int(np.prod(dims)) <= budget:
            return tuple(int(x) for x in dims)
        f *= 2


def build_majorant_grid(sigma: torch.Tensor, factor: int) -> torch.Tensor:
    """Conservative coarse max-grid (Dc, Hc, Wc) over a (D,H,W,1) grid."""
    if factor < 1:
        raise ValueError(f"majorant factor must be >= 1, got {factor}")
    return build_bound_grid(sigma, majorant_dims(sigma.shape, factor))


def global_majorant(sigma: torch.Tensor) -> torch.Tensor:
    """Scalar majorant over the whole grid."""
    return sigma.max()
