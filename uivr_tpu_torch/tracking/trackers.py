"""Wavefront tracking loops on the global-counter sampler.

Port of ``uivr_tpu/tracking/trackers.py``: :func:`transmittance` (ratio
tracking, primal form) and :func:`drt_distance` (transmittance-proportional
distance sampling of Differential Ratio Tracking).  The delayed DRT term
runs them (``integrators/volpath_flat._drt_backward_flat``); the CUDA
kernels ``ops/csrc/volpath_drt.cu`` repeat them per lane.

Their draws come from a :class:`Sampler` whose counter is shared by the
whole wavefront: every iteration takes its draws at the same ``dim`` for
every lane, and the loop runs until the longest walk ends.  So a lane's
k-th step draws at ``dim0 + draws_per_iteration * k`` and the sampler
leaves the loop at ``dim0 + draws_per_iteration * max_trips``.  Each
iteration here steps only the walks still running; the draws are hashes of
(seed, dim, lane), so this gives the reference's values.
``free_flight`` and the adjoint form of ``transmittance`` belong to the
nested engine and are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import fmath
from ..core.fmath import ray_point
from ..core.rng import Sampler, _to_unit_float, tea, tea_plain
from ..scene.medium import Medium, sigma_albedo_at

_BIG = 1e30


def _cell_exit(m: Medium, ol: torch.Tensor, dl: torch.Tensor,
               t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma_maj, t_exit): the supercell majorant at parameter ``t`` and
    the parameter at which the ray leaves that supercell (at least
    ``t + eps``, so a walk always advances)."""
    Dc, Hc, Wc = m.majorant_grid.shape
    res = torch.tensor([Wc, Hc, Dc], dtype=torch.float32, device=ol.device)
    eps = 1e-5 * (1.0 + t.abs())
    p = ray_point(ol, t + eps, dl)
    cell = torch.minimum(
        torch.clamp(torch.floor(torch.clamp(p, 0.0, 1.0 - 1e-7) * res), min=0.0),
        res - 1.0)
    ci = cell.to(torch.int64)
    sigma_maj = m.majorant_grid[ci[:, 2], ci[:, 1], ci[:, 0]]
    lo = cell / res
    hi = (cell + 1.0) / res
    tiny = torch.where(dl >= 0, 1e-20, -1e-20).to(dl.dtype)
    safe_d = torch.where(dl.abs() < 1e-20, tiny, dl)
    t_hi = torch.maximum((lo - ol) / safe_d, (hi - ol) / safe_d)
    t_exit = torch.minimum(torch.minimum(t_hi[:, 0], t_hi[:, 1]), t_hi[:, 2])
    return sigma_maj, torch.maximum(t_exit, t + eps)


def _sigma_at(m: Medium, ol, dl, t):
    p = ray_point(ol, t, dl)
    return sigma_albedo_at(m, p)[0], p


def wavefront_draw(s: Sampler, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """The draw of ``s`` at counter ``dim`` for lanes ``s.lanes[idx]``."""
    h0, h1 = tea_plain(dim, s.seed, rounds=4)
    lanes = s.lanes[idx]
    bits, _ = tea(lanes, torch.full_like(lanes, h0 ^ h1), rounds=8)
    return _to_unit_float(bits)


def _free_step(sigma_maj, u):
    return torch.where(sigma_maj > 0.0,
                       -fmath.log1p(-u) / torch.clamp(sigma_maj, min=1e-20),
                       _BIG)


def _ratio(sig, sigma_maj):
    return torch.clamp(torch.where(
        sigma_maj > 0.0, 1.0 - sig / torch.clamp(sigma_maj, min=1e-20), 1.0),
        min=0.0)


def transmittance(m: Medium, ol: torch.Tensor, dl: torch.Tensor,
                  tmax: torch.Tensor, sampler: Sampler, active: torch.Tensor,
                  max_steps: int = 4096):
    """Ratio-tracking transmittance over [0, tmax] along local rays: one
    draw per iteration.  Returns ``(Tr (n,), sampler)``; Tr = 0 on inactive
    lanes."""
    t = torch.zeros_like(tmax)
    tr = torch.where(active, 1.0, 0.0).to(tmax.dtype)
    ids = torch.nonzero(active).flatten()
    dim, it = sampler.dim, 0
    while ids.numel():
        o, d, tt, mx = ol[ids], dl[ids], t[ids], tmax[ids]
        sigma_maj, t_exit = _cell_exit(m, o, d, tt)
        u1 = wavefront_draw(sampler, dim, ids)
        t_cand = tt + _free_step(sigma_maj, u1)
        collided = t_cand < torch.minimum(t_exit, mx)
        crossed = ~collided & (t_exit < mx)
        done_now = ~collided & (t_exit >= mx)
        sig, _ = _sigma_at(m, o, d, t_cand)
        tri = torch.where(collided, tr[ids] * _ratio(sig, sigma_maj), tr[ids])
        tr[ids] = tri
        t[ids] = torch.where(collided, t_cand, torch.where(crossed, t_exit, tt))
        walking = ~done_now & (tri > 0.0) & (it < max_steps)
        ids = ids[walking]
        dim, it = (dim + 1) & 0xFFFFFFFF, it + 1
    return tr, sampler._replace(dim=dim)


def drt_distance(m: Medium, ol: torch.Tensor, dl: torch.Tensor,
                 maxt: torch.Tensor, sampler: Sampler, active: torch.Tensor,
                 max_steps: int = 4096, w_min: float = 1e-7):
    """Transmittance-proportional distance sampling (DRT): walk every
    majorant collision in [0, maxt] and reservoir-sample one with
    probability proportional to omega_k = W_k / sigma_maj(t_k), W_k the
    running ratio-tracking product; two draws per iteration.  Returns
    ``(t_sel, weight = sum_k omega_k, found, sampler)`` so that
    ``weight * f(t_sel)`` estimates int_0^maxt T(t) f(t) dt; the walk stops
    once W_k < w_min."""
    t = torch.zeros_like(maxt)
    W = torch.where(active, 1.0, 0.0).to(maxt.dtype)
    wsum = torch.zeros_like(maxt)
    t_sel = torch.zeros_like(maxt)
    ids = torch.nonzero(active).flatten()
    dim, it = sampler.dim, 0
    while ids.numel():
        o, d, tt, mx = ol[ids], dl[ids], t[ids], maxt[ids]
        sigma_maj, t_exit = _cell_exit(m, o, d, tt)
        u1 = wavefront_draw(sampler, dim, ids)
        u_res = wavefront_draw(sampler, (dim + 1) & 0xFFFFFFFF, ids)
        t_cand = tt + _free_step(sigma_maj, u1)
        collided = t_cand < torch.minimum(t_exit, mx)
        crossed = ~collided & (t_exit < mx)
        done_now = ~collided & (t_exit >= mx)
        sig, _ = _sigma_at(m, o, d, t_cand)
        Wi = W[ids]
        omega = torch.where(collided, Wi / torch.clamp(sigma_maj, min=1e-20), 0.0)
        wsum_new = wsum[ids] + omega
        take = collided & (u_res * wsum_new <= omega)
        t_sel[ids] = torch.where(take, t_cand, t_sel[ids])
        Wi = torch.where(collided, Wi * _ratio(sig, sigma_maj), Wi)
        W[ids] = Wi
        wsum[ids] = wsum_new
        t[ids] = torch.where(collided, t_cand, torch.where(crossed, t_exit, tt))
        walking = ~done_now & (Wi > w_min) & (it < max_steps)
        ids = ids[walking]
        dim, it = (dim + 2) & 0xFFFFFFFF, it + 1
    return t_sel, wsum, active & (wsum > 0.0), sampler._replace(dim=dim)
