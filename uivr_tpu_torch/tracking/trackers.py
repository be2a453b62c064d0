"""Wavefront tracking loops on the global-counter sampler.

Port of ``uivr_tpu/tracking/trackers.py``: :func:`free_flight` (delta
tracking to the next real collision), :func:`transmittance` (ratio
tracking, with the in-loop adjoint scatter of its gradient when given an
``adjoint``) and :func:`drt_distance` (transmittance-proportional distance
sampling of Differential Ratio Tracking).  The nested engine
(``integrators/volpathsimple.py``) runs all three; the flat engine's
delayed DRT term (``integrators/volpath_flat._drt_backward_flat``) runs
the last two, and the CUDA kernels ``ops/csrc/volpath_drt.cu`` repeat them
per lane.

Their draws come from a :class:`Sampler` whose counter is shared by the
whole wavefront: every iteration takes its draws at the same ``dim`` for
every lane, and the loop runs until the longest walk ends.  So a lane's
k-th step draws at ``dim0 + draws_per_iteration * k`` and the sampler
leaves the loop at ``dim0 + draws_per_iteration * max_trips``.  Each
iteration here steps only the walks still running; the draws are hashes of
(seed, dim, lane), so this gives the reference's values.  Each iteration
ends in one host sync, the count of the walks still running; ``WAVEFRONT``
counts the iterations.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..core import fmath
from ..core.fmath import ray_point
from ..core.rng import Sampler, _to_unit_float, tea, tea_plain
from ..scene.gradients import GradAccum, scatter_sigma
from ..scene.medium import Medium, sigma_albedo_at

_BIG = 1e30
# wavefront iterations of every loop here and in the nested engine's bounce
# loops: each one ends in a host sync
WAVEFRONT = {"iterations": 0}


def _cell_exit(m: Medium, ol: torch.Tensor, dl: torch.Tensor,
               t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma_maj, t_exit): the supercell majorant at parameter ``t`` and
    the parameter at which the ray leaves that supercell (at least
    ``t + eps``, so a walk always advances)."""
    res, top = _majorant_res(tuple(m.majorant_grid.shape), ol.device)
    t_eps = t + 1e-5 * (1.0 + t.abs())
    p = ray_point(ol, t_eps, dl)
    cell = torch.minimum(
        torch.clamp(torch.floor(torch.clamp(p, 0.0, 1.0 - 1e-7) * res), min=0.0), top)
    ci = cell.to(torch.int64)
    sigma_maj = m.majorant_grid[ci[:, 2], ci[:, 1], ci[:, 0]]
    lo = cell / res
    hi = (cell + 1.0) / res
    tiny = torch.where(dl >= 0, 1e-20, -1e-20).to(dl.dtype)
    safe_d = torch.where(dl.abs() < 1e-20, tiny, dl)
    t_hi = torch.maximum((lo - ol) / safe_d, (hi - ol) / safe_d)
    t_exit = torch.minimum(torch.minimum(t_hi[:, 0], t_hi[:, 1]), t_hi[:, 2])
    return sigma_maj, torch.maximum(t_exit, t_eps)


@functools.lru_cache(maxsize=None)
def _majorant_res(shape, device):
    """(W, H, D) of a majorant grid and its last cell index, float32 on
    ``device``, made once (a copy from the host would wait for the device
    at every step)."""
    Dc, Hc, Wc = shape
    res = torch.tensor([Wc, Hc, Dc], dtype=torch.float32, device=device)
    return res, res - 1.0


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


def free_flight(m: Medium, ol: torch.Tensor, dl: torch.Tensor,
                maxt: torch.Tensor, sampler: Sampler, active: torch.Tensor,
                max_steps: int = 4096):
    """Distance to the next real collision by delta tracking: two draws per
    iteration.  Returns ``(t, found, sampler)``: ``found`` lanes collided
    at ``t``; the others escaped past ``maxt`` or were inactive, with
    ``t = inf``."""
    t = torch.zeros_like(maxt)
    found = torch.zeros_like(active)
    ids = torch.nonzero(active).flatten()
    dim, it = sampler.dim, 0
    while ids.numel():
        o, d, tt, mx = ol[ids], dl[ids], t[ids], maxt[ids]
        sigma_maj, t_exit = _cell_exit(m, o, d, tt)
        u1 = wavefront_draw(sampler, dim, ids)
        u2 = wavefront_draw(sampler, (dim + 1) & 0xFFFFFFFF, ids)
        t_cand = tt + _free_step(sigma_maj, u1)
        collided = t_cand < torch.minimum(t_exit, mx)
        escaped_now = ~collided & (t_exit >= mx)
        crossed = ~collided & (t_exit < mx)
        sig, _ = _sigma_at(m, o, d, t_cand)
        r = torch.where(sigma_maj > 0.0, sig / torch.clamp(sigma_maj, min=1e-20), 0.0)
        real = collided & (u2 < r)
        t[ids] = torch.where(collided, t_cand, torch.where(crossed, t_exit, tt))
        found[ids] = real
        ids = ids[~escaped_now & ~real & (it < max_steps)]
        dim, it = (dim + 2) & 0xFFFFFFFF, it + 1
    WAVEFRONT["iterations"] += it
    return torch.where(found, t, torch.inf), found, sampler._replace(dim=dim)


def transmittance(m: Medium, ol: torch.Tensor, dl: torch.Tensor,
                  tmax: torch.Tensor, sampler: Sampler, active: torch.Tensor,
                  max_steps: int = 4096, adjoint: torch.Tensor = None,
                  accum: GradAccum = None):
    """Ratio-tracking transmittance over [0, tmax] along local rays: one
    draw per iteration.  Returns ``(Tr (n,), sampler)``; Tr = 0 on inactive
    lanes.  With ``adjoint`` (n, 3) it also scatters the transmittance's
    gradient into ``accum`` (in place) and returns ``(Tr, sampler,
    accum)``: each null collision's factor sigma_n / sigma_maj takes the
    cotangent -sum(adjoint) / sigma_n on sigma_t at its point."""
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
        sig, p = _sigma_at(m, o, d, t_cand)
        ratio = _ratio(sig, sigma_maj)
        if adjoint is not None:
            a = adjoint[ids]
            cot = -((a[:, 0] + a[:, 1]) + a[:, 2]) / torch.clamp(sigma_maj - sig, min=1e-8)
            scatter_sigma(accum, m, p, cot, collided & (ratio > 0.0))
        tri = torch.where(collided, tr[ids] * ratio, tr[ids])
        tr[ids] = tri
        t[ids] = torch.where(collided, t_cand, torch.where(crossed, t_exit, tt))
        walking = ~done_now & (tri > 0.0) & (it < max_steps)
        ids = ids[walking]
        dim, it = (dim + 1) & 0xFFFFFFFF, it + 1
    WAVEFRONT["iterations"] += it
    if adjoint is not None:
        return tr, sampler._replace(dim=dim), accum
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
    WAVEFRONT["iterations"] += it
    return t_sel, wsum, active & (wsum > 0.0), sampler._replace(dim=dim)
