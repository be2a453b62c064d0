"""The nested volumetric path tracer: configuration, resumable path state,
primal and path-replay adjoint with Differential Ratio Tracking.

Port of ``uivr_tpu/integrators/volpathsimple.py``, the reference-structured
engine (``engine="nested"``, the ``volpathsimple-drt-quadratic`` preset):
a bounce loop around delta-tracking free flights, NEE by ratio-tracked
shadow rays with power-heuristic MIS, and an adjoint that replays the
primal's draws, with the in-scattering gradient by the free-flight
estimator and/or DRT (on one reservoir-selected vertex per path, or on
every segment: ``use_drt_subsampling=False``), the transmittance gradient
by uniform samples along each segment and the NEE replay's gradient.  The
flat engine (``volpath_flat.py``) and the kernels reuse the configuration,
:class:`PathState`, :func:`_exit_dist`, :func:`_nee_primal` and the
reservoir.

All draws come from the wavefront :class:`Sampler`, whose counter is shared
by every lane: each loop runs as many iterations as the reference's (until
its longest walk ends) and takes every draw of its body, used or not, so a
lane's draws are the reference's.  An iteration computes only the lanes
still running, on the tensors' own device; it ends in one host sync, the
count of the lanes left (``tracking.trackers.WAVEFRONT`` counts them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import aabb
from ..core.fmath import ray_point
from ..core.rng import _M32, Sampler, fork, next_1d, next_2d
from ..scene.gradients import (GradAccum, finalize_accum, init_accum, scatter_sigma,
                               scatter_sigma_albedo)
from ..scene.medium import sigma_albedo_at
from ..scene.phase import phase_eval, phase_sample
from ..scene.scene import Scene
from ..tracking import drt_distance, free_flight, transmittance
from ..tracking.trackers import WAVEFRONT
from .common import mis_weight

# calls of the nested engine's entry points (recursive ones included)
CALLS = {"sample_primal": 0, "sample_adjoint": 0}


def _fused(cfg: "VolpathConfig"):
    """Which components of a collision point o + t d are one fused
    multiply-add: XLA's CPU build of the reference's nested engine fuses x
    and y, and z too when NEE is off (compared on the points of every
    bounce, primal, adjoint and the DRT term's; no other rule gives the
    reference's points for the same t)."""
    return (True, True, not cfg.use_nee)


@dataclass(frozen=True)
class VolpathConfig:
    max_depth: int = 64
    rr_depth: int = 1064          # > max_depth: Russian roulette off
    use_nee: bool = True
    use_drt: bool = True
    use_drt_subsampling: bool = True
    use_drt_mis: bool = True
    hide_emitters: bool = False
    max_steps: int = 4096         # tracking steps per lane
    trans_grad_samples: int = 4
    # Russian roulette on shadow-walk transmittance below this threshold
    # (0 = off); reuses the shadow lane's event draw.
    shadow_rr: float = 0.0
    # 'auto' / 'pallas' = the CUDA kernel on cuda tensors, the plain twin on
    # cpu tensors; 'flat' = the plain twin on any device; 'nested' = this
    # module's engine on the tensors' device.
    engine: str = "auto"


class PathState(NamedTuple):
    """Resumable mid-path state (local frame)."""
    active: torch.Tensor    # (n,) bool
    depth: torch.Tensor     # (n,) int32
    o_l: torch.Tensor       # (n,3)
    d_l: torch.Tensor       # (n,3)
    d_w: torch.Tensor       # (n,3)
    maxt: torch.Tensor      # (n,)
    last_pdf: torch.Tensor  # (n,)


def _exit_dist(o_l: torch.Tensor, d_l: torch.Tensor) -> torch.Tensor:
    """Distance to the unit-cube exit from a point inside (or on) it."""
    _, tf, _ = aabb.ray_unit_cube(o_l, d_l, 0.0, aabb.INF)
    return tf


def _nee_primal(cfg: VolpathConfig, scene: Scene, p, d_w, throughput,
                sampler: Sampler, active_e):
    """Primal NEE estimate from local points ``p`` with incident world
    direction ``d_w``: two draws for the emitter direction, then ratio
    tracking on the same wavefront sampler.  Returns
    ``(contrib (n,3), (dln, tmax, active_e), sampler)``."""
    m = scene.medium
    u2, sampler = next_2d(sampler)
    ds_d, ds_pdf, em_weight = scene.emitter.sample_direction(u2)
    active_e = active_e & (ds_pdf > 0.0)
    dln = aabb.transform_dirs(m.world_to_local, ds_d)
    tmax = _exit_dist(p, dln)
    tr, sampler = transmittance(m, p, dln, tmax, sampler, active_e,
                                max_steps=cfg.max_steps)
    ph = phase_eval(m.phase_g, d_w, ds_d)
    w = mis_weight(ds_pdf, ph)
    contrib = throughput * (ph * w * tr)[:, None] * em_weight
    contrib = torch.where(active_e[:, None], contrib, 0.0)
    return contrib, (dln, tmax, active_e), sampler


def _nee_adjoint_replay(cfg: VolpathConfig, scene: Scene, p, shadow_info,
                        nee_sampler: Sampler, adjoint, grads: GradAccum) -> GradAccum:
    """Replay the shadow walk of :func:`_nee_primal` with ``adjoint``,
    scattering its transmittance gradient.  ``nee_sampler`` is the sampler
    as the primal NEE received it: the replay skips the direction draws and
    walks on the same counters, for as many iterations."""
    dln, tmax, active_e = shadow_info
    _, _, grads = transmittance(scene.medium, p, dln, tmax, _skip(nee_sampler, 2),
                                active_e, max_steps=cfg.max_steps, adjoint=adjoint,
                                accum=grads)
    return grads


# --------------------------------------------------------------------------
# Sampler on a subset of the lanes
# --------------------------------------------------------------------------

def _sub(s: Sampler, ids: torch.Tensor) -> Sampler:
    """The sampler of lanes ``ids`` alone: each keeps its draws."""
    return Sampler(seed=s.seed, dim=s.dim, lanes=s.lanes[ids])


def _skip(s: Sampler, k: int) -> Sampler:
    """``s`` after ``k`` draws whose values no lane needs."""
    return s._replace(dim=(s.dim + k) & _M32)


def _at(s: Sampler, k: int) -> torch.Tensor:
    """Every lane's draw at counter ``s.dim + k`` (``s`` not advanced)."""
    return next_1d(_skip(s, k))[0]


# --------------------------------------------------------------------------
# Primal
# --------------------------------------------------------------------------

def _fresh_state(scene: Scene, o: torch.Tensor, d: torch.Tensor):
    """Camera rays onto the medium's box: the entry point and the segment
    to the exit; rays that miss escape directly.  Returns
    ``(PathState, escaped)``."""
    m = scene.medium
    ol = aabb.transform_points(m.world_to_local, o)
    dl = aabb.transform_dirs(m.world_to_local, d)
    tn, tf, hit = aabb.ray_unit_cube(ol, dl, 0.0, aabb.INF)
    active = hit & (tf > tn)
    st = PathState(
        active=active, depth=torch.zeros(tn.shape, dtype=torch.int32, device=tn.device),
        o_l=ray_point(ol, tn, dl, fused=(False, False, True)), d_l=dl, d_w=d.clone(),
        maxt=torch.where(active, tf - tn, 0.0), last_pdf=torch.ones_like(tn))
    return st, ~active


class _PrimalCarry(NamedTuple):
    st: PathState
    escaped: torch.Tensor
    throughput: torch.Tensor
    result: torch.Tensor
    has_scattered: torch.Tensor
    sampler: Sampler


def _roulette(cfg: VolpathConfig, st: PathState, throughput: torch.Tensor,
              ids: torch.Tensor, sampler: Sampler) -> torch.Tensor:
    """Russian roulette of the running lanes ``ids``: returns which keep
    walking (those with a nonzero throughput that survive).  Its draw is
    the sampler's next, taken whether or not roulette is on.  As in the
    reference, every lane past ``rr_depth`` (stopped ones too) has its
    throughput divided by its survival probability at every iteration;
    ``throughput`` is updated in place."""
    keep = (throughput[ids] != 0.0).any(dim=-1)
    if cfg.rr_depth < cfg.max_depth:   # otherwise no depth passes rr_depth
        perform = st.depth > cfg.rr_depth
        q = torch.clamp(throughput.amax(dim=-1), max=0.99)
        keep = keep & (~perform[ids] | (_at(_sub(sampler, ids), 0) < q[ids]))
        throughput.copy_(torch.where(perform[:, None],
                                     throughput / torch.clamp(q, min=1e-8)[:, None],
                                     throughput))
    return keep


def _next_direction(scene: Scene, st: PathState, ids, scat, p, sampler: Sampler) -> torch.Tensor:
    """Phase sampling at the collisions ``scat`` of lanes ``ids`` (three
    draws, the second unused): the new direction, origin, pdf and segment
    are written into ``st``.  Returns the new segment lengths."""
    m = scene.medium
    s = _sub(sampler, ids)
    wo, ph_pdf = phase_sample(m.phase_g, st.d_w[ids], _at(s, 0), _at(s, 2))
    sel = scat[:, None]
    d_l = torch.where(sel, aabb.transform_dirs(m.world_to_local, wo), st.d_l[ids])
    o_l = torch.where(sel, p, st.o_l[ids])
    tf = _exit_dist(o_l, d_l)
    st.d_w[ids] = torch.where(sel, wo, st.d_w[ids])
    st.d_l[ids] = d_l
    st.o_l[ids] = o_l
    st.last_pdf[ids] = torch.where(scat, ph_pdf, st.last_pdf[ids])
    st.maxt[ids] = torch.where(scat, tf, st.maxt[ids])
    return tf


def _primal_loop(cfg: VolpathConfig, scene: Scene, c: _PrimalCarry) -> _PrimalCarry:
    """The bounce loop, until no path is running; updates the carry's
    tensors in place."""
    m = scene.medium
    st, smp = c.st, c.sampler
    ids = torch.nonzero(st.active).flatten()
    while ids.numel():
        WAVEFRONT["iterations"] += 1
        keep = _roulette(cfg, st, c.throughput, ids, smp)
        smp = _skip(smp, 1)
        o_l, d_l = st.o_l[ids], st.d_l[ids]
        t_coll, found, s = free_flight(m, o_l, d_l, st.maxt[ids], _sub(smp, ids), keep,
                                       max_steps=cfg.max_steps)
        smp = smp._replace(dim=s.dim)
        scat = keep & found
        p = ray_point(o_l, torch.where(found, t_coll, 0.0), d_l, _fused(cfg))
        alb = torch.where(scat[:, None], sigma_albedo_at(m, p)[1], 1.0)
        thr = c.throughput[ids] * alb
        c.throughput[ids] = thr
        depth = torch.where(scat, st.depth[ids] + 1, st.depth[ids])
        st.depth[ids] = depth
        alive = scat & (depth < cfg.max_depth)
        c.has_scattered[ids] |= scat
        if cfg.use_nee:
            contrib, _, s = _nee_primal(cfg, scene, p, st.d_w[ids], thr, _sub(smp, ids), alive)
            smp = smp._replace(dim=s.dim)
            c.result[ids] += contrib
        tf = _next_direction(scene, st, ids, scat, p, smp)
        smp = _skip(smp, 3)
        c.escaped[ids] |= keep & ~found
        ids = ids[alive & (tf > 1e-7)]
    st.active.zero_()
    return c._replace(sampler=smp)


def _finish_primal(cfg: VolpathConfig, scene: Scene, c: _PrimalCarry) -> torch.Tensor:
    """The emitter seen by escaped paths, MIS-weighted against NEE."""
    active_e = c.escaped
    if cfg.hide_emitters:
        active_e = active_e & ~(c.st.depth <= 0)
    thr = c.throughput
    if cfg.use_nee:
        epdf = torch.where(c.has_scattered, scene.emitter.pdf_direction(c.st.d_w), 0.0)
        thr = thr * mis_weight(c.st.last_pdf, epdf)[:, None]
    contrib = thr * scene.emitter.eval(c.st.d_w)
    return c.result + torch.where(active_e[:, None], contrib, 0.0)


def sample_primal(cfg: VolpathConfig, scene: Scene, o: Optional[torch.Tensor],
                  d: Optional[torch.Tensor], sampler: Sampler,
                  path_state: Optional[PathState] = None):
    """Primal radiance of world rays ``o``, ``d`` (n, 3), or of the paths
    resumed from ``path_state`` (``o``, ``d`` unused).  Returns
    ``(L (n,3), escaped (n,), sampler)``."""
    CALLS["sample_primal"] += 1
    if path_state is None:
        sampler = _skip(sampler, 1)          # the reference's channel draw
        st, escaped = _fresh_state(scene, o, d)
        has_scattered = torch.zeros_like(st.active)
    else:
        st = PathState(*[x.clone() for x in path_state])
        escaped = torch.zeros_like(st.active)
        has_scattered = st.active.clone()
    sampler = _skip(sampler, 1)              # its alt-seed draw
    c = _PrimalCarry(st=st, escaped=escaped, throughput=torch.ones_like(st.o_l),
                     result=torch.zeros_like(st.o_l), has_scattered=has_scattered,
                     sampler=sampler)
    c = _primal_loop(cfg, scene, c)
    return _finish_primal(cfg, scene, c), c.escaped, c.sampler


# --------------------------------------------------------------------------
# Adjoint (path replay backpropagation)
# --------------------------------------------------------------------------

class _Reservoir(NamedTuple):
    """Per-lane reservoir over path vertices for DRT subsampling: one
    vertex is kept with probability proportional to its throughput."""
    wsum: torch.Tensor      # (n,3)
    cur_w: torch.Tensor     # (n,3)
    depth: torch.Tensor     # (n,) int32
    o_l: torch.Tensor       # (n,3) segment origin
    d_l: torch.Tensor       # (n,3)
    d_w: torch.Tensor       # (n,3)
    maxt: torch.Tensor      # (n,)
    active: torch.Tensor    # (n,) bool


def _mean3(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis of (n, 3), summed left to right (the CUDA
    kernels repeat this order)."""
    return ((x[:, 0] + x[:, 1]) + x[:, 2]) / 3.0


def _reservoir_init(ref3: torch.Tensor) -> _Reservoir:
    """Empty reservoirs shaped like the (n, 3) tensor ``ref3``."""
    def z3():
        return torch.zeros_like(ref3)
    z1 = torch.zeros_like(ref3[:, 0])
    return _Reservoir(wsum=z3(), cur_w=z3(),
                      depth=torch.full_like(z1, -1, dtype=torch.int32),
                      o_l=z3(), d_l=z3(), d_w=z3(), maxt=z1,
                      active=torch.zeros_like(z1, dtype=torch.bool))


def _reservoir_update(r: _Reservoir, weight, u, active, depth, o_l, d_l, d_w,
                      maxt) -> _Reservoir:
    w = torch.where(active[:, None], weight, 0.0)
    wsum = r.wsum + w
    ratio = _mean3(torch.where(wsum > 0, w / torch.clamp(wsum, min=1e-30), 0.0))
    change = active & (u <= ratio)
    sel = change[:, None]
    return _Reservoir(
        wsum=wsum,
        cur_w=torch.where(sel, w, r.cur_w),
        depth=torch.where(change, depth, r.depth),
        o_l=torch.where(sel, o_l, r.o_l),
        d_l=torch.where(sel, d_l, r.d_l),
        d_w=torch.where(sel, d_w, r.d_w),
        maxt=torch.where(change, maxt, r.maxt),
        active=r.active | change)


def _reservoir_get(r: _Reservoir) -> torch.Tensor:
    """The kept vertex's sampling weight (n, 3): mean(wsum) cur_w / mean(cur_w)."""
    d = _mean3(r.cur_w)
    w = _mean3(r.wsum)[:, None] * r.cur_w / torch.clamp(d, min=1e-30)[:, None]
    return torch.where((d > 0)[:, None], w, 0.0)


def _drt_backward(cfg: VolpathConfig, scene: Scene, alt: Sampler, o_l, d_l, d_w, maxt,
                  depth, adjoint, active, grads: GradAccum):
    """In-scattering gradient by Differential Ratio Tracking along the
    segments ``o_l + t d_l``, t < ``maxt``: a distance drawn in proportion
    to transmittance, a detached incident radiance there (NEE and a
    recursive path resumed from it) and the sigma_t and albedo cotangents
    at that point.  Returns ``(grads, alt)``."""
    m = scene.medium
    t_sub, w_drt, found, alt = drt_distance(m, o_l, d_l, maxt, alt, active,
                                            max_steps=cfg.max_steps)
    active = active & found
    p = ray_point(o_l, torch.where(found, t_sub, 0.0), d_l, _fused(cfg))
    Li = torch.zeros_like(adjoint)
    if cfg.use_nee:
        nee, _, alt = _nee_primal(cfg, scene, p, d_w, torch.ones_like(adjoint), alt, active)
        Li = Li + nee
    wo, ph_pdf = phase_sample(m.phase_g, d_w, _at(alt, 0), _at(alt, 2))
    alt = _skip(alt, 3)
    rec_dl = aabb.transform_dirs(m.world_to_local, wo)
    rec_maxt = _exit_dist(p, rec_dl)
    next_depth = torch.where(active, depth + 1, depth)
    ps = PathState(
        active=active & (next_depth < cfg.max_depth) & (rec_maxt > 1e-7),
        depth=next_depth, o_l=p, d_l=rec_dl, d_w=wo, maxt=rec_maxt,
        last_pdf=torch.where(active, ph_pdf, 1.0))
    rec_Li, _, alt = sample_primal(cfg, scene, None, None, alt, path_state=ps)
    Li = Li + rec_Li
    sig, alb = sigma_albedo_at(m, p)
    w_mis = 1.0 / (1.0 + sig * sig) if cfg.use_drt_mis else torch.ones_like(sig)
    factor = (w_mis * w_drt)[:, None] * adjoint * Li
    fa = factor * alb
    scatter_sigma_albedo(grads, m, p, (fa[:, 0] + fa[:, 1]) + fa[:, 2],
                         factor * sig[:, None], active)
    return grads, alt


def sample_adjoint(cfg: VolpathConfig, scene: Scene, o: torch.Tensor, d: torch.Tensor,
                   sampler: Sampler, dL: torch.Tensor, state_in: torch.Tensor,
                   grads: Optional[GradAccum] = None):
    """Path-replay adjoint of world rays ``o``, ``d`` with per-ray adjoint
    radiance ``dL`` (n, 3) and the detached primal radiance ``state_in``
    (n, 3).  ``sampler`` replays the primal's stream (the same seed).
    Returns ``(MediumParams of gradients, sampler)`` (zero emission)."""
    CALLS["sample_adjoint"] += 1
    m = scene.medium
    sampler = _skip(sampler, 1)              # channel draw
    st, escaped = _fresh_state(scene, o, d)
    sampler = _skip(sampler, 1)              # alt-seed draw
    alt = fork(sampler, 0x9E3779B9)
    throughput = torch.ones_like(st.o_l)
    result = state_in.clone()
    has_scattered = torch.zeros_like(st.active)
    res = _reservoir_init(torch.zeros_like(st.o_l))
    if grads is None:
        grads = init_accum(m, need_emission=False)
    subsample = cfg.use_drt and cfg.use_drt_subsampling
    ids = torch.nonzero(st.active).flatten()
    while ids.numel():
        WAVEFRONT["iterations"] += 1
        keep = _roulette(cfg, st, throughput, ids, sampler)
        sampler = _skip(sampler, 1)
        o_l, d_l, d_w, maxt, depth0 = (st.o_l[ids], st.d_l[ids], st.d_w[ids],
                                       st.maxt[ids], st.depth[ids])
        t_coll, found, s = free_flight(m, o_l, d_l, maxt, _sub(sampler, ids), keep,
                                       max_steps=cfg.max_steps)
        sampler = sampler._replace(dim=s.dim)
        scat, esc = keep & found, keep & ~found
        t_safe = torch.where(found, t_coll, 0.0)
        p = ray_point(o_l, t_safe, d_l, _fused(cfg))
        sig, alb = sigma_albedo_at(m, p)
        alb = torch.where(scat[:, None], alb, 1.0)
        thr, dLi, res_i = throughput[ids], dL[ids], result[ids]

        # in-scattering gradients along the segment (escape segments too)
        if subsample:
            r = _Reservoir(*[f[ids] for f in res])
            r = _reservoir_update(r, thr, _at(_sub(alt, ids), 0), keep, depth0, o_l, d_l,
                                  d_w, maxt)
            alt = _skip(alt, 1)
            for full, part in zip(res, r):
                full[ids] = part
        elif cfg.use_drt:
            grads, a = _drt_backward(cfg, scene, _sub(alt, ids), o_l, d_l, d_w, maxt, depth0,
                                     dLi * thr, keep, grads)
            alt = alt._replace(dim=a.dim)
        if (not cfg.use_drt) or cfg.use_drt_mis:
            # free-flight estimator; with DRT its MIS weight times 1/sigma_t
            if cfg.use_drt:
                wf = sig / (1.0 + sig * sig)
            else:
                wf = 1.0 / torch.clamp(sig, min=1e-8)
            base = dLi * (res_i / torch.clamp(alb, min=1e-8)) * wf[:, None]
            ba = base * alb
            scatter_sigma_albedo(grads, m, p, (ba[:, 0] + ba[:, 1]) + ba[:, 2],
                                 base * sig[:, None], scat)

        # transmittance gradients: uniform samples along the segment
        interval = torch.where(esc, maxt, t_safe)
        dr = dLi * res_i
        adj_w = (dr[:, 0] + dr[:, 1]) + dr[:, 2]
        inv_pdf = interval / float(cfg.trans_grad_samples)
        for _ in range(cfg.trans_grad_samples):
            t_s = _at(_sub(alt, ids), 0) * interval
            alt = _skip(alt, 1)
            scatter_sigma(grads, m, o_l + t_s[:, None] * d_l, -adj_w * inv_pdf, keep)

        thr = thr * alb
        throughput[ids] = thr
        depth = torch.where(scat, depth0 + 1, depth0)
        st.depth[ids] = depth
        alive = scat & (depth < cfg.max_depth)
        has_scattered[ids] |= scat

        # NEE: the primal's contribution leaves the state (PRB), and its
        # shadow walk is replayed with the contribution's adjoint
        if cfg.use_nee:
            nee_s = _sub(sampler, ids)
            contrib, info, s = _nee_primal(cfg, scene, p, d_w, thr, nee_s, alive)
            sampler = sampler._replace(dim=s.dim)
            result[ids] = res_i - contrib
            grads = _nee_adjoint_replay(cfg, scene, p, info, nee_s, dLi * contrib, grads)

        tf = _next_direction(scene, st, ids, scat, p, sampler)
        sampler = _skip(sampler, 3)
        escaped[ids] |= esc
        ids = ids[alive & (tf > 1e-7)]

    if subsample:
        # the delayed DRT term on each path's kept vertex
        ids = torch.nonzero(res.active).flatten()
        if ids.numel():
            r = _Reservoir(*[f[ids] for f in res])
            grads, _ = _drt_backward(cfg, scene, _sub(alt, ids), r.o_l, r.d_l, r.d_w,
                                     r.maxt, r.depth, _reservoir_get(r) * dL[ids],
                                     r.active, grads)
    return finalize_accum(grads, m), sampler
