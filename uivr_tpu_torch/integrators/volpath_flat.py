"""Flattened volumetric path tracer: the plain PyTorch twin of the CUDA
path-tracing kernels (``ops/csrc/volpath_primal.cu``,
``ops/csrc/volpath_adjoint.cu``, ``ops/csrc/volpath_drt.cu``), the
primal's K-candidate batching (K7, ``k_cand > 1``) included.

Port of ``uivr_tpu/integrators/volpath_flat.py`` (``_cell_step``,
``_init_carry``, ``_flat_step``, ``_finish``, ``sample_primal``,
``sample_adjoint`` and ``_drt_backward_flat``), with the deferred-radiance
NEE of the reference's step kernel (``deferred``, K3b): on an envmap with a
coarse ``nee`` proxy, NEE samples the proxy and multiplies in the
full-resolution radiance (``emitters.sample_deferred``), and escapes are
weighed with the proxy's pdf.  The kernels take that mode whenever the
emitter has a proxy; ``deferred=False`` (the default, the reference's flat
engine) samples the full-resolution map.  Every lane advances one
majorant-tracking step per iteration and switches between walk modes:

    MAIN    delta-track the camera/bounce ray to its next real collision
    SHADOW  ratio-track an NEE shadow ray (transmittance)
    REPLAY  (adjoint only) re-walk the shadow ray with the completed
            contribution as adjoint, scattering transmittance gradients
    DONE    terminated

Lanes are independent (per-lane RNG counters), so each iteration steps only
the lanes still walking; this stands in for the reference's compaction
rounds (``_run_rounds``) and gives the same per-lane results.  Every lane
is bounded by ``max_iters`` steps: in the primal the reference's 100,000
(the kernels and their plain version stop at ``cfg.max_steps``), in the
adjoint ``3 * max_steps``, as it interleaves three walks.

The kernels repeat this arithmetic operation for operation, so the order of
every sum and product here is part of the contract: transforms, dot
products and norms are written out, and constants divide as tensors.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from ..core import aabb
from ..core import fmath
from ..core.fmath import ray_point
from ..core.rng import (_DRAW_ROUNDS, _M32, LaneSampler, _to_unit_float,
                        lane_fork, lane_next_1d, make_lane_sampler,
                        make_sampler, next_1d, next_2d, sample_tea_32, tea)
from ..scene.gradients import (GradAccum, finalize_accum, init_accum,
                               scatter_sigma, scatter_sigma_albedo)
from ..scene.emitters import sample_deferred
from ..scene.medium import sigma_albedo_at
from ..scene.phase import phase_eval, phase_sample
from ..scene.scene import Scene
from ..tracking import drt_distance
from ..tracking.trackers import _cell_exit as _cell_step
from .common import mis_weight
from .volpathsimple import (PathState, VolpathConfig, _exit_dist,
                            _nee_primal, _Reservoir, _reservoir_get,
                            _reservoir_init, _reservoir_update)

DONE, MAIN, SHADOW, REPLAY = 0, 1, 2, 3
_BIG = 1e30

# calls of the plain twins, so a run can show that its main path went
# through the kernels instead
CALLS = {"volpath_primal": 0, "volpath_adjoint": 0, "volpath_drt": 0}


class _FlatCarry(NamedTuple):
    mode: torch.Tensor           # (n,) int32
    o_l: torch.Tensor            # (n,3) segment origin (local)
    d_l: torch.Tensor            # (n,3)
    d_w: torch.Tensor            # (n,3)
    t: torch.Tensor              # (n,) walk parameter along the main segment
    maxt: torch.Tensor           # (n,)
    depth: torch.Tensor          # (n,) int32
    throughput: torch.Tensor     # (n,3)
    result: torch.Tensor         # (n,3)
    escaped: torch.Tensor        # (n,) bool
    has_scattered: torch.Tensor  # (n,) bool
    last_pdf: torch.Tensor       # (n,)
    post_mode: torch.Tensor      # (n,) int32, mode to resume after a shadow walk
    sh_d: torch.Tensor           # (n,3) shadow direction (local)
    sh_t: torch.Tensor           # (n,)
    sh_tmax: torch.Tensor        # (n,)
    sh_tr: torch.Tensor          # (n,)
    sh_base: torch.Tensor        # (n,3) contribution without transmittance
    smp: LaneSampler
    steps: torch.Tensor          # (n,) int32 tracking steps taken


class _StepEvents(NamedTuple):
    """Per-step event data the adjoint consumes."""
    p: torch.Tensor              # (n,3) candidate collision point
    sig: torch.Tensor            # (n,)
    sigma_maj: torch.Tensor      # (n,)
    ratio: torch.Tensor          # (n,)
    collided: torch.Tensor       # (n,)
    fin_seg: torch.Tensor        # (n,)
    t_next: torch.Tensor         # (n,)
    t_cand: torch.Tensor         # (n,)
    real: torch.Tensor           # (n,)
    scat: torch.Tensor           # (n,)
    m_escape: torch.Tensor       # (n,)
    sh_done: torch.Tensor        # (n,)
    contrib: torch.Tensor        # (n,3) completed NEE contribution
    alb: torch.Tensor            # (n,3)
    thr_pre: torch.Tensor        # (n,3) throughput before the albedo
    is_rp: torch.Tensor          # (n,)
    u_evt: torch.Tensor          # (n,) event draw (the replay's shadow RR)


def _init_carry(scene: Scene, o, d, smp: LaneSampler,
                path_state: Optional[PathState] = None) -> _FlatCarry:
    m = scene.medium
    if path_state is None:
        ol = aabb.transform_points(m.world_to_local, o)
        dl = aabb.transform_dirs(m.world_to_local, d)
        tn, tf, hit = aabb.ray_unit_cube(ol, dl, 0.0, aabb.INF)
        active = hit & (tf > tn)
        st = PathState(
            active=active, depth=torch.zeros(tn.shape, dtype=torch.int32,
                                             device=tn.device),
            o_l=ray_point(ol, tn, dl, fused=(False, False, True)), d_l=dl,
            d_w=d.clone(), maxt=torch.where(active, tf - tn, 0.0),
            last_pdf=torch.ones_like(tn))
        escaped = ~active
        has_scattered = torch.zeros_like(active)
    else:
        # every field gets its own storage: the loops update them in place
        st = PathState(*[x.clone() for x in path_state])
        escaped = torch.zeros_like(st.active)
        has_scattered = st.active.clone()

    def z1():
        return torch.zeros_like(st.maxt)

    def z3():
        return torch.zeros_like(st.o_l)

    def zi():
        return torch.zeros(st.maxt.shape, dtype=torch.int32, device=st.maxt.device)

    return _FlatCarry(
        mode=torch.where(st.active, MAIN, DONE).to(torch.int32),
        o_l=st.o_l, d_l=st.d_l, d_w=st.d_w, t=z1(), maxt=st.maxt,
        depth=st.depth.to(torch.int32), throughput=z3() + 1.0, result=z3(),
        escaped=escaped, has_scattered=has_scattered, last_pdf=st.last_pdf,
        post_mode=zi() + MAIN, sh_d=z3(), sh_t=z1(), sh_tmax=z1(),
        sh_tr=z1(), sh_base=z3(), smp=smp, steps=zi())


def _nee_proxy(scene: Scene, deferred: bool):
    """The coarse proxy NEE samples in deferred mode, or None."""
    return getattr(scene.emitter, "nee", None) if deferred else None


def _flat_step(cfg: VolpathConfig, scene: Scene, c: _FlatCarry,
               rp_dim=None, rp_t=None, deferred: bool = False):
    """One tracking step for every lane of ``c``; returns the new carry and
    the step's events.  In the adjoint (``rp_dim`` given) REPLAY lanes walk
    the shadow ray again from ``rp_t`` with the draws at the restored
    counter ``rp_dim``, and a completed shadow walk neither adds its
    contribution nor changes mode: the adjoint body does both.
    ``deferred``: NEE samples the emitter's proxy where it has one (K3b)."""
    m = scene.medium
    is_adj = rp_dim is not None
    mode = c.mode
    is_main = mode == MAIN
    is_sh = mode == SHADOW
    is_rp = mode == REPLAY if is_adj else torch.zeros_like(is_main)
    walking = is_main | is_sh | is_rp

    wd = torch.where(is_main[:, None], c.d_l, c.sh_d)
    wt = torch.where(is_main, c.t, c.sh_t)
    wmax = torch.where(is_main, c.maxt, c.sh_tmax)
    if is_adj:
        wt = torch.where(is_rp, rp_t, wt)
    sigma_maj, t_exit = _cell_step(m, c.o_l, wd, wt)

    # MAIN and SHADOW consume the primary stream; REPLAY re-reads the
    # shadow walk's draws at the restored counter
    smp = c.smp
    consume = is_main | is_sh
    u_step, smp = lane_next_1d(smp, consume=consume)
    u_evt, smp = lane_next_1d(smp, consume=consume)
    if is_adj:
        b1, _ = tea(smp.h, rp_dim, rounds=_DRAW_ROUNDS)
        b2, _ = tea(smp.h, (rp_dim + 1) & _M32, rounds=_DRAW_ROUNDS)
        u_step = torch.where(is_rp, _to_unit_float(b1), u_step)
        u_evt = torch.where(is_rp, _to_unit_float(b2), u_evt)

    t_cand = wt + _free_step(sigma_maj, u_step)
    p = ray_point(c.o_l, t_cand, wd)
    sig, alb = sigma_albedo_at(m, p)
    return _event_effect(cfg, scene, c, smp, walking, is_rp, wt, wmax, t_cand, t_exit,
                         sigma_maj, u_evt, p, sig, alb, c.sh_tr, is_adj, deferred)


def _free_step(sigma_maj, u_step):
    """Distance of a free-flight step against majorant ``sigma_maj``."""
    return torch.where(sigma_maj > 0.0,
                       -fmath.log1p(-u_step) / torch.clamp(sigma_maj, min=1e-20),
                       _BIG)


def _event_effect(cfg: VolpathConfig, scene: Scene, c: _FlatCarry, smp: LaneSampler,
                  walking, is_rp, wt, wmax, t_cand, t_exit, sigma_maj, u_evt, p, sig,
                  alb, sh_tr_in, is_adj: bool, deferred: bool):
    """What one tracking event at ``t_cand`` (walk position ``wt``, cell
    exit ``t_exit``, sigma and albedo ``sig``, ``alb`` at ``p``) does to the
    lanes of ``c``, whose shadow transmittance before it is ``sh_tr_in``;
    ``smp`` holds the event's draws.  Returns the new carry and the
    event's data."""
    m = scene.medium
    mode = c.mode
    is_main = mode == MAIN
    is_sh = mode == SHADOW
    bound = torch.minimum(t_exit, wmax)
    collided = walking & (t_cand < bound)
    fin_seg = walking & ~collided & (t_exit >= wmax)
    crossed = walking & ~collided & (t_exit < wmax)
    t_next = torch.where(collided, t_cand, torch.where(crossed, t_exit, wt))

    r = torch.where(sigma_maj > 0.0, sig / torch.clamp(sigma_maj, min=1e-20), 0.0)
    ratio = torch.clamp(1.0 - r, min=0.0)

    # ---- SHADOW walk (ratio tracking)
    sh_coll = is_sh & collided
    sh_tr = torch.where(sh_coll, sh_tr_in * ratio, sh_tr_in)
    if cfg.shadow_rr > 0.0:
        tail = sh_coll & (sh_tr < cfg.shadow_rr) & (sh_tr > 0.0)
        q_sh = sh_tr * (1.0 / cfg.shadow_rr)
        sh_tr = torch.where(tail, torch.where(u_evt < q_sh, cfg.shadow_rr, 0.0),
                            sh_tr)
    sh_t = torch.where(is_sh, t_next, c.sh_t)
    sh_done = is_sh & (fin_seg | (sh_tr <= 0.0))
    contrib = c.sh_base * sh_tr[:, None]
    result = c.result
    if not is_adj:
        result = result + torch.where(sh_done[:, None], contrib, 0.0)
        mode = torch.where(sh_done, c.post_mode, mode)

    # ---- MAIN walk (delta tracking)
    real = is_main & collided & (u_evt < r)
    m_escape = is_main & fin_seg
    t = torch.where(is_main, t_next, c.t)
    escaped = c.escaped | m_escape
    mode = torch.where(m_escape, DONE, mode)

    thr_pre = c.throughput
    throughput = torch.where(real[:, None], c.throughput * alb, c.throughput)
    depth = torch.where(real, c.depth + 1, c.depth)
    die_depth = real & (depth >= cfg.max_depth)
    mode = torch.where(die_depth, DONE, mode)
    scat = real & ~die_depth

    # Russian roulette past rr_depth; the draw is taken on every real
    # collision even when RR is off
    u_rr, smp = lane_next_1d(smp, consume=real)
    perform_rr = scat & (depth > cfg.rr_depth)
    q = torch.clamp(throughput.amax(dim=-1), max=0.99)
    rr_dead = perform_rr & (u_rr >= q)
    throughput = torch.where(perform_rr[:, None],
                             throughput / torch.clamp(q, min=1e-8)[:, None],
                             throughput)
    mode = torch.where(rr_dead, DONE, mode)
    scat = scat & ~rr_dead

    # ---- phase sampling of the continuation direction
    u_p1, smp = lane_next_1d(smp, consume=scat)
    u_p2, smp = lane_next_1d(smp, consume=scat)
    wo_w, ph_pdf = phase_sample(m.phase_g, c.d_w, u_p1, u_p2)
    d_w = torch.where(scat[:, None], wo_w, c.d_w)
    d_l = torch.where(scat[:, None], aabb.transform_dirs(m.world_to_local, wo_w),
                      c.d_l)
    last_pdf = torch.where(scat, ph_pdf, c.last_pdf)
    has_scattered = c.has_scattered | scat

    o_l = torch.where(scat[:, None], p, c.o_l)
    cont_maxt = _exit_dist(o_l, d_l)
    maxt = torch.where(scat, cont_maxt, c.maxt)
    t = torch.where(scat, 0.0, t)
    acc_escape = scat & (cont_maxt <= 1e-7)   # ends the lane, not an escape
    resume_mode = torch.where(acc_escape, DONE, MAIN).to(torch.int32)

    # ---- NEE setup: sample the emitter; the shadow walk follows
    if cfg.use_nee:
        u_e1, smp = lane_next_1d(smp, consume=scat)
        u_e2, smp = lane_next_1d(smp, consume=scat)
        u_e = torch.stack([u_e1, u_e2], dim=-1)
        k3b = _nee_proxy(scene, deferred) is not None
        if k3b:
            ds_d, ds_pdf, inv_pdf, rad = sample_deferred(scene.emitter, u_e)
        else:
            ds_d, ds_pdf, em_w = scene.emitter.sample_direction(u_e)
        nee_ok = scat & (ds_pdf > 0.0)
        phv = phase_eval(m.phase_g, c.d_w, ds_d)   # incident direction
        wmis = mis_weight(ds_pdf, phv)
        sh_d_new = aabb.transform_dirs(m.world_to_local, ds_d)
        sh_tmax_new = _exit_dist(o_l, sh_d_new)
        if k3b:
            # 1/pdf first, then the radiance: two roundings, as the
            # reference kernel's fix-up multiplies the radiance in later
            base_new = throughput * (phv * wmis)[:, None] * inv_pdf[:, None] * rad
        else:
            base_new = throughput * (phv * wmis)[:, None] * em_w

        sh_d = torch.where(nee_ok[:, None], sh_d_new, c.sh_d)
        sh_tmax = torch.where(nee_ok, sh_tmax_new, c.sh_tmax)
        sh_base = torch.where(nee_ok[:, None], base_new, c.sh_base)
        sh_t = torch.where(nee_ok, 0.0, sh_t)
        sh_tr = torch.where(nee_ok, 1.0, sh_tr)
        post_mode = torch.where(scat, resume_mode, c.post_mode)
        mode = torch.where(nee_ok, SHADOW,
                           torch.where(scat & ~nee_ok, resume_mode, mode))
    else:
        sh_d, sh_tmax, sh_base, post_mode = (c.sh_d, c.sh_tmax, c.sh_base,
                                             c.post_mode)
        mode = torch.where(scat, resume_mode, mode)

    out = _FlatCarry(
        mode=mode.to(torch.int32), o_l=o_l, d_l=d_l, d_w=d_w, t=t, maxt=maxt,
        depth=depth, throughput=throughput, result=result, escaped=escaped,
        has_scattered=has_scattered, last_pdf=last_pdf, post_mode=post_mode,
        sh_d=sh_d, sh_t=sh_t, sh_tmax=sh_tmax, sh_tr=sh_tr, sh_base=sh_base,
        smp=smp, steps=c.steps + walking.to(torch.int32))
    ev = _StepEvents(p=p, sig=sig, sigma_maj=sigma_maj, ratio=ratio,
                     collided=collided, fin_seg=fin_seg, t_next=t_next,
                     t_cand=t_cand, real=real, scat=scat, m_escape=m_escape,
                     sh_done=sh_done, contrib=contrib, alb=alb,
                     thr_pre=thr_pre, is_rp=is_rp, u_evt=u_evt)
    return out, ev


def _finish(cfg: VolpathConfig, scene: Scene, c: _FlatCarry,
            nee_emitter=None) -> torch.Tensor:
    """Emitter contribution on escape, MIS-weighted against NEE.
    ``nee_emitter``: the emitter whose pdf NEE sampled (the proxy in
    deferred mode); the radiance is the full-resolution emitter's."""
    active_e = c.escaped
    if cfg.hide_emitters:
        active_e = active_e & ~(c.depth <= 0)
    if cfg.use_nee:
        epdf = (nee_emitter or scene.emitter).pdf_direction(c.d_w)
        epdf = torch.where(c.has_scattered, epdf, 0.0)
        w = mis_weight(c.last_pdf, epdf)[:, None]
        contrib = c.throughput * w * scene.emitter.eval(c.d_w)
    else:
        contrib = c.throughput * scene.emitter.eval(c.d_w)
    return c.result + torch.where(active_e[:, None], contrib, 0.0)


def _take(x, idx: torch.Tensor):
    """The lanes ``idx`` of a (nested) carry of per-lane tensors."""
    if isinstance(x, tuple):
        return type(x)(*[_take(f, idx) for f in x])
    return x[idx]


def _put(full, sub, idx: torch.Tensor) -> None:
    """Write the lanes of ``sub`` into ``full`` at ``idx`` (in place: the
    full carries are private to the loops below)."""
    if isinstance(full, tuple):
        for f, s in zip(full, sub):
            _put(f, s, idx)
    else:
        full[idx] = sub


def _run_lanes(step, full, live_of, mode_of):
    """Step the lanes of ``full`` that ``live_of`` keeps live until none is
    left (exact: lanes are independent).  Finished lanes are set to DONE,
    which every step leaves untouched, and are dropped from the stepped set
    once a quarter of it has finished; ``mode_of`` gives a carry's modes."""
    ids = torch.nonzero(live_of(full)).flatten()
    sub = _take(full, ids)
    while ids.numel():
        sub = step(sub)
        live = live_of(sub)
        n_live = int(live.sum())
        if n_live == live.numel():
            continue
        mode_of(sub).masked_fill_(~live, DONE)
        if n_live <= 3 * live.numel() // 4:
            fin = torch.nonzero(~live).flatten()
            _put(full, _take(sub, fin), ids[fin])
            keep = torch.nonzero(live).flatten()
            ids, sub = ids[keep], _take(sub, keep)
    return full


def _lane_sampler(seed, n: int, dev, lane0: int) -> LaneSampler:
    """The primary streams of rays ``lane0 .. lane0 + n - 1``: a slice of
    a batch draws what the whole batch draws on those rays."""
    return make_lane_sampler(seed, lanes=torch.arange(lane0, lane0 + n, device=dev))


# ---------------------------------------------------------------------------
# K-candidate batching (K7)
# ---------------------------------------------------------------------------
# The reference's step kernel with k_cand = K > 1 (uivr_tpu/ops/
# volpath_step.py: PRE :846-940, POST phase 0 :366-432).  A dispatch is POST
# then PRE; the first dispatch is PRE only.  PRE emits up to K candidate
# events of the lane's walk null-assumed: each candidate takes up to
# CROSS_STEPS cell steps (two draws each), and the walk continues from a
# collision candidate as if it were null; a segment end, or a crossing with
# the budget spent, stops the batch.  POST resolves the batch in order: the
# first terminal event (a real MAIN collision, a segment end or crossing, a
# shadow walk killed by its transmittance or its roulette) is presented to
# the single-event code, or the last null where there is none; the shadow
# multiplies of the candidates up to it are applied on the way, so the
# presented shadow event takes sigma 0.  Candidates past the terminal are
# discarded with their draws consumed, so a lane walks another (equally
# valid) path than at K = 1.  The lane's cap counts dispatches.  K6
# (subcell classification) is off, as in the reference.

# crossing budget of a candidate, read where the reference reads it
CROSS_STEPS = max(int(os.environ.get("UIVR_CROSS_STEPS", 4)), 1)
# candidate kinds
K_NONE, K_COLL, K_SEG_END, K_CROSS_SPENT = 0, 1, 2, 3


class _KCarry(NamedTuple):
    c: _FlatCarry
    t_cand: torch.Tensor      # (n, K) the pending batch's candidates
    t_exit: torch.Tensor      # (n, K)
    smaj: torch.Tensor        # (n, K)
    u_evt: torch.Tensor       # (n, K)
    kind: torch.Tensor        # (n, K) int32, K_NONE .. K_CROSS_SPENT
    cell_steps: torch.Tensor  # (n,) int32 cell steps of every PRE
    fetched: torch.Tensor     # (n,) int32 collision candidates resolved
    discarded: torch.Tensor   # (n,) int32 of which past a terminal event


def _emit_batch(scene: Scene, kc: _KCarry) -> _KCarry:
    """PRE: the next batch of K candidates of every walking lane."""
    c, m = kc.c, scene.medium
    K = kc.kind.shape[1]
    is_main = c.mode == MAIN
    is_sh = c.mode == SHADOW
    wd = torch.where(is_main[:, None], c.d_l, c.sh_d)
    nwt = torch.where(is_main, c.t, c.sh_t)
    wmax = torch.where(is_main, c.maxt, c.sh_tmax)
    stopped = ~(is_main | is_sh)
    smp, cell_steps = c.smp, kc.cell_steps
    cols = []
    for j in range(K):
        found = stopped
        tc, tx, sm, ue = (torch.zeros_like(nwt) for _ in range(4))
        kind = torch.zeros_like(c.mode)
        for k in range(CROSS_STEPS):
            active = ~found
            if not bool(active.any()):
                break
            smaj, texit = _cell_step(m, c.o_l, wd, nwt)
            u_step, smp = lane_next_1d(smp, consume=active)
            u_evt, smp = lane_next_1d(smp, consume=active)
            tcand = nwt + _free_step(smaj, u_step)
            hit = tcand < torch.minimum(texit, wmax)
            cross = ~hit & (texit < wmax)
            last = k == CROSS_STEPS - 1
            stop = active if last else active & ~cross
            tc = torch.where(stop, tcand, tc)
            tx = torch.where(stop, texit, tx)
            sm = torch.where(stop, smaj, sm)
            ue = torch.where(stop, u_evt, ue)
            kind = torch.where(stop, torch.where(hit, K_COLL, torch.where(
                cross, K_CROSS_SPENT, K_SEG_END)).to(torch.int32), kind)
            cell_steps = cell_steps + active.to(torch.int32)
            if not last:
                nwt = torch.where(active & cross, texit, nwt)
            found = found | stop
        cols.append((tc, tx, sm, ue, kind))
        if j < K - 1:
            # null-assumed continuation from a collision candidate
            nwt = torch.where(kind == K_COLL, tc, nwt)
            stopped = stopped | (kind >= K_SEG_END)
    c = c._replace(t=torch.where(is_main, nwt, c.t), sh_t=torch.where(is_sh, nwt, c.sh_t),
                   smp=smp)
    tc, tx, sm, ue, kind = (torch.stack(f, dim=1) for f in zip(*cols))
    return kc._replace(c=c, t_cand=tc, t_exit=tx, smaj=sm, u_evt=ue, kind=kind,
                       cell_steps=cell_steps)


def _resolve_batch(cfg: VolpathConfig, scene: Scene, kc: _KCarry,
                   deferred: bool) -> _KCarry:
    """POST: fetch sigma and albedo at the batch's candidates, resolve them
    in order and apply the presented event."""
    c, m = kc.c, scene.medium
    is_main = c.mode == MAIN
    is_sh = c.mode == SHADOW
    walking = is_main | is_sh
    wd = torch.where(is_main[:, None], c.d_l, c.sh_d)
    alive_m, alive_s = is_main, is_sh
    sh_tr = c.sh_tr
    found = torch.zeros_like(walking)
    z = torch.zeros_like(c.t)
    p_tc, p_tx, p_sm, p_ue, p_sig, p_alb = z, z, z, z, z, c.o_l * 0.0
    fetched, discarded = kc.fetched, kc.discarded
    for j in range(kc.kind.shape[1]):
        kind, tc, sm, ue = kc.kind[:, j], kc.t_cand[:, j], kc.smaj[:, j], kc.u_evt[:, j]
        coll = kind == K_COLL
        term = kind >= K_SEG_END
        sig, alb = sigma_albedo_at(m, ray_point(c.o_l, tc, wd))
        r = torch.where(sm > 0.0, sig / torch.clamp(sm, min=1e-20), 0.0)
        ratio = torch.clamp(1.0 - r, min=0.0)
        real = alive_m & coll & (ue < r)
        sc = alive_s & coll
        sh_tr = torch.where(sc, sh_tr * ratio, sh_tr)
        if cfg.shadow_rr > 0.0:
            tail = sc & (sh_tr < cfg.shadow_rr) & (sh_tr > 0.0)
            q_sh = sh_tr * (1.0 / cfg.shadow_rr)
            sh_tr = torch.where(tail, torch.where(ue < q_sh, cfg.shadow_rr, 0.0), sh_tr)
        killed = sc & (sh_tr <= 0.0)
        alive = alive_m | alive_s
        take = alive & (coll | term) & ~found
        fetched = fetched + coll.to(torch.int32)
        discarded = discarded + (coll & found).to(torch.int32)
        p_tc = torch.where(take, tc, p_tc)
        p_tx = torch.where(take, kc.t_exit[:, j], p_tx)
        p_sm = torch.where(take, sm, p_sm)
        p_ue = torch.where(take, ue, p_ue)
        p_sig = torch.where(take, sig, p_sig)
        p_alb = torch.where(take[:, None], alb, p_alb)
        found = found | (take & (real | killed | (alive & term)))
        alive_m = alive_m & ~(real | term)
        alive_s = alive_s & ~(term | killed)
    wt = torch.where(is_main, c.t, c.sh_t)
    wmax = torch.where(is_main, c.maxt, c.sh_tmax)
    # the batch's shadow multiplies are applied: sigma 0 leaves them be
    out, _ = _event_effect(cfg, scene, c, c.smp, walking, torch.zeros_like(walking), wt,
                           wmax, p_tc, p_tx, p_sm, p_ue, ray_point(c.o_l, p_tc, wd),
                           torch.where(is_sh, 0.0, p_sig), p_alb, sh_tr, False, deferred)
    return kc._replace(c=out, fetched=fetched, discarded=discarded)


def _sample_primal_k(cfg: VolpathConfig, scene: Scene, o, d, seed, k: int,
                     lane0: int, deferred: bool, max_iters: int):
    """The K-candidate carry of world rays ``o``, ``d`` after their walks
    (at most ``max_iters`` dispatches a lane)."""
    n, dev = o.shape[0], o.device
    c = _init_carry(scene, o, d, _lane_sampler(seed, n, dev, lane0))
    # every field gets its own storage: _run_lanes updates them in place
    def zf():
        return torch.zeros((n, k), dtype=torch.float32, device=dev)

    def zi(*shape):
        return torch.zeros((n,) + shape, dtype=torch.int32, device=dev)

    kc = _KCarry(c=c, t_cand=zf(), t_exit=zf(), smaj=zf(), u_evt=zf(), kind=zi(k),
                 cell_steps=zi(), fetched=zi(), discarded=zi())
    kc = _emit_batch(scene, kc)           # the first dispatch is PRE only
    return _run_lanes(lambda a: _emit_batch(scene, _resolve_batch(cfg, scene, a, deferred)),
                      kc, lambda a: (a.c.mode != DONE) & (a.c.steps < max_iters),
                      lambda a: a.c.mode)


def sample_primal(cfg: VolpathConfig, scene: Scene, o, d, seed,
                  return_stats: bool = False,
                  path_state: Optional[PathState] = None, lane0: int = 0,
                  deferred: bool = False, k_cand: int = 1, max_iters: int = 100_000):
    """Plain primal estimate of world rays ``o``, ``d`` (n, 3), or of the
    paths resumed from ``path_state`` (``o``, ``d`` unused then); the rays
    are keyed as ray ids ``lane0`` onwards.  ``deferred``: the kernels'
    deferred-radiance NEE where the emitter has a proxy.  ``k_cand > 1``:
    K-candidate batching (world rays only, as in the reference).  Each
    lane takes at most ``max_iters`` steps (dispatches with ``k_cand >
    1``); the kernels stop at ``cfg.max_steps``, and their plain version
    passes that.

    Returns ``(L (n,3), escaped (n,))`` and, with ``return_stats``, a dict
    of per-lane ``dim`` (draws consumed), ``steps`` and ``depth``; with
    ``k_cand > 1`` ``steps`` counts dispatches, and the dict adds the K7
    counters ``batches`` (the same), ``cell_steps``, ``fetched`` and
    ``discarded``."""
    if k_cand < 1 or (k_cand > 1 and path_state is not None):
        raise ValueError(f"k_cand={k_cand}: K-candidate batching takes world rays "
                         "and k_cand >= 1")
    CALLS["volpath_primal"] += 1
    n = (o if path_state is None else path_state.o_l).shape[0]
    dev = (o if path_state is None else path_state.o_l).device
    if k_cand > 1:
        kc = _sample_primal_k(cfg, scene, o, d, seed, k_cand, lane0, deferred, max_iters)
        full = kc.c
    else:
        full = _init_carry(scene, o, d, _lane_sampler(seed, n, dev, lane0), path_state)
        full = _run_lanes(lambda c: _flat_step(cfg, scene, c, deferred=deferred)[0], full,
                          lambda c: (c.mode != DONE) & (c.steps < max_iters),
                          lambda c: c.mode)
    L = _finish(cfg, scene, full, _nee_proxy(scene, deferred))
    if return_stats:
        stats = {"dim": full.smp.dim, "steps": full.steps, "depth": full.depth}
        if k_cand > 1:
            stats.update(batches=full.steps, cell_steps=kc.cell_steps,
                         fetched=kc.fetched, discarded=kc.discarded)
        return L, full.escaped, stats
    return L, full.escaped


def sample_primal_compact(cfg: VolpathConfig, scene: Scene, o, d, seed, schedule=None,
                          path_state: Optional[PathState] = None):
    """The reference's primal with compaction rounds: ``(L (n,3), escaped
    (n,))``.  :func:`sample_primal` already steps only the lanes still
    walking, so this is that primal with each lane bounded at
    ``cfg.max_steps`` steps, as the reference bounds its rounds;
    ``schedule`` (the sizes of XLA's compaction rounds) is accepted and
    ignored."""
    return sample_primal(cfg, scene, o, d, seed, path_state=path_state,
                         max_iters=cfg.max_steps)


# ---------------------------------------------------------------------------
# Adjoint
# ---------------------------------------------------------------------------

class _FlatAdjCarry(NamedTuple):
    c: _FlatCarry
    alt: LaneSampler
    rp_dim: torch.Tensor     # (n,) replay counter
    rp_t: torch.Tensor       # (n,)
    rp_tr: torch.Tensor      # (n,)
    sh_dim0: torch.Tensor    # (n,) counter at the shadow walk's start
    sh_adj: torch.Tensor     # (n,3) dL * completed NEE contribution
    dL: torch.Tensor         # (n,3) per-lane adjoint radiance
    res: _Reservoir


def _adjoint_step(cfg: VolpathConfig, scene: Scene, acc: GradAccum,
                  a: _FlatAdjCarry, deferred: bool = False) -> _FlatAdjCarry:
    """One step of the adjoint state machine (the body of the reference's
    ``sample_adjoint`` loop); scatters into ``acc`` in place."""
    m = scene.medium
    c, dL = a.c, a.dL
    out, ev = _flat_step(cfg, scene, c, rp_dim=a.rp_dim, rp_t=a.rp_t, deferred=deferred)
    alt = a.alt
    p, sig, alb = ev.p, ev.sig, ev.alb

    # ---- in-scattering gradients at real collisions (PRB)
    if (not cfg.use_drt) or cfg.use_drt_mis:
        if cfg.use_drt and cfg.use_drt_mis:
            wf = sig / (1.0 + sig * sig)     # MIS weight times 1/sigma_t
        else:
            wf = 1.0 / torch.clamp(sig, min=1e-8)
        Li = c.result / torch.clamp(alb, min=1e-8)
        base = dL * Li * wf[:, None]
        ba = base * alb
        scatter_sigma_albedo(acc, m, p, (ba[:, 0] + ba[:, 1]) + ba[:, 2],
                             base * sig[:, None], ev.real)

    # ---- DRT reservoir over segment ends, escape segments included
    res = a.res
    seg_end = ev.real | ev.m_escape
    if cfg.use_drt and cfg.use_drt_subsampling:
        u_res, alt = lane_next_1d(alt, consume=seg_end)
        res = _reservoir_update(res, ev.thr_pre, u_res, seg_end, c.depth,
                                c.o_l, c.d_l, c.d_w, c.maxt)

    # ---- transmittance gradients: uniform samples along the segment
    interval = torch.where(ev.m_escape, c.maxt, ev.t_cand)
    dr = dL * c.result
    adj_w = (dr[:, 0] + dr[:, 1]) + dr[:, 2]
    inv_pdf = interval / float(cfg.trans_grad_samples)
    for _ in range(cfg.trans_grad_samples):
        u_t, alt = lane_next_1d(alt, consume=seg_end)
        p_s = c.o_l + (u_t * interval)[:, None] * c.d_l
        scatter_sigma(acc, m, p_s, -adj_w * inv_pdf, seg_end)

    # ---- shadow walk completed: PRB subtraction, then REPLAY unless the
    # contribution is zero (a zero walk carries no cotangent)
    mode = out.mode
    result = out.result - torch.where(ev.sh_done[:, None], ev.contrib, 0.0)
    sh_adj = torch.where(ev.sh_done[:, None], dL * ev.contrib, a.sh_adj)
    ac = ev.contrib.abs()
    do_rp = ev.sh_done & (((ac[:, 0] + ac[:, 1]) + ac[:, 2]) > 0.0)
    rp_dim = torch.where(do_rp, a.sh_dim0, a.rp_dim)
    rp_t = torch.where(do_rp, 0.0, a.rp_t)
    rp_tr = torch.where(do_rp, 1.0, a.rp_tr)
    mode = torch.where(ev.sh_done,
                       torch.where(do_rp, REPLAY, out.post_mode), mode)

    # ---- REPLAY: -sum(sh_adj) / sigma_n at each null collision
    is_rp = ev.is_rp
    rp_coll = is_rp & ev.collided
    sigma_n = torch.clamp(ev.sigma_maj - sig, min=1e-8)
    sa = a.sh_adj
    cot = -((sa[:, 0] + sa[:, 1]) + sa[:, 2]) / sigma_n
    scatter_sigma(acc, m, p, cot, rp_coll & (ev.ratio > 0.0))
    rp_tr = torch.where(rp_coll, rp_tr * ev.ratio, rp_tr)
    if cfg.shadow_rr > 0.0:
        # the primal shadow walk's RR decision, from the same u_evt
        tail = rp_coll & (rp_tr < cfg.shadow_rr) & (rp_tr > 0.0)
        q_sh = rp_tr * (1.0 / cfg.shadow_rr)
        rp_tr = torch.where(tail, torch.where(ev.u_evt < q_sh, cfg.shadow_rr, 0.0),
                            rp_tr)
    rp_t = torch.where(is_rp, ev.t_next, rp_t)
    rp_dim = torch.where(is_rp, (rp_dim + 2) & _M32, rp_dim)
    rp_fin = is_rp & (ev.fin_seg | (rp_tr <= 0.0))
    mode = torch.where(rp_fin, c.post_mode, mode)

    # ---- the primary counter where the next shadow walk starts
    sh_dim0 = torch.where(ev.scat, out.smp.dim, a.sh_dim0)

    out = out._replace(mode=mode.to(torch.int32), result=result)
    return _FlatAdjCarry(c=out, alt=alt, rp_dim=rp_dim, rp_t=rp_t,
                         rp_tr=rp_tr, sh_dim0=sh_dim0, sh_adj=sh_adj, dL=dL,
                         res=res)


def adjoint_walk(cfg: VolpathConfig, scene: Scene, o, d, seed, dL, state_in,
                 lane0: int = 0, deferred: bool = False, max_iters: int = None):
    """The adjoint's path-replay walk, without the delayed DRT term; the
    rays are keyed as ray ids ``lane0`` onwards (``deferred`` as in
    :func:`sample_primal`: the completed shadow walks then carry the
    full-resolution radiance, so their cotangents see complete weights).

    Returns ``(acc, res, stats)``: the gradient accumulator, the per-lane
    DRT reservoirs and per-lane ``dim`` (primary draws), ``alt_dim`` (alt
    stream draws) and ``steps``."""
    m = scene.medium
    n = o.shape[0]
    smp = _lane_sampler(seed, n, o.device, lane0)
    c = _init_carry(scene, o, d, smp)
    c = c._replace(result=state_in.clone())
    zu = torch.zeros(n, dtype=torch.int64, device=o.device)
    full = _FlatAdjCarry(
        c=c, alt=lane_fork(smp, 0x9E3779B9), rp_dim=zu,
        rp_t=torch.zeros_like(c.maxt), rp_tr=torch.zeros_like(c.maxt),
        sh_dim0=zu.clone(), sh_adj=torch.zeros_like(c.o_l), dL=dL.clone(),
        res=_reservoir_init(torch.zeros_like(c.o_l)))
    acc = init_accum(m, need_emission=False)
    if max_iters is None:
        max_iters = 3 * cfg.max_steps
    full = _run_lanes(lambda a: _adjoint_step(cfg, scene, acc, a, deferred), full,
                      lambda a: (a.c.mode != DONE) & (a.c.steps < max_iters),
                      lambda a: a.c.mode)
    stats = {"dim": full.c.smp.dim, "alt_dim": full.alt.dim,
             "steps": full.c.steps}
    return acc, full.res, stats


def sample_adjoint(cfg: VolpathConfig, scene: Scene, o, d, seed, dL,
                   state_in, deferred: bool = False, max_iters: int = None):
    """Plain path-replay adjoint of world rays ``o``, ``d`` with per-ray
    adjoint radiance ``dL`` (n,3) and replayed primal radiance
    ``state_in`` (n,3); ``deferred`` as in :func:`sample_primal`; each lane
    takes at most ``max_iters`` steps (None: ``3 * cfg.max_steps``, its
    three walks' bound).  Returns MediumParams gradients (zero
    emission)."""
    CALLS["volpath_adjoint"] += 1
    acc, res, _ = adjoint_walk(cfg, scene, o, d, seed, dL, state_in,
                               deferred=deferred, max_iters=max_iters)
    if cfg.use_drt and cfg.use_drt_subsampling:
        acc = _drt_backward_flat(cfg, scene, seed, res, _reservoir_get(res) * dL,
                                 acc, deferred=deferred)
    return finalize_accum(acc, scene.medium)


def _drt_backward_flat(cfg: VolpathConfig, scene: Scene, seed, res: _Reservoir,
                       adjoint, acc: GradAccum, return_stats: bool = False,
                       deferred: bool = False):
    """Delayed DRT on the reservoir vertices: a transmittance-proportional
    distance, a recursive detached Li (NEE + a resumed primal path) and the
    sigma/albedo cotangents there.  Its auxiliary draws come from the
    global-counter sampler ``TEA(seed, 0x5151)``, so every lane's NEE and
    phase draws sit after the longest walk of the step before.  With
    ``return_stats`` also returns the walk's results, the trip maxima
    ``k_a`` (distance walk) and ``k_b`` (NEE transmittance), the NEE
    radiance, the resumed ``path_state`` and its radiance ``rec_L`` with
    the resumed primal's ``rec_stats``.  ``deferred`` applies to the
    resumed primal only: the term's own NEE samples the full-resolution
    emitter, as the reference's does."""
    CALLS["volpath_drt"] += 1
    m = scene.medium
    n = res.o_l.shape[0]
    drt_seed, _ = sample_tea_32(seed, 0x5151)
    gs = make_sampler(drt_seed, n_lanes=n, device=res.o_l.device)

    t_sub, w_drt, found, gs = drt_distance(
        m, res.o_l, res.d_l, res.maxt, gs, res.active, max_steps=cfg.max_steps)
    k_a = gs.dim // 2
    active = res.active & found
    t_safe = torch.where(found, t_sub, 0.0)
    p = ray_point(res.o_l, t_safe, res.d_l)

    Li = torch.zeros_like(adjoint)
    nee = Li
    k_b = 0
    if cfg.use_nee:
        dim_b = gs.dim
        nee, _, gs = _nee_primal(cfg, scene, p, res.d_w,
                                 torch.ones_like(adjoint), gs, active)
        k_b = gs.dim - dim_b - 2
        Li = Li + nee
    u1, gs = next_1d(gs)
    u2, gs = next_2d(gs)
    wo, ph_pdf = phase_sample(m.phase_g, res.d_w, u1, u2[:, 1])
    rec_dl = aabb.transform_dirs(m.world_to_local, wo)
    rec_maxt = _exit_dist(p, rec_dl)
    next_depth = torch.where(active, res.depth + 1, res.depth)
    ps = PathState(
        active=active & (next_depth < cfg.max_depth) & (rec_maxt > 1e-7),
        depth=next_depth, o_l=p, d_l=rec_dl, d_w=wo, maxt=rec_maxt,
        last_pdf=torch.where(active, ph_pdf, 1.0))
    rec_seed, _ = sample_tea_32(seed, 0x7177)
    rec_Li, _, rec_stats = sample_primal(cfg, scene, None, None, rec_seed, True,
                                         path_state=ps, deferred=deferred,
                                         max_iters=cfg.max_steps)
    Li = Li + rec_Li

    sig, alb = sigma_albedo_at(m, p)
    w_mis = (1.0 / (1.0 + sig * sig) if cfg.use_drt_mis
             else torch.ones_like(sig))
    factor = (w_mis * w_drt)[:, None] * adjoint * Li
    fa = factor * alb
    scatter_sigma_albedo(acc, m, p, (fa[:, 0] + fa[:, 1]) + fa[:, 2],
                         factor * sig[:, None], active)
    if return_stats:
        return acc, {"t_sel": t_sub, "wsum": w_drt, "found": found, "k_a": k_a,
                     "k_b": k_b, "nee": nee, "path_state": ps, "rec_L": rec_Li,
                     "rec_stats": rec_stats}
    return acc

