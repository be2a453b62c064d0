"""Flattened volumetric path tracer, primal half: the plain PyTorch twin of
the CUDA path-tracing kernel (``ops/csrc/volpath_primal.cu``).

Port of ``uivr_tpu/integrators/volpath_flat.py`` (``_cell_step``,
``_init_carry``, the primal branches of ``_flat_step``, ``_finish`` and
``sample_primal``).  Every lane advances one majorant-tracking step per
iteration and switches between walk modes:

    MAIN    delta-track the camera/bounce ray to its next real collision
    SHADOW  ratio-track an NEE shadow ray (transmittance)
    DONE    terminated

Lanes are independent (per-lane RNG counters), so each iteration steps only
the lanes still walking; this stands in for the reference's compaction
rounds (``sample_primal_compact``) and gives the same per-lane results.
Every lane is bounded by ``cfg.max_steps`` steps.

The kernel repeats this arithmetic operation for operation, so the order of
every sum and product here is part of the contract: transforms, dot
products and norms are written out, and constants divide as tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import aabb
from ..core import fmath
from ..core.fmath import ray_point
from ..core.rng import LaneSampler, lane_next_1d, make_lane_sampler
from ..scene.medium import sigma_albedo_at
from ..scene.phase import phase_eval, phase_sample
from ..scene.scene import Scene
from .common import mis_weight
from .volpathsimple import VolpathConfig, _exit_dist

DONE, MAIN, SHADOW = 0, 1, 2
_BIG = 1e30

# calls of the plain twin (``sample_primal``), so a run can show that its
# main path went through the kernel instead
CALLS = {"volpath_primal": 0}


def _cell_step(m, o_l, wd, wt):
    """Supercell majorant and exit parameter at walk position ``wt``."""
    Dc, Hc, Wc = m.majorant_grid.shape
    res = torch.tensor([Wc, Hc, Dc], dtype=torch.float32, device=o_l.device)
    eps = 1e-5 * (1.0 + wt.abs())
    p = ray_point(o_l, wt + eps, wd)
    cell = torch.minimum(
        torch.clamp(torch.floor(torch.clamp(p, 0.0, 1.0 - 1e-7) * res), min=0.0),
        res - 1.0)
    ci = cell.to(torch.int64)
    sigma_maj = m.majorant_grid[ci[:, 2], ci[:, 1], ci[:, 0]]
    lo = cell / res
    hi = (cell + 1.0) / res
    tiny = torch.where(wd >= 0, 1e-20, -1e-20).to(wd.dtype)
    safe_d = torch.where(wd.abs() < 1e-20, tiny, wd)
    t_hi = torch.maximum((lo - o_l) / safe_d, (hi - o_l) / safe_d)
    t_exit = torch.minimum(torch.minimum(t_hi[:, 0], t_hi[:, 1]), t_hi[:, 2])
    return sigma_maj, torch.maximum(t_exit, wt + eps)


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


def _init_carry(scene: Scene, o, d, smp: LaneSampler) -> _FlatCarry:
    m = scene.medium
    ol = aabb.transform_points(m.world_to_local, o)
    dl = aabb.transform_dirs(m.world_to_local, d)
    tn, tf, hit = aabb.ray_unit_cube(ol, dl, 0.0, aabb.INF)
    active = hit & (tf > tn)
    entry = ray_point(ol, tn, dl, fused=(False, False, True))

    # every field gets its own storage: sample_primal updates them in place
    def z1():
        return torch.zeros_like(tn)

    def z3():
        return torch.zeros_like(ol)

    def zi():
        return torch.zeros(tn.shape, dtype=torch.int32, device=tn.device)

    return _FlatCarry(
        mode=torch.where(active, MAIN, DONE).to(torch.int32),
        o_l=entry, d_l=dl, d_w=d.clone(), t=z1(),
        maxt=torch.where(active, tf - tn, 0.0), depth=zi(),
        throughput=z3() + 1.0, result=z3(), escaped=~active,
        has_scattered=torch.zeros_like(active), last_pdf=z1() + 1.0,
        post_mode=zi() + MAIN, sh_d=z3(), sh_t=z1(), sh_tmax=z1(),
        sh_tr=z1(), sh_base=z3(), smp=smp, steps=zi())


def _flat_step(cfg: VolpathConfig, scene: Scene, c: _FlatCarry) -> _FlatCarry:
    """One tracking step for every lane of ``c``."""
    m = scene.medium
    mode = c.mode
    is_main = mode == MAIN
    is_sh = mode == SHADOW
    walking = is_main | is_sh

    wd = torch.where(is_main[:, None], c.d_l, c.sh_d)
    wt = torch.where(is_main, c.t, c.sh_t)
    wmax = torch.where(is_main, c.maxt, c.sh_tmax)
    sigma_maj, t_exit = _cell_step(m, c.o_l, wd, wt)

    smp = c.smp
    u_step, smp = lane_next_1d(smp, consume=walking)
    u_evt, smp = lane_next_1d(smp, consume=walking)

    step = torch.where(sigma_maj > 0.0,
                       -fmath.log1p(-u_step) / torch.clamp(sigma_maj, min=1e-20),
                       _BIG)
    t_cand = wt + step
    bound = torch.minimum(t_exit, wmax)
    collided = walking & (t_cand < bound)
    fin_seg = walking & ~collided & (t_exit >= wmax)
    crossed = walking & ~collided & (t_exit < wmax)
    t_next = torch.where(collided, t_cand, torch.where(crossed, t_exit, wt))

    p = ray_point(c.o_l, t_cand, wd)
    sig, alb = sigma_albedo_at(m, p)
    r = torch.where(sigma_maj > 0.0, sig / torch.clamp(sigma_maj, min=1e-20), 0.0)
    ratio = torch.clamp(1.0 - r, min=0.0)

    # ---- SHADOW walk (ratio tracking)
    sh_coll = is_sh & collided
    sh_tr = torch.where(sh_coll, c.sh_tr * ratio, c.sh_tr)
    if cfg.shadow_rr > 0.0:
        tail = sh_coll & (sh_tr < cfg.shadow_rr) & (sh_tr > 0.0)
        q_sh = sh_tr * (1.0 / cfg.shadow_rr)
        sh_tr = torch.where(tail, torch.where(u_evt < q_sh, cfg.shadow_rr, 0.0),
                            sh_tr)
    sh_t = torch.where(is_sh, t_next, c.sh_t)
    sh_done = is_sh & (fin_seg | (sh_tr <= 0.0))
    contrib = c.sh_base * sh_tr[:, None]
    result = c.result + torch.where(sh_done[:, None], contrib, 0.0)
    mode = torch.where(sh_done, c.post_mode, mode)

    # ---- MAIN walk (delta tracking)
    real = is_main & collided & (u_evt < r)
    m_escape = is_main & fin_seg
    t = torch.where(is_main, t_next, c.t)
    escaped = c.escaped | m_escape
    mode = torch.where(m_escape, DONE, mode)

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
        ds_d, ds_pdf, em_w = scene.emitter.sample_direction(
            torch.stack([u_e1, u_e2], dim=-1))
        nee_ok = scat & (ds_pdf > 0.0)
        phv = phase_eval(m.phase_g, c.d_w, ds_d)   # incident direction
        wmis = mis_weight(ds_pdf, phv)
        sh_d_new = aabb.transform_dirs(m.world_to_local, ds_d)
        sh_tmax_new = _exit_dist(o_l, sh_d_new)
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

    return _FlatCarry(
        mode=mode.to(torch.int32), o_l=o_l, d_l=d_l, d_w=d_w, t=t, maxt=maxt,
        depth=depth, throughput=throughput, result=result, escaped=escaped,
        has_scattered=has_scattered, last_pdf=last_pdf, post_mode=post_mode,
        sh_d=sh_d, sh_t=sh_t, sh_tmax=sh_tmax, sh_tr=sh_tr, sh_base=sh_base,
        smp=smp, steps=c.steps + walking.to(torch.int32))


def _finish(cfg: VolpathConfig, scene: Scene, c: _FlatCarry) -> torch.Tensor:
    """Emitter contribution on escape, MIS-weighted against NEE."""
    active_e = c.escaped
    if cfg.hide_emitters:
        active_e = active_e & ~(c.depth <= 0)
    if cfg.use_nee:
        epdf = scene.emitter.pdf_direction(c.d_w)
        epdf = torch.where(c.has_scattered, epdf, 0.0)
        w = mis_weight(c.last_pdf, epdf)[:, None]
        contrib = c.throughput * w * scene.emitter.eval(c.d_w)
    else:
        contrib = c.throughput * scene.emitter.eval(c.d_w)
    return c.result + torch.where(active_e[:, None], contrib, 0.0)


def _take(c: _FlatCarry, idx: torch.Tensor) -> _FlatCarry:
    fields = {f: getattr(c, f)[idx] for f in c._fields if f != "smp"}
    return _FlatCarry(smp=LaneSampler(h=c.smp.h[idx], dim=c.smp.dim[idx]),
                      **fields)


def _put(full: _FlatCarry, sub: _FlatCarry, idx: torch.Tensor) -> None:
    """Write the lanes of ``sub`` into ``full`` at ``idx`` (in place: the
    full carry is private to :func:`sample_primal`)."""
    for f in full._fields:
        if f != "smp":
            getattr(full, f)[idx] = getattr(sub, f)
    full.smp.h[idx] = sub.smp.h
    full.smp.dim[idx] = sub.smp.dim


def sample_primal(cfg: VolpathConfig, scene: Scene, o, d, seed,
                  return_stats: bool = False):
    """Plain primal estimate of world rays ``o``, ``d`` (n, 3).

    Returns ``(L (n,3), escaped (n,))`` and, with ``return_stats``, a dict
    of per-lane ``dim`` (draws consumed), ``steps`` and ``depth``."""
    CALLS["volpath_primal"] += 1
    n = o.shape[0]
    full = _init_carry(scene, o, d, make_lane_sampler(seed, n_lanes=n,
                                                      device=o.device))
    ids = torch.nonzero(full.mode != DONE).flatten()
    sub = _take(full, ids)
    while ids.numel():
        sub = _flat_step(cfg, scene, sub)
        live = (sub.mode != DONE) & (sub.steps < cfg.max_steps)
        if not bool(live.all()):
            fin = torch.nonzero(~live).flatten()
            _put(full, _take(sub, fin), ids[fin])
            keep = torch.nonzero(live).flatten()
            ids, sub = ids[keep], _take(sub, keep)
    L = _finish(cfg, scene, full)
    if return_stats:
        return L, full.escaped, {"dim": full.smp.dim, "steps": full.steps,
                                 "depth": full.depth}
    return L, full.escaped
