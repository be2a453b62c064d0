#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``uivr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero before the last line.
K6 (subcell classification) is on by default in every walking kernel; "K6
off" is the same kernel on the same medium without its subcell table, which
must give the same result:

1. device: the card (``nvidia-smi`` name and power limit on a line of its
   own), torch and CUDA versions, and the kernels' nvcc builds (one nvcc
   per source, started together) with ptxas' registers and spills.
2. tea (K1): ``tea_kernel`` against the plain ``tea_plain`` on 2**20 random
   (v0, v1) pairs at 5, 6 and 8 rounds; bit for bit.
3. primal (K2 + K3 + K6): ``volpath_primal_kernel`` on 2**16 camera rays at
   random pixels of sensor 0, from the ground-truth grids: janga-smoke and
   dust-devil at full width (envmap, NEE on) and tiny-cube (constant
   emitter) with NEE on and off.  K6 on must equal K6 off on every lane
   (radiance bit for bit, escapes, draws, steps).  Against the plain twin
   (``engine="flat"``) a lane agrees when |dL| <= 1e-4 (1 + |L|) on all
   three channels; janga-smoke and dust-devil need >= 0.90 of lanes,
   tiny-cube >= 0.95, and every channel mean within 2%; janga's rays also
   go through a build with ``--fmad=true``.  K6 must classify MAIN nulls
   on dust-devil, and on janga-sparse (janga's density kept in a central
   block under one global majorant, on/off only) both MAIN nulls and
   SHADOW events in empty subcells.
4. render: ``python -m uivr_tpu_torch.cli.render --scene <s> --sensor 0
   --spp 64`` for janga-smoke and dust-devil (1,785,600 rays each) with
   every launch counter set to 0 just before; the kernels and K6 must have
   launched and the plain twin must not have run.  The EXR is read back
   and checked.  Then three more renders (host clock) and four timed part
   by part with CUDA events (scene set-up, ray generation, kernel,
   reduction), K6 on, off, off, on.
5. the primal kernel at the shape the render gave it (its first chunk of
   2**20 rays), K6 on and off, beside its plain version (janga-smoke; K6
   on and off on dust-devil's chunk too).
6. adjoint (K4 + K5 + K6): ``volpath_adjoint_kernel`` after one replay
   primal each, K6 on against off (draws, steps and reservoir depth equal
   on every lane, gradients' relative L1 <= 1e-4: atomics reorder the
   sums), and against the twin's adjoint walk on the same rays, seed and
   random dL: janga-smoke, 8,192 random-pixel rays, under
   ``volpathsimple-drt`` and ``volpathsimple-basic`` with shadow RR 0.05;
   tiny-cube, 16,384 rays, NEE on and off (per-lane primary draws, alt
   draws and reservoir depth equal on >= 0.90 of lanes for janga, >= 0.95
   for the cube; gradients' relative L1 <= 1e-2); dust-devil, 8,192 rays,
   K6 on against off only (its twin check is phase 8's).
7. train: ``opt.run_optimization`` with ``volpathsimple-drt`` at full
   width (batch 32,768, 16 adjoint spp, primal factor 64: 33,554,432
   primal and 524,288 adjoint rays a step), grids at full resolution (no
   upsampling), counters set to 0 just before: the kernels and K6
   launched, the twins never ran, parameters changed.  janga-smoke: 3
   iterations, 128^3 grids, references at 64 spp, the .vol checkpoints
   read back; dust-devil: 2 iterations, 256^3 grids, the ``-from-nerf``
   schedule (lr 1e-4, albedo factor 100), references at 16 spp (a cut:
   the step does not depend on them).  Then, for each, ``run_optimization``
   for one step from the ground-truth grids.  ``StepRecorder`` keeps what
   each step did: its seconds, loss and gradients, the inputs and outputs
   of its adjoint and DRT calls, and CUDA events around the pixel draw,
   the step and every kernel launch (``volpath_step.TIMINGS``), which give
   the step's parts.
8. adjoint_step and drt (``check_step``), for janga's first step and
   truth step and dust-devil's truth step: the adjoint call's per-lane
   primary draws, alt draws and reservoir depth on its last 8,192 rays
   against the twin keyed by their ray ids (``lane0``), >= 0.90 of lanes,
   and the step's gradients finite and nonzero; ``drt_backward_kernel``
   against ``volpath_flat._drt_backward_flat`` on all 524,288 reservoirs
   of the step: equal
   wavefront maxima K_A and K_B, per-lane t_sel, wsum and found equal on
   >= 0.90 of lanes, gradients' relative L1 <= 1e-2.
9. cli: ``uivr_tpu_torch.cli.reproduce`` on tiny-cube (20 iterations at
   batch 557); metrics.jsonl must hold losses and the final checkpoint
   must exist.  fd: ``uivr_tpu_torch.cli.fd`` on tiny-cube (spp 1024, res
   16, all three grids) under ``volpathsimple-drt`` and
   ``volpathsimple-basic``, K6 on and off: kernels only, no twin, the same
   FD values and adjoint gradients (relative L1 <= 1e-4).
9b. xml: the XML path.  ``write_standins`` writes stand-in assets of the
   shapes janga-smoke's and dust-devil's XML files and scene vars name
   (plumes of 136x264x136 and 256^3 voxels, albedo 128x256x128 noise and a
   256^3 sand colour, ``procedural_sky`` at 1024x2048 as .hdr and 2048x4096
   as .exr) from a seed into a temporary scene directory beside copies of
   the XML files, and ``UIVR_SCENE_DIR`` points the registry there.
   xml_render: ``cli.render --scene janga-smoke --sensor 0 --spp 64`` at
   720x620 (28,569,600 rays): every launch took K3b, no twin ran, the EXR
   reads back.  k3b_primal / k3b_adjoint: ``volpath_primal_kernel`` against
   the twin's deferred mode on 2**16 random-pixel rays of sensor 0 (phase
   3's bar) and ``volpath_adjoint_kernel`` against the deferred adjoint walk
   on 8,192 rays (phase 6's bar).  k3b_chunk: the primal kernel against the
   deferred twin on the render's first chunk (2**20 rays, phase 3's bar),
   the shape its time is taken at.  unbiased: sensor 0 at 256 spp with K3b,
   with K3 (the map without its proxy) and without NEE; per channel the
   paired per-pixel difference's mean over its standard error, K3b against
   the NEE-free image at most 4 (K3 is reported: its full-resolution alias
   table is biased, ROADMAP C2).  xml-train: ``run_optimization`` of
   ``volpathsimple-drt`` at full width from the ``start_from_value`` grids,
   2 iterations and one step from the ground truth, references from
   ``build_ref()`` at 4 spp (a cut: the step does not depend on them);
   every walking launch took K3b, in the main run and in each recorded
   step; ``check_step`` on its truth step (the adjoint slice and the DRT
   term, whose resumed primal takes K3b, against the deferred twins).
   dust-devil: its 4k map (8,388,608 texels), sensor 0 at 64 spp with K3b
   and K3 in turns and without NEE; K3b against the NEE-free image at most
   4 standard errors per channel.
10. kernels: every kernel of both paths at the shape the main path gives
   it, with its launches, time, plain version's time, bound and agreement;
   K6's row gives the walking kernels' times with K6 on and off at the
   main path's shapes and its counters (MAIN nulls classified, fetches
   avoided); K3b's row (``deferred_nee``) the primal kernel with K3b and
   with K3 on the XML render's first chunk, its error and plain time on
   that chunk.  ``launches_per_train_step`` is the counters' growth over
   the main run's first recorded step.
11. the last line: {"ok": true, "device": {...}}.

``bound_ms`` is the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over 67 T/s, the H100 SXM's float32 rate outside the tensor cores (used for
the integer hash too).  The primal kernel's operations are counted from
this run's per-lane tracking steps and draws: ``FLOP_PER_STEP`` per
tracking event and ``FLOP_PER_EXTRA_DRAW`` per draw beyond the two every
event takes (one per real collision, four per scatter with NEE).
``gather_bound_ms`` counts instead the bytes the events fetch: 132 B of
grid and majorant per event (8 B, majorant and subcell bound, for an event
K6 classified), 28 B of envmap per scatter, 36 B per ray.  The training
kernels' bounds (``adjoint_bound``, ``drt_bounds``) follow the same two
rules, from this run's per-lane counters.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FLOP_PER_STEP = 120
FLOP_PER_EXTRA_DRAW = 60
TEA_OPS_PER_ROUND = 17


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; phase records carry the script's elapsed seconds."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - T0, 3))
    print(json.dumps(obj), flush=True)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps):
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_fmad_variant():
    """Start nvcc on the primal kernel with --fmad=true (the default
    contraction) into build/, beside the package's own build."""
    from uivr_tpu_torch.ops import volpath_step as vs
    flags = [f for f in vs.NVCC_FLAGS if f != "--fmad=false"] + ["--fmad=true"]
    out = vs.build_dir() / "libuivr_primal-fmad.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([vs._nvcc(), *flags, "-o", str(out),
                             str(vs.CSRC / "volpath_primal.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def time_render_parts(st, b, seed, spp):
    """CUDA-event times (ms) of the parts of one full-frame render, in the
    order render_image runs them."""
    import torch
    from uivr_tpu_torch.core import rng
    from uivr_tpu_torch.ops import volpath_step as vs
    from uivr_tpu_torch.render import batched
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    parts = {"scene": 0.0, "rays": 0.0, "kernel": 0.0, "reduce": 0.0}

    def timed(name, fn):
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        parts[name] += ev[0].elapsed_time(ev[1])
        return out

    dev = b.params.sigma_t.device
    scene = timed("scene", lambda: batched._scene(st, b.params, b.emitter, b.cameras,
                                                  b.to_world))
    W, H = st.film_size
    pix_all = torch.stack([torch.arange(W * H, device=dev) % W,
                           torch.arange(W * H, device=dev) // W], dim=-1)
    chunk_pix = (1 << 20) // spp
    for i in range(0, W * H, chunk_pix):
        pix = pix_all[i:i + chunk_pix]
        sidx = torch.zeros(pix.shape[0], dtype=torch.int64, device=dev)
        sub = rng.sample_tea_32(seed + i, 22)[0]
        o, d = timed("rays", lambda: batched._expand_rays(b.cameras, sidx, pix, st.film_size,
                                                          spp, sub))
        L, _ = timed("kernel", lambda: vs.sample_primal_kernel(st.integrator, scene, o, d,
                                                               seed + i))
        timed("reduce", lambda: L.reshape(-1, spp, 3).mean(dim=1).cpu())
    return parts


def ptxas_report(log):
    """{kernel: "registers, spills"} from nvcc -Xptxas -v output."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def lane_agreement(L, Lref):
    ok = ((L - Lref).abs() <= 1e-4 * (1.0 + Lref.abs())).all(dim=-1)
    return ok.float().mean().item()


def no_cls(sc):
    """The same scene with K6 off: its medium without the subcell table."""
    return sc._replace(medium=sc.medium._replace(sub=None))


def cls_counts(cls):
    """Sums of the walking kernels' per-lane K6 counters (n, 5), with the
    share of MAIN nulls classified and the sigma fetches avoided."""
    from uivr_tpu_torch.ops.volpath_step import CLS_COUNTERS
    c = dict(zip(CLS_COUNTERS, cls.to("cpu").long().sum(0).tolist()))
    c["main_nulls_classified_share"] = c["cls_main_nulls"] / max(c["main_nulls"], 1)
    c["fetches_avoided"] = c["cls_main_nulls"] + c["cls_shadow"]
    c["fetches_avoided_share"] = c["fetches_avoided"] / max(c["candidates"], 1)
    return c


def on_off_ms(on, off, reps=2):
    """CUDA-event times (ms) of two versions of a launch, in turns (on,
    off, off, on), each the mean of its two turns."""
    a = cuda_ms(on, reps)
    b = cuda_ms(off, reps) + cuda_ms(off, reps)
    return (a + cuda_ms(on, reps)) / 2, b / 2


def event_fetch_bytes(events, cls):
    """The fetch model's bytes of ``events`` tracking events: 132 B of grid
    corners and majorant each, but 8 B (majorant + subcell bound) for the
    events K6 classified."""
    classified = cls["fetches_avoided"] if cls else 0
    return 132 * (events - classified) + 8 * classified


# ------------------------------------------------------------------ training
DRT_KERNELS = ("volpath_drt_walk", "volpath_drt_nee", "volpath_drt_phase",
               "volpath_drt_scatter")
ADJ_KERNELS = ("volpath_adjoint", "volpath_primal_state") + DRT_KERNELS
TRAIN_KERNELS = ("volpath_primal",) + ADJ_KERNELS
SLICE = 8192    # lanes of a training step's adjoint call held against the twin


def rel_l1(a, ref):
    return float((a - ref).abs().sum() / ref.abs().sum().clamp_min(1e-30))


def equal_frac(a, b):
    return float((a == b).float().mean())


class StepRecorder:
    """Records what the steps of ``opt.run_optimization`` do, around the
    package's own functions, each of which still runs as it is: CUDA events
    of the pixel draw, of the whole step and of every kernel launch
    (``volpath_step.TIMINGS``); the launch counters' growth over the step
    (``counts``); the adjoint walk's inputs and outputs; the delayed DRT
    term's inputs; the gradients the backward returns."""

    def __init__(self, vs, loop):
        self.vs, self.loop = vs, loop
        self.steps, self.pre, self.saved = [], [], {}

    def __enter__(self):
        import torch
        vs = self.vs

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed(fn):
            def run(*a, **k):
                s = event()
                out = fn(*a, **k)
                self.pre.append((fn.__name__, s, event()))
                return out
            return run

        def make_step(make):
            def build(*a, **k):
                step = make(*a, **k)

                def run(*args):
                    rec = {"pre": self.pre, "launches": []}
                    self.pre = []
                    self.steps.append(rec)
                    torch.cuda.synchronize()
                    vs.TIMINGS = rec["launches"]
                    before = dict(vs.LAUNCHES)
                    t0 = time.perf_counter()
                    rec["start"] = event()
                    out = step(*args)
                    rec["end"] = event()
                    torch.cuda.synchronize()
                    rec["seconds"] = time.perf_counter() - t0
                    vs.TIMINGS = None
                    rec["counts"] = {k: vs.LAUNCHES[k] - before[k] for k in before}
                    rec["loss"] = float(out[2])
                    return out
                return run
            return build

        def adjoint_walk(fn):
            def run(cfg, scene, o, d, seed, dL, state_in):
                out = fn(cfg, scene, o, d, seed, dL, state_in)
                self.steps[-1]["adjoint"] = dict(cfg=cfg, scene=scene, o=o, d=d, seed=seed,
                                                 dL=dL, L=state_in, res=out[1], stats=out[2])
                return out
            return run

        def drt(fn):
            def run(cfg, scene, seed, res, adjoint, acc):
                self.steps[-1]["drt"] = dict(seed=seed, res=res, adjoint=adjoint)
                return fn(cfg, scene, seed, res, adjoint, acc)
            return run

        def grads(fn):
            def run(*a):
                g = fn(*a)
                self.steps[-1]["grads"] = g
                return g
            return run

        for mod, name, wrap in ((self.loop, "_make_step", make_step),
                                (self.loop, "sample_batch_pixels", timed),
                                (self.loop, "gather_ref_values", timed),
                                (vs, "adjoint_walk_kernel", adjoint_walk),
                                (vs, "drt_backward_kernel", drt),
                                (vs, "sample_adjoint_kernel", grads)):
            self.saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, wrap(getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)
        self.vs.TIMINGS = None


def step_parts(rec):
    """A recorded step's parts (ms): consecutive spans of the device's
    timeline between its CUDA events, which add up to the step, and each
    backward kernel's own launch."""
    def ms(a, b):
        return a.elapsed_time(b)
    L = rec["launches"]
    i_adj = next(i for i, x in enumerate(L) if x[0] == "volpath_adjoint")
    prim = [x for x in L[:i_adj] if x[0] == "volpath_primal"]
    fwd, replay = prim[:-1], prim[-1]
    one = {x[0]: x for x in L[i_adj:] if x[0] in ADJ_KERNELS}
    last = max(one.values(), key=L.index)
    k_fwd = sum(ms(s, e) for _, s, e in fwd)
    kern = {k: ms(s, e) for k, (_, s, e) in one.items()}
    return {"pixels": sum(ms(s, e) for _, s, e in rec["pre"]),
            "forward_kernels": k_fwd, "forward_launches": len(fwd),
            "forward_rays_mean": ms(rec["start"], fwd[-1][2]) - k_fwd,
            "loss_adjoint_rays": ms(fwd[-1][2], replay[1]),
            "replay": ms(replay[1], replay[2]), **kern,
            "backward_other": ms(replay[2], last[2]) - sum(kern.values()),
            "grads_adam_projection": ms(last[2], rec["end"]),
            "step": ms(rec["start"], rec["end"])}


class Laps:
    """Host-clock stamps (with a device sync on either side) of calls of
    ``module.<name>``, for the plain twin's parts."""

    def __init__(self, module, names):
        self.module, self.names, self.stamps, self.saved = module, names, {}, {}

    def __enter__(self):
        import torch

        def wrap(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.stamps[name] = (t0, time.perf_counter())
                return out
            return run
        for name in self.names:
            self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def phase_adjoint(card, dev, vs, janga, dust, cube, rays_of):
    """The adjoint walk (after one replay primal each): the kernel with K6
    on against K6 off on the same inputs (draws and reservoir depth equal on
    every lane, gradients within a relative L1 of 1e-4, the atomics' order
    aside), and against the twin where ``need`` is given."""
    import torch
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.integrators import volpath_flat
    rs = np.random.RandomState(20261017)
    runs = [("janga-smoke", janga, "volpathsimple-drt", {}, 8192, 0.90),
            ("janga-smoke", janga, "volpathsimple-basic", {"shadow_rr": 0.05}, 8192, 0.90),
            ("dust-devil", dust, "volpathsimple-drt", {}, 8192, None),
            ("tiny-cube", cube, "volpathsimple-drt", {}, 16384, 0.95),
            ("tiny-cube", cube, "volpathsimple-drt", {"use_nee": False}, 16384, 0.95)]
    for name, (preset, b, sc), integ, kw, n, need in runs:
        cfg = dataclasses.replace(get_int_config(integ).create(max_depth=preset.max_depth), **kw)
        off = no_cls(sc)
        o, d = rays_of(b, n)
        dL = torch.from_numpy(rs.rand(n, 3).astype(np.float32) / n).to(dev)
        seed = 4242
        Lk, _ = vs.sample_primal_kernel(cfg, sc, o, d, seed)
        acc_k, res_k, st_k = vs.adjoint_walk_kernel(cfg, sc, o, d, seed, dL, Lk)
        acc_o, res_o, st_o = vs.adjoint_walk_kernel(cfg, off, o, d, seed, dL, Lk)
        torch.cuda.synchronize()
        k_ms, off_ms = on_off_ms(lambda: vs.adjoint_walk_kernel(cfg, sc, o, d, seed, dL, Lk),
                                 lambda: vs.adjoint_walk_kernel(cfg, off, o, d, seed, dL, Lk), 1)
        on_off = {k: equal_frac(st_k[k], st_o[k]) for k in ("dim", "alt_dim", "steps")}
        on_off["reservoir_depth"] = equal_frac(res_k.depth, res_o.depth)
        on_off_rel = {"sigma": rel_l1(acc_k.sigma, acc_o.sigma),
                      "albedo": rel_l1(acc_k.albedo, acc_o.albedo)}
        rec = {"phase": "adjoint", "scene": name, "integrator": integ, **kw, "rays": n,
               "cls_on_off_agreement": on_off, "cls_on_off_rel_l1": on_off_rel,
               "cls": cls_counts(st_k["cls"]), "kernel_ms": k_ms, "kernel_ms_cls_off": off_ms,
               "events": int(st_k["steps"].sum()), "card": card}
        bad = min(on_off.values()) < 1.0 or max(on_off_rel.values()) > 1e-4
        if need is not None:
            t0 = time.perf_counter()
            Lt, _ = volpath_flat.sample_primal(cfg, sc, o, d, seed, deferred=True)
            acc_t, res_t, st_t = volpath_flat.adjoint_walk(cfg, sc, o, d, seed, dL, Lt,
                                                           deferred=True)
            torch.cuda.synchronize()
            agree = {"dim": equal_frac(st_k["dim"], st_t["dim"]),
                     "alt_dim": equal_frac(st_k["alt_dim"], st_t["alt_dim"]),
                     "reservoir_depth": equal_frac(res_k.depth, res_t.depth)}
            rel = {"sigma": rel_l1(acc_k.sigma, acc_t.sigma),
                   "albedo": rel_l1(acc_k.albedo, acc_t.albedo)}
            rec.update({"agreement": agree, "need": need, "rel_l1": rel,
                        "max_abs_err": max(float((acc_k.sigma - acc_t.sigma).abs().max()),
                                           float((acc_k.albedo - acc_t.albedo).abs().max())),
                        "grad_abs_sum": float(acc_t.sigma.abs().sum()),
                        "plain_ms": (time.perf_counter() - t0) * 1e3})
            bad = bad or min(agree.values()) < need or max(rel.values()) > 1e-2 \
                or not rec["grad_abs_sum"] > 0
        emit(rec)
        if bad:
            raise RuntimeError(f"adjoint {name} {integ} {kw}: the kernel disagrees with "
                               "itself without K6 or with the twin")


def check_step(card, vs, tag, step):
    """A recorded training step's kernels against the twins, at the shapes
    the step gave them: the adjoint call's per-lane primary draws, alt
    draws and reservoir depth on its last SLICE rays (the twin keyed by
    their ray ids), and ``drt_backward_kernel`` against
    ``_drt_backward_flat`` on all of the step's reservoirs (the twin's
    global-counter sampler admits no subset)."""
    import torch
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.scene.gradients import init_accum
    a, dr = step["adjoint"], step["drt"]
    cfg, sc = a["cfg"], a["scene"]
    n = a["o"].shape[0]
    sl = slice(n - SLICE, n)
    t0 = time.perf_counter()
    Lt, _ = volpath_flat.sample_primal(cfg, sc, a["o"][sl], a["d"][sl], a["seed"],
                                       lane0=n - SLICE, deferred=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, res_t, st_t = volpath_flat.adjoint_walk(cfg, sc, a["o"][sl], a["d"][sl], a["seed"],
                                               a["dL"][sl], a["L"][sl], lane0=n - SLICE,
                                               deferred=True)
    torch.cuda.synchronize()
    adj_plain_ms = (time.perf_counter() - t1) * 1e3
    adj_agree = {"replay_L": lane_agreement(a["L"][sl], Lt),
                 "dim": equal_frac(a["stats"]["dim"][sl], st_t["dim"]),
                 "alt_dim": equal_frac(a["stats"]["alt_dim"][sl], st_t["alt_dim"]),
                 "reservoir_depth": equal_frac(a["res"].depth[sl], res_t.depth)}
    adj_err = max(float((a["res"].wsum[sl] - res_t.wsum).abs().max()),
                  float((a["res"].cur_w[sl] - res_t.cur_w).abs().max()))
    g = step["grads"]
    adj_rec = {"phase": "adjoint_step", "step": tag, "adjoint_rays": n,
               "adjoint_slice": [n - SLICE, n], "adjoint_agreement": adj_agree,
               "need": 0.90, "adjoint_max_abs_err": adj_err, "adjoint_plain_ms": adj_plain_ms,
               "adjoint_primal_plain_ms": (t1 - t0) * 1e3,
               "adjoint_cls": cls_counts(a["stats"]["cls"]),
               "grads_finite": bool(torch.isfinite(g.sigma_t).all()
                                    and torch.isfinite(g.albedo).all()),
               "grads_abs_sum": [float(g.sigma_t.abs().sum()), float(g.albedo.abs().sum())],
               "card": card}
    emit(adj_rec)
    if min(adj_agree.values()) < 0.90:
        raise RuntimeError(f"adjoint_step {tag}: volpath_adjoint disagrees with the twin")
    if not (adj_rec["grads_finite"] and min(adj_rec["grads_abs_sum"]) > 0):
        raise RuntimeError(f"adjoint_step {tag}: the step's gradients are not finite and nonzero")

    m = sc.medium
    acc_k, k = vs.drt_backward_kernel(cfg, sc, dr["seed"], dr["res"], dr["adjoint"],
                                      init_accum(m, need_emission=False), return_stats=True)
    rec = {"phase": "drt", "step": tag, "reservoirs": n,
           "vertices": int((dr["res"].active & k["found"]).sum()),
           "K_A": k["k_a"], "K_B": k["k_b"], "recursive_cls": cls_counts(k["rec_stats"]["cls"]),
           "card": card}
    acc_t = init_accum(m, need_emission=False)
    with Laps(volpath_flat, ("drt_distance", "_nee_primal", "sample_primal")) as laps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, p = volpath_flat._drt_backward_flat(cfg, sc, dr["seed"], dr["res"], dr["adjoint"],
                                               acc_t, return_stats=True, deferred=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    st = laps.stamps
    walk_end = st["drt_distance"][1]
    nee_end = st["_nee_primal"][1] if cfg.use_nee else walk_end
    drt_plain_ms = {"volpath_drt_walk": (walk_end - t0) * 1e3,
                    "volpath_drt_nee": (nee_end - walk_end) * 1e3,
                    "volpath_drt_phase": (st["sample_primal"][0] - nee_end) * 1e3,
                    "volpath_primal_state": (st["sample_primal"][1] - st["sample_primal"][0]) * 1e3,
                    "volpath_drt_scatter": (t1 - st["sample_primal"][1]) * 1e3}
    both = k["path_state"].active & p["path_state"].active
    agree = {f: equal_frac(k[f], p[f]) for f in ("t_sel", "wsum", "found")}
    agree["path_state_active"] = equal_frac(k["path_state"].active, p["path_state"].active)
    agree["recursive_L"] = lane_agreement(k["rec_L"][both], p["rec_L"][both])
    rel = {"sigma": rel_l1(acc_k.sigma, acc_t.sigma), "albedo": rel_l1(acc_k.albedo, acc_t.albedo)}
    rec.update({
        "K_A_plain": int(p["k_a"]), "K_B_plain": int(p["k_b"]),
        "drt_agreement": agree, "need": 0.90, "drt_rel_l1": rel,
        "drt_max_abs_err": {
            "volpath_drt_walk": float((k["wsum"] - p["wsum"]).abs().max()),
            "volpath_drt_nee": float((k["nee"][both] - p["nee"][both]).abs().max()),
            "volpath_drt_phase": float((k["path_state"].d_w[both]
                                        - p["path_state"].d_w[both]).abs().max()),
            "volpath_primal_state": float((k["rec_L"][both] - p["rec_L"][both]).abs().max()),
            "volpath_drt_scatter": max(float((acc_k.sigma - acc_t.sigma).abs().max()),
                                       float((acc_k.albedo - acc_t.albedo).abs().max()))},
        "drt_plain_ms": drt_plain_ms, "drt_plain_total_ms": (t1 - t0) * 1e3})
    emit(rec)
    if min(agree.values()) < 0.90 or [k["k_a"], k["k_b"]] != [int(p["k_a"]), int(p["k_b"])] \
            or max(rel.values()) > 1e-2 or not float(acc_t.sigma.abs().sum()) > 0:
        raise RuntimeError(f"drt {tag}: the DRT kernels disagree with the twin")
    return dict(adj_rec, **rec, drt_stats=k)


def phase_train(card, vs, scene, out_dir, n_iter, ref_spp, opt_kw=None, checkpoints=True,
                ref_bundle=None, need=()):
    """run_optimization of volpathsimple-drt at the preset's full width
    (batch 32,768 pixels, 16 adjoint spp, primal factor 64), ``n_iter``
    iterations from the constant start with the grids at full resolution
    (no upsampling), then one step of it from the ground-truth grids; both
    recorded by StepRecorder.  The counters are set to 0 just before the
    main run: every training kernel, K6 and the counters ``need`` name must
    launch, no twin may run, the parameters must change (and with
    ``checkpoints`` the .vol files read back).  The references are
    rendered from ``ref_bundle`` (the preset's reference scene) where it
    is given, else from the training bundle's grids, for the bundle's
    training sensors."""
    import torch
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.core import vol_io
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.opt import OptimizationConfig, loop, render_references
    from uivr_tpu_torch.render import RenderSettings
    preset, b, _ = scene
    name = preset.name
    cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
    out_dir = out_dir / name
    t0 = time.perf_counter()
    rb = ref_bundle or b
    refs = render_references(rb, RenderSettings(integrator=cfg, medium=rb.medium_cfg,
                                                film_size=rb.film_size, spp=ref_spp,
                                                spp_grad=ref_spp),
                             str(out_dir / "references"), spp=ref_spp, overwrite=True,
                             sensors=list(b.sensors) if b.sensors else None)
    ref_s = time.perf_counter() - t0
    width = dict(spp=16, lr=5e-3, primal_spp_factor=64, batch_size=32768, upsample=None,
                 preview_spp=16)
    width.update(opt_kw or {})
    opt = OptimizationConfig(name=f"{name}/volpathsimple-drt", n_iter=n_iter,
                             preview_stride=0, checkpoint_stride=2 if checkpoints else 0,
                             checkpoint_initial=checkpoints, checkpoint_final=checkpoints,
                             render_initial=False, **width)
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    for k in volpath_flat.CALLS:
        volpath_flat.CALLS[k] = 0
    with StepRecorder(vs, loop) as main:
        t0 = time.perf_counter()
        final = loop.run_optimization(str(out_dir / "train"), opt, b, cfg, ref_images=refs,
                                      resume=False, verbose=False)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = dict(vs.LAUNCHES)
    plain_calls = dict(volpath_flat.CALLS)
    # one step from the ground-truth grids: walks as long as late in a run
    one = OptimizationConfig(name=f"{name}/truth", n_iter=1, preview_stride=0,
                             checkpoint_stride=0, checkpoint_initial=False,
                             checkpoint_final=False, render_initial=False,
                             render_final=False, **width)
    with StepRecorder(vs, loop) as truth:
        loop.run_optimization(str(out_dir / "truth"), one, b, cfg, ref_images=refs,
                              start_params=b.params, resume=False, verbose=False)
    vols = {}
    if checkpoints:
        for tag, grids in (("initial", b.start_from), ("final", final)):
            for key in ("sigma_t", "albedo"):
                data, _ = vol_io.read_vol(str(out_dir / "train" / "params"
                                              / f"{tag}-medium1_{key}.vol"))
                vols[f"{tag}_{key}"] = bool(np.array_equal(data, getattr(grids, key).cpu().numpy()))
    changed = {k: not torch.equal(getattr(final, k), getattr(b.start_from, k))
               for k in ("sigma_t", "albedo")}
    steps = [{"seconds": s["seconds"], "loss": s["loss"], "launches": s["counts"],
              "parts_ms": step_parts(s)} for s in main.steps + truth.steps]
    rec = {"phase": "train", "scene": name, "integrator": "volpathsimple-drt",
           "batch": 32768, "spp_primal": 1024, "spp_grad": 16,
           "grid": list(b.params.sigma_t.shape), "sensors": b.cameras.n_sensors,
           "lr": opt.lr, "lr_factors": opt.lr_factors,
           "ref_spp": ref_spp, "references_s": ref_s, "run_s": run_s,
           "iterations": steps[:-1], "truth_step": steps[-1],
           "truth_adjoint_cls": cls_counts(truth.steps[0]["adjoint"]["stats"]["cls"]),
           "launches": launches, "plain_twin_calls": plain_calls,
           "checkpoints_read_back": vols, "params_changed": changed, "card": card}
    emit(rec)
    missing = [k for k in TRAIN_KERNELS + ("subcell_classification",) + tuple(need)
               if not launches[k] > 0]
    if missing or any(plain_calls.values()):
        raise RuntimeError(f"{name}: training did not run through the kernels: missing "
                           f"{missing}, plain twin calls {plain_calls}")
    if not (all(changed.values()) and all(vols.values()) and len(main.steps) == n_iter
            and all(math.isfinite(s_["loss"]) for s_ in steps)):
        raise RuntimeError(f"{name}: training step checks failed")
    return rec, main.steps[0], truth.steps[0]


def phase_fd(card, vs, out_dir):
    """``python -m uivr_tpu_torch.cli.fd`` on tiny-cube (spp 1024, res 16,
    all three grids) under volpathsimple-drt and volpathsimple-basic, with
    K6 on and off (``--cls-cells 0``): each run launches the kernels and no
    twin; off writes the same FD values and adjoint gradients."""
    import torch
    from uivr_tpu_torch.cli import fd as cli_fd
    from uivr_tpu_torch.integrators import volpath_flat
    keys = ("sigma_t", "albedo", "emission")
    out = {}
    for integ in ("volpathsimple-drt", "volpathsimple-basic"):
        runs = {}
        for tag, extra in (("on", []), ("off", ["--cls-cells", "0"])):
            d = out_dir / "fd" / integ / tag
            for k in vs.LAUNCHES:
                vs.LAUNCHES[k] = 0
            for k in volpath_flat.CALLS:
                volpath_flat.CALLS[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = cli_fd.main(["--scene", "tiny-cube", "--integrator", integ,
                                   "--spp", "1024", "--res", "16", "--out", str(d)] + extra)
            torch.cuda.synchronize()
            runs[tag] = {"seconds": time.perf_counter() - t0, "summary": summary,
                         "launches": {k: v for k, v in vs.LAUNCHES.items() if v},
                         "plain_twin_calls": dict(volpath_flat.CALLS),
                         "fd": {k: np.load(d / f"fd_{k}.npy") for k in keys},
                         "adjoint": {k: np.load(d / f"adjoint_{k}.npy") for k in keys}}
        on, off = runs["on"], runs["off"]

        def rel(a, b):
            return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))
        rec = {"phase": "fd", "scene": "tiny-cube", "integrator": integ, "spp": 1024,
               "res": 16, "keys": list(keys),
               "summary": on["summary"], "summary_cls_off": off["summary"],
               "fd_equal_cls_off": all(np.array_equal(on["fd"][k], off["fd"][k]) for k in keys),
               "fd_rel_l1_cls_off": {k: rel(on["fd"][k], off["fd"][k]) for k in keys},
               "adjoint_rel_l1_cls_off": {k: rel(on["adjoint"][k], off["adjoint"][k])
                                          for k in keys},
               "seconds": {t: r["seconds"] for t, r in runs.items()},
               "launches": {t: r["launches"] for t, r in runs.items()},
               "plain_twin_calls": {t: r["plain_twin_calls"] for t, r in runs.items()},
               "card": card}
        emit(rec)
        need = ["volpath_primal", "volpath_adjoint"]
        if integ == "volpathsimple-drt":
            need += list(ADJ_KERNELS)
        ok = all(r["launches"].get(k, 0) > 0 for r in runs.values() for k in need)
        ok = ok and on["launches"].get("subcell_classification", 0) > 0 \
            and "subcell_classification" not in off["launches"]
        ok = ok and not any(v for r in runs.values() for v in r["plain_twin_calls"].values())
        ok = ok and max(rec["fd_rel_l1_cls_off"].values()) <= 1e-4 \
            and max(rec["adjoint_rel_l1_cls_off"].values()) <= 1e-4
        ok = ok and all(math.isfinite(v) for s_ in on["summary"].values() for v in s_.values())
        if not ok:
            raise RuntimeError(f"fd {integ}: the FD entry point failed its checks")
        out[integ] = rec
    return out


def phase_cli(card, out_dir):
    """The reproduce CLI on tiny-cube: 20 iterations at batch 557."""
    import json as json_
    from uivr_tpu_torch.cli import reproduce
    outputs = out_dir / "cli"
    if outputs.exists():
        import shutil
        shutil.rmtree(outputs)
    t0 = time.perf_counter()
    reproduce.main(["--config", "tiny-cube", "--integrator", "volpathsimple-drt",
                    "--scale", "0.034", "--ref-spp", "16", "--outputs", str(outputs)])
    dt = time.perf_counter() - t0
    run = outputs / "tiny-cube" / "volpathsimple-drt"
    with open(run / "metrics.jsonl") as f:
        recs = [json_.loads(ln) for ln in f]
    losses_ = [r["loss"] for r in recs if "loss" in r]
    final = run / "params" / "final-medium1_sigma_t.vol"
    rec = {"phase": "cli", "command": "reproduce --config tiny-cube --integrator "
           "volpathsimple-drt --scale 0.034 --ref-spp 16", "seconds": dt,
           "losses": losses_, "final_checkpoint": final.exists(), "card": card}
    emit(rec)
    if not (losses_ and all(math.isfinite(x) for x in losses_) and final.exists()):
        raise RuntimeError("cli: no losses or no final checkpoint")


def table_bytes(scene):
    """Bytes of the tables every walking kernel reads: the (D,H,W,4)
    sigma+albedo grid, the majorant supergrid and the envmap's tables."""
    m, em = scene.medium, scene.emitter
    env = sum(getattr(em, f).numel() for f in ("data", "alias_tab", "row_pmf", "cond_pmf")
              if hasattr(em, f))
    return (m.grid.numel() + m.majorant_grid.numel() + env) * 4


def adjoint_bound(n, stats, cfg, scene):
    """Least time of volpath_adjoint at this run's counts: the bytes it must
    move (tables read once; o, d, L, dL in; reservoir and counters out, 137 B
    a ray; the sigma and albedo gradient grids written once) against the
    flops of its events.  ``gather_ms`` counts instead the bytes its events
    fetch: 132 B per event (8 B for an event K6 classified), 128 B of atomics
    per real collision, 32 B per transmittance sample and per replay
    collision, 120 B per ray."""
    events = int(stats["steps"].sum())
    real = int(stats["events"][:, 0].sum())
    replay = int(stats["events"][:, 1].sum())
    per_seg = cfg.trans_grad_samples + int(cfg.use_drt and cfg.use_drt_subsampling)
    samples = int(stats["alt_dim"].sum()) // per_seg * cfg.trans_grad_samples
    # every event hashes two primary draws (REPLAY re-reads them at rp_dim
    # without advancing dim); alt draws and the primary stream's draws
    # beyond two an event are extra
    extra_draws = int(stats["alt_dim"].sum()) + max(0, int(stats["dim"].sum()) - 2 * events)
    grads = scene.medium.params.sigma_t[..., 0].numel() * 16
    req = bound(table_bytes(scene) + grads + 137 * n,
                FLOP_PER_STEP * events + FLOP_PER_EXTRA_DRAW * extra_draws)
    gather_ms, _ = bound(event_fetch_bytes(events, cls_counts(stats["cls"])) + 128 * real
                         + 32 * (samples + replay) + 120 * n, 0)
    return req, gather_ms, {"events": events, "real_collisions": real,
                            "replay_collisions": replay, "trans_samples": samples}


def drt_bounds(n, k, res, scene):
    """Least times of the four DRT kernels at this run's counts, from the
    bytes they must move (tables read once, per-lane I/O, the gradient grids
    written once) against their operations (4 + 8 TEA rounds per wavefront
    draw, FLOP_PER_STEP per tracking step); and the bytes their steps fetch
    (132 B per step, 128 B of reads and 128 B of atomics per scattered
    vertex) as ``gather_ms``."""
    hash_ops = TEA_OPS_PER_ROUND * 12
    trips_a = int(k["trips_a"].sum())
    trips_b = int(k["trips_b"].sum())
    active = int((res.active & k["found"]).sum())
    tables = table_bytes(scene)
    m = scene.medium
    grids = m.grid.numel() * 4
    grads = m.params.sigma_t[..., 0].numel() * 16
    req = {
        "volpath_drt_walk": bound(grids + m.majorant_grid.numel() * 4 + n * (29 + 26),
                                  trips_a * (2 * hash_ops + FLOP_PER_STEP)),
        "volpath_drt_nee": bound(tables + n * (25 + 16),
                                 trips_b * (hash_ops + FLOP_PER_STEP) + 2 * hash_ops * active),
        "volpath_drt_phase": bound(n * (12 + 8 + 1 + 48 + 9), n * (2 * hash_ops + 100)),
        "volpath_drt_scatter": bound(grids + grads + n * 1 + active * (12 + 4 + 36),
                                     active * 150),
    }
    gather = {
        "volpath_drt_walk": 132 * trips_a + n * (29 + 26),
        "volpath_drt_nee": 132 * trips_b + 28 * active + n * (25 + 16),
        "volpath_drt_phase": n * (12 + 8 + 1 + 48 + 9),
        "volpath_drt_scatter": n * 1 + active * (12 + 4 + 36 + 128 + 128),
    }
    return req, {key: bound(v, 0)[0] for key, v in gather.items()}, {
        "walk_steps": trips_a, "nee_steps": trips_b, "vertices": active}


def training_kernels(train, truth, check):
    """Kernel-line entries of the training path's kernels: launches in the
    main run (and in its first step); times of their launches in the recorded step from
    the ground-truth grids (walks as long as late in a run), with bounds
    from that step's counts; plain times and errors from ``check_step`` on
    that step."""
    runs = {k: {"launches": train["launches"][k],
                "launches_per_train_step": train["iterations"][0]["launches"][k]}
            for k in TRAIN_KERNELS}
    parts = train["truth_step"]["parts_ms"]
    a = truth["adjoint"]
    cfg, scene, n = a["cfg"], a["scene"], a["o"].shape[0]
    (a_bound, a_by), a_gather, a_counts = adjoint_bound(n, a["stats"], cfg, scene)
    k = check["drt_stats"]
    rec_steps = int(k["rec_stats"]["steps"].sum())
    rec_extra = max(0, int(k["rec_stats"]["dim"].sum()) - 2 * rec_steps)
    s_bound, s_by = bound(table_bytes(scene) + n * (49 + 13),
                          FLOP_PER_STEP * rec_steps + FLOP_PER_EXTRA_DRAW * rec_extra)
    s_gather, _ = bound(event_fetch_bytes(rec_steps, cls_counts(k["rec_stats"]["cls"]))
                        + 28 * rec_extra / 5 + 49 * n, 0)
    d_req, d_gather, d_counts = drt_bounds(n, k, truth["drt"]["res"], scene)
    src = "uivr_tpu_torch/ops/csrc/"
    shape = "janga-smoke step from the ground truth"
    out = [
        {"name": "volpath_adjoint", "route": "cuda", "source": src + "volpath_adjoint.cu",
         "replaces": "uivr_tpu/ops/volpath_step.py:673", **runs["volpath_adjoint"],
         "max_abs_err": check["adjoint_max_abs_err"],
         "ms": parts["volpath_adjoint"], "plain_ms": check["adjoint_plain_ms"],
         "plain_shape": f"{SLICE} of its rays", "bound_ms": a_bound, "bound_by": a_by,
         "gather_bound_ms": a_gather, "library_ms": None,
         "agreement": min(check["adjoint_agreement"].values()),
         "shape": f"{n} adjoint rays, {shape}", **a_counts},
        {"name": "volpath_primal_state", "route": "cuda", "source": src + "volpath_primal.cu",
         "replaces": "uivr_tpu/ops/volpath_step.py:303 (path_state entry)",
         **runs["volpath_primal_state"],
         "max_abs_err": check["drt_max_abs_err"]["volpath_primal_state"],
         "ms": parts["volpath_primal_state"],
         "plain_ms": check["drt_plain_ms"]["volpath_primal_state"],
         "plain_shape": f"{n} path states", "bound_ms": s_bound, "bound_by": s_by,
         "gather_bound_ms": s_gather, "library_ms": None,
         "agreement": check["drt_agreement"]["recursive_L"],
         "shape": f"{n} path states, {shape}", "tracking_steps": rec_steps},
    ]
    replaces = {"volpath_drt_walk": "uivr_tpu/tracking/trackers.py:201",
                "volpath_drt_nee": "uivr_tpu/integrators/volpathsimple.py:95",
                "volpath_drt_phase": "uivr_tpu/integrators/volpath_flat.py:697",
                "volpath_drt_scatter": "uivr_tpu/integrators/volpath_flat.py:720"}
    for name in DRT_KERNELS:
        b_ms, b_by = d_req[name]
        out.append({"name": name, "route": "cuda", "source": src + "volpath_drt.cu",
                    "replaces": replaces[name], **runs[name],
                    "max_abs_err": check["drt_max_abs_err"][name], "ms": parts[name],
                    "plain_ms": check["drt_plain_ms"][name], "plain_shape": f"{n} reservoirs",
                    "bound_ms": b_ms, "bound_by": b_by, "gather_bound_ms": d_gather[name],
                    "library_ms": None,
                    "agreement": min(check["drt_agreement"][f] for f in ("t_sel", "wsum", "found")),
                    "shape": f"{n} reservoirs, {shape}", **d_counts})
    return out


def walking_on_off(vs, step, check):
    """CUDA-event times (ms) of the adjoint and the recursive primal with K6
    on and off, on a recorded training step's own inputs."""
    from uivr_tpu_torch.core.rng import sample_tea_32
    a = step["adjoint"]
    cfg, sc = a["cfg"], a["scene"]
    off = no_cls(sc)
    args = (a["o"], a["d"], a["seed"], a["dL"], a["L"])
    adj = on_off_ms(lambda: vs.adjoint_walk_kernel(cfg, sc, *args),
                    lambda: vs.adjoint_walk_kernel(cfg, off, *args), 1)
    ps = check["drt_stats"]["path_state"]
    rec_seed, _ = sample_tea_32(int(step["drt"]["seed"]), 0x7177)
    rec = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, None, None, rec_seed, path_state=ps),
                    lambda: vs.sample_primal_kernel(cfg, off, None, None, rec_seed, path_state=ps),
                    1)
    n = a["o"].shape[0]
    return {"volpath_adjoint": {"ms_on": adj[0], "ms_off": adj[1],
                                "shape": f"{n} adjoint rays, truth step"},
            "volpath_primal_state": {"ms_on": rec[0], "ms_off": rec[1],
                                     "shape": f"{n} path states, truth step"}}


# ------------------------------------------------------------- XML scenes
# The janga-smoke and dust-devil presets load Mitsuba XML scenes whose
# assets the repository does not hold.  write_standins writes assets of the
# shapes the XML files and the presets' scene vars name, from a seed, into a
# scene directory beside copies of the XML files; UIVR_SCENE_DIR points the
# registry there.  Only the assets' contents are stand-ins.
STANDINS = {
    "janga-smoke": {"sigma": ("volumes/janga-smoke-264-136-136.vol", (136, 264, 136)),
                    "albedo": ("volumes/albedo-noise-256-128-128.vol", (128, 256, 128)),
                    "envmap": ("textures/gamrig_2k.hdr", (1024, 2048))},
    "dust-devil": {"sigma": ("volumes/embergen_dust_devil_tornado_a_50-256-256-256.vol",
                             (256, 256, 256)),
                   "albedo": ("volumes/albedo-constant-sand-256-256-256.vol", (256, 256, 256)),
                   "envmap": ("textures/kloofendal_38d_partly_cloudy_4k.exr", (2048, 4096))},
}


def plume(shape, rs):
    """A smoke-like density on a (D, H, W) grid over the unit cube: 24
    Gaussian blobs with a falloff in height, peak 1 (float32)."""
    z, y, x = (np.linspace(0, 1, n, dtype=np.float32) for n in shape)
    out = np.zeros(shape, np.float32)
    for _ in range(24):
        c = (rs.rand(3) * 0.7 + 0.15).astype(np.float32)
        s = np.float32(rs.rand() * 0.12 + 0.04)
        a = np.float32(rs.rand() * 1.2)
        gx, gy, gz = (np.exp(-(v - cv) ** 2 / (2 * s * s)) for v, cv in zip((x, y, z), c))
        out += a * gz[:, None, None] * gy[None, :, None] * gx[None, None, :]
    out *= np.exp(-2.5 * np.abs(y - 0.4))[None, :, None]
    return out / out.max()


def write_standins(root, seed=20261017):
    """Stand-in assets for the janga-smoke and dust-devil XML scenes under
    ``root``, each beside a copy of its XML file; returns seconds per scene."""
    import shutil
    from uivr_tpu_torch.config.scenes import procedural_sky
    from uivr_tpu_torch.core import exr_io, hdr_io, vol_io
    rs = np.random.RandomState(seed)
    seconds = {}
    for name, files in STANDINS.items():
        t0 = time.perf_counter()
        d = root / name
        (d / "volumes").mkdir(parents=True, exist_ok=True)
        (d / "textures").mkdir(parents=True, exist_ok=True)
        shutil.copy(HERE / "scenes" / name / f"{name}.xml", d / f"{name}.xml")
        path, shape = files["sigma"]
        vol_io.write_vol(str(d / path), plume(shape, rs)[..., None])
        path, shape = files["albedo"]
        if name == "janga-smoke":   # noise in [0.5, 0.95]
            alb = rs.uniform(0.5, 0.95, shape + (3,)).astype(np.float32)
        else:                       # a constant sand colour
            alb = np.broadcast_to(np.array([0.76, 0.62, 0.45], np.float32), shape + (3,))
        vol_io.write_vol(str(d / path), alb)
        path, (h, w) = files["envmap"]
        sky = procedural_sky(h, w)
        if path.endswith(".hdr"):
            hdr_io.write_hdr(str(d / path), sky)
        else:
            exr_io.write_exr(str(d / path), sky, compression="none")
        seconds[name] = time.perf_counter() - t0
    return seconds


def xml_scene(name, dev, ref=False):
    """(preset, bundle, scene) of an XML preset from $UIVR_SCENE_DIR: the
    training scene, or the reference scene with ``ref``."""
    from uivr_tpu_torch.config import get_scene_config
    from uivr_tpu_torch.scene.medium import finalize_medium
    from uivr_tpu_torch.scene.scene import Scene
    preset = get_scene_config(name)
    b = preset.build_ref(device=dev) if ref else preset.build(device=dev)
    return preset, b, Scene(finalize_medium(b.params, b.medium_cfg, b.to_world),
                            b.emitter, b.cameras)


def full_res(sc):
    """The same scene with K3 instead of K3b: its envmap without the coarse
    proxy, which is what make_envmap(data, nee_max_texels=0) builds."""
    return sc._replace(emitter=sc.emitter._replace(nee=None))


def xml_scene_record(name, b, sc, seconds):
    m, em = sc.medium, sc.emitter
    return {"phase": "xml_scene", "scene": name, "load_s": seconds,
            "film": list(b.film_size), "sensors": b.cameras.n_sensors,
            "training_sensors": len(b.sensors) if b.sensors else None,
            "sigma_t": list(b.params.sigma_t.shape), "albedo": list(b.params.albedo.shape),
            "majorant_resolution_factor": b.medium_cfg.majorant_factor,
            "majorant_cells": list(m.majorant_grid.shape),
            "subcells": list(m.sub.shape) if m.sub is not None else None,
            "envmap": list(em.data.shape[:2]), "envmap_texels": em.data.shape[0] * em.data.shape[1],
            "proxy": list(em.nee.data.shape[:2]) if em.nee is not None else None,
            "medium_to_world": np.asarray(b.to_world).round(6).tolist()}


def render_each(b, settings, seed, spp, turns=False, sensor=0):
    """Full-frame renders of ``sensor`` through ``render_image``, one per
    entry of ``settings`` (name -> (RenderSettings, emitter)), or in turns
    (a, b, b, a) with ``turns``: the images and each one's mean host-clock
    seconds."""
    import torch
    from uivr_tpu_torch.render import batched
    names = list(settings)
    imgs, secs = {}, {k: [] for k in names}
    for k in (names + names[::-1] if turns else names):
        st, emitter = settings[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs[k] = batched.render_image(st, b.params, emitter, b.cameras, sensor,
                                       seed=seed, spp=spp, medium_to_world=b.to_world)
        secs[k].append(time.perf_counter() - t0)
    return imgs, {k: sum(v) / len(v) for k, v in secs.items()}


def paired_means(a, b):
    """Per channel: the image means of ``a`` and ``b``, the mean of their
    per-pixel difference and its standard error from the per-pixel spread."""
    diff = (a - b).reshape(-1, 3).astype(np.float64)
    n = diff.shape[0]
    return {"mean_a": a.reshape(-1, 3).mean(0).tolist(), "mean_b": b.reshape(-1, 3).mean(0).tolist(),
            "mean_diff": diff.mean(0).tolist(),
            "se_diff": (diff.std(0, ddof=1) / math.sqrt(n)).tolist()}


def k3b_chunk_bound(o, sc, stats):
    """bound_ms of volpath_primal with K3b on one chunk: rays, grid,
    majorant, subcell table, the full-resolution map (radiance) and the
    proxy's tables read once, radiance and escapes written once, against
    the operations of this chunk's tracking steps and draws; and the fetch
    model's bound (132 B per event, 8 B if K6 classified it, 28 B per NEE
    sample: 16 B of proxy table and 12 B of radiance, 36 B per ray)."""
    m, em = sc.medium, sc.emitter
    n = o.shape[0]
    steps = int(stats["steps"].sum())
    extra = int(stats["dim"].sum()) - 2 * steps
    tables = m.grid.numel() + m.majorant_grid.numel() + m.sub.numel() + em.data.numel() \
        + sum(t.numel() for t in (em.nee.alias_tab, em.nee.row_pmf, em.nee.cond_pmf))
    req = bound(24 * n + 4 * tables + 13 * n,
                FLOP_PER_STEP * steps + FLOP_PER_EXTRA_DRAW * extra)
    gather, _ = bound(event_fetch_bytes(steps, cls_counts(stats["cls"])) + 28 * extra / 5
                      + 36 * n, 0)
    return req, gather, {"tracking_steps": steps, "extra_draws": extra}


def phase_xml(card, vs, dev, out_dir, random_pixel_rays, render_chunk):
    """The XML path: janga-smoke's XML preset at full width (render CLI,
    K3b against its plain version and against K3, run_optimization) and
    dust-devil's 4k map (render, K3b and K3 timed in turns).  Returns the
    kernels-line entry of K3b and the XML records."""
    import os
    import tempfile

    import torch
    from uivr_tpu_torch.cli import render as cli_render
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.core import exr_io
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.render import batched
    tmp = tempfile.TemporaryDirectory(prefix="uivr_scenes_", dir=out_dir)
    root = Path(tmp.name)
    asset_s = write_standins(root)
    os.environ["UIVR_SCENE_DIR"] = str(root)
    try:
        return _xml_phases(card, vs, dev, out_dir, random_pixel_rays, render_chunk,
                           asset_s, cli_render, get_int_config, exr_io, volpath_flat,
                           batched, torch)
    finally:
        del os.environ["UIVR_SCENE_DIR"]
        tmp.cleanup()


def _xml_phases(card, vs, dev, out_dir, random_pixel_rays, render_chunk, asset_s,
                cli_render, get_int_config, exr_io, volpath_flat, batched, torch):
    out = {}
    # ----------------------------------------------------------- xml-render
    exr = out_dir / "janga-smoke-xml-s0.exr"
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    for k in volpath_flat.CALLS:
        volpath_flat.CALLS[k] = 0
    t0 = time.perf_counter()
    img, dt = cli_render.main(["--scene", "janga-smoke", "--sensor", "0", "--spp", "64",
                               "--out", str(exr)])
    cli_s = time.perf_counter() - t0
    launches, plain = dict(vs.LAUNCHES), dict(volpath_flat.CALLS)
    back = exr_io.read_exr(str(exr))
    t0 = time.perf_counter()
    preset, b, sc = xml_scene("janga-smoke", dev)
    load_s = time.perf_counter() - t0
    emit(dict(xml_scene_record("janga-smoke", b, sc, load_s), assets_s=asset_s, card=card))
    W, H = b.film_size
    rays = W * H * 64
    rec = {"phase": "xml_render", "scene": "janga-smoke", "sensor": 0, "spp": 64,
           "film": [W, H], "rays": rays, "seconds": dt, "cli_seconds": cli_s,
           "mrays_per_s": rays / dt / 1e6, "image_mean": img.reshape(-1, 3).mean(0).tolist(),
           "launches": launches, "plain_twin_calls": plain, "exr_shape": list(back.shape),
           "exr_matches": bool(np.array_equal(back, img)), "card": card}
    emit(rec)
    if not (launches["volpath_primal"] > 0
            and launches["deferred_nee"] == launches["volpath_primal"]
            and launches["subcell_classification"] > 0 and not any(plain.values())):
        raise RuntimeError(f"janga-smoke XML: the render did not run K3b in the kernel: "
                           f"{launches}, plain twin calls {plain}")
    if back.shape != (H, W, 3) or not np.isfinite(back).all() or not np.array_equal(back, img):
        raise RuntimeError("janga-smoke XML: the rendered EXR is malformed")
    out["render"] = rec

    # ------------------------------------- K3b against its plain version
    cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
    seed = 4242
    o, d = random_pixel_rays(b, 1 << 16)
    Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lp, ep, sp = volpath_flat.sample_primal(cfg, sc, o, d, seed, return_stats=True,
                                            deferred=True)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    Lf, _ = vs.sample_primal_kernel(cfg, full_res(sc), o, d, seed)
    agree = lane_agreement(Lk, Lp)
    mk, mp = Lk.mean(0).tolist(), Lp.mean(0).tolist()
    means_ok = all(abs(a - b_) <= 0.02 * abs(b_) for a, b_ in zip(mk, mp))
    rec = {"phase": "k3b_primal", "scene": "janga-smoke (XML)", "rays": o.shape[0],
           "agreement": agree, "need": 0.90, "same_draws": equal_frac(sk["dim"], sp["dim"]),
           "escaped_equal": equal_frac(ek, ep), "mean_kernel": mk, "mean_plain": mp,
           "max_abs_err": float((Lk - Lp).abs().max()), "plain_ms": p_ms,
           "lanes_differing_from_k3": float((Lk != Lf).any(dim=-1).float().mean()),
           "card": card}
    emit(rec)
    if agree < 0.90 or not means_ok:
        raise RuntimeError("K3b: volpath_primal disagrees with the deferred twin")
    out["primal"] = rec
    n = 8192
    o, d = random_pixel_rays(b, n)
    dL = torch.from_numpy(np.random.RandomState(7).rand(n, 3).astype(np.float32) / n).to(dev)
    Lk, _ = vs.sample_primal_kernel(cfg, sc, o, d, seed)
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    acc_k, res_k, st_k = vs.adjoint_walk_kernel(cfg, sc, o, d, seed, dL, Lk)
    adj_deferred = vs.LAUNCHES["deferred_nee"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc_t, res_t, st_t = volpath_flat.adjoint_walk(cfg, sc, o, d, seed, dL, Lk, deferred=True)
    torch.cuda.synchronize()
    adj_plain_ms = (time.perf_counter() - t0) * 1e3
    agree = {"dim": equal_frac(st_k["dim"], st_t["dim"]),
             "alt_dim": equal_frac(st_k["alt_dim"], st_t["alt_dim"]),
             "reservoir_depth": equal_frac(res_k.depth, res_t.depth)}
    rel = {"sigma": rel_l1(acc_k.sigma, acc_t.sigma), "albedo": rel_l1(acc_k.albedo, acc_t.albedo)}
    rec = {"phase": "k3b_adjoint", "scene": "janga-smoke (XML)", "rays": n,
           "agreement": agree, "need": 0.90, "rel_l1": rel, "plain_ms": adj_plain_ms,
           "deferred_launches": adj_deferred, "grad_abs_sum": float(acc_t.sigma.abs().sum()),
           "card": card}
    emit(rec)
    if min(agree.values()) < 0.90 or max(rel.values()) > 1e-2 or adj_deferred != 1 \
            or not rec["grad_abs_sum"] > 0:
        raise RuntimeError("K3b: volpath_adjoint disagrees with the deferred twin")

    # ------- K3b at the render's chunk: against its plain version, K3, bound
    co, cd = render_chunk(b)
    seed0 = 1234
    Lk, ek, ck = vs.sample_primal_kernel(cfg, sc, co, cd, seed0, return_stats=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lp, ep, sp = volpath_flat.sample_primal(cfg, sc, co, cd, seed0, return_stats=True,
                                            deferred=True)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    k3b_ms, k3_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, co, cd, seed0),
                              lambda: vs.sample_primal_kernel(cfg, full_res(sc), co, cd, seed0), 2)
    (b_ms, b_by), g_ms, counts = k3b_chunk_bound(co, sc, ck)
    agree = lane_agreement(Lk, Lp)
    mk, mp = Lk.mean(0).tolist(), Lp.mean(0).tolist()
    means_ok = all(abs(a - b_) <= 0.02 * abs(b_) for a, b_ in zip(mk, mp))
    rec = {"phase": "k3b_chunk", "scene": "janga-smoke (XML)", "rays": co.shape[0],
           "agreement": agree, "need": 0.90, "same_draws": equal_frac(ck["dim"], sp["dim"]),
           "escaped_equal": equal_frac(ek, ep), "mean_kernel": mk, "mean_plain": mp,
           "max_abs_err": float((Lk - Lp).abs().max()), "plain_ms": p_ms,
           "ms": {"k3b": k3b_ms, "k3": k3_ms}, "card": card}
    emit(rec)
    if agree < 0.90 or not means_ok:
        raise RuntimeError("K3b: volpath_primal disagrees with the deferred twin on the "
                           "render's chunk")
    out["chunk"] = rec

    # ---------------------------------------------------------- unbiasedness
    # K3b and K3 against each other and against the estimator without NEE
    # (escapes only, no alias table), whose mean is that of the same
    # integral; pixels are independent, so the per-pixel spread of each
    # paired difference gives its standard error
    st = batched.RenderSettings(integrator=cfg, medium=b.medium_cfg, film_size=b.film_size,
                                spp=256, spp_grad=256)
    no_nee = dataclasses.replace(st, integrator=dataclasses.replace(cfg, use_nee=False))
    imgs, secs = render_each(b, {"k3b": (st, sc.emitter), "k3": (st, full_res(sc).emitter),
                                 "no_nee": (no_nee, sc.emitter)}, seed=99, spp=256)
    pairs = {f"{a}-{c_}": paired_means(imgs[a], imgs[c_])
             for a, c_ in (("k3b", "no_nee"), ("k3", "no_nee"), ("k3b", "k3"))}
    for v in pairs.values():
        v["z"] = [abs(m_) / max(s_, 1e-30) for m_, s_ in zip(v["mean_diff"], v["se_diff"])]
    rec = {"phase": "unbiased", "scene": "janga-smoke (XML)", "sensor": 0, "spp": 256,
           "rays": W * H * 256, "pairs": pairs, "limit_z": 4.0, "render_s": secs,
           "chunk_ms": {"k3b": k3b_ms, "k3": k3_ms}, "card": card}
    emit(rec)
    if max(pairs["k3b-no_nee"]["z"]) > 4.0 or not all(np.isfinite(i).all() for i in imgs.values()):
        raise RuntimeError(f"K3b is off the no-NEE estimate: z = {pairs['k3b-no_nee']['z']}")
    out["unbiased"] = rec

    # ---------------------------------------------------------- xml-train
    ref = xml_scene("janga-smoke", dev, ref=True)
    train, first, truth = phase_train(card, vs, (preset, b, sc), out_dir / "xml", 2, 4,
                                      checkpoints=False, ref_bundle=ref[1],
                                      need=("deferred_nee",))
    grads = [s_["grads"] for s_ in (first, truth)]
    emit({"phase": "xml_train_grads", "scene": "janga-smoke (XML)",
          "grads_abs_sum": {tag: [float(g.sigma_t.abs().sum()), float(g.albedo.abs().sum())]
                            for tag, g in zip(("first", "truth"), grads)}, "card": card})
    if not all(torch.isfinite(g.sigma_t).all() and torch.isfinite(g.albedo).all()
               and g.sigma_t.abs().sum() > 0 and g.albedo.abs().sum() > 0 for g in grads):
        raise RuntimeError("janga-smoke XML training: the gradients are not finite and nonzero")
    launches = train["launches"]
    walking = launches["volpath_primal"] + launches["volpath_primal_state"] \
        + launches["volpath_adjoint"]
    if launches["deferred_nee"] != walking:
        raise RuntimeError(f"janga-smoke XML training: K3b ran in {launches['deferred_nee']} "
                           f"of {walking} walking launches")
    for tag, step in (("first", first), ("truth", truth)):
        c = step["counts"]
        step_walking = c["volpath_primal"] + c["volpath_primal_state"] + c["volpath_adjoint"]
        if not (c["volpath_adjoint"] == 1 and c["volpath_primal_state"] == 1
                and c["deferred_nee"] == step_walking):
            raise RuntimeError(f"janga-smoke XML {tag} step: K3b ran in {c['deferred_nee']} "
                               f"of {step_walking} walking launches: {c}")
    # the step's adjoint slice and DRT term (with K3b in its resumed primal)
    # against the deferred twins, on the step's own inputs
    out["check"] = check_step(card, vs, "janga-smoke XML truth", truth)
    out["train"] = train

    # ---------------------------------------------------- dust-devil (4k map)
    t0 = time.perf_counter()
    _, db, dsc = xml_scene("dust-devil", dev)
    emit(dict(xml_scene_record("dust-devil", db, dsc, time.perf_counter() - t0), card=card))
    dst = batched.RenderSettings(integrator=cfg, medium=db.medium_cfg, film_size=db.film_size,
                                 spp=64, spp_grad=64)
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    dimgs, dsecs = render_each(db, {"k3b": (dst, dsc.emitter), "k3": (dst, full_res(dsc).emitter)},
                               seed=1234, spp=64, turns=True)
    dl = dict(vs.LAUNCHES)
    d_no_nee = dataclasses.replace(dst, integrator=dataclasses.replace(cfg, use_nee=False))
    nimg, nsecs = render_each(db, {"no_nee": (d_no_nee, dsc.emitter)}, seed=1234, spp=64)
    dimgs.update(nimg)
    dsecs.update(nsecs)
    dpairs = {f"{a}-{c_}": paired_means(dimgs[a], dimgs[c_])
              for a, c_ in (("k3b", "no_nee"), ("k3", "no_nee"), ("k3b", "k3"))}
    for v in dpairs.values():
        v["z"] = [abs(m_) / max(s_, 1e-30) for m_, s_ in zip(v["mean_diff"], v["se_diff"])]
    dco, dcd = render_chunk(db)
    d3b_ms, d3_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, dsc, dco, dcd, seed0),
                              lambda: vs.sample_primal_kernel(cfg, full_res(dsc), dco, dcd, seed0),
                              2)
    dW, dH = db.film_size
    rec = {"phase": "xml_render", "scene": "dust-devil", "sensor": 0, "spp": 64,
           "film": [dW, dH], "rays": dW * dH * 64, "render_s": dsecs,
           "mrays_per_s": {k: dW * dH * 64 / v / 1e6 for k, v in dsecs.items()},
           "chunk_ms": {"k3b": d3b_ms, "k3": d3_ms}, "launches": dl,
           "pairs": dpairs, "limit_z": 4.0, "card": card}
    emit(rec)
    if not (dl["deferred_nee"] > 0 and dl["deferred_nee"] < dl["volpath_primal"]) \
            or not all(np.isfinite(i).all() for i in dimgs.values()):
        raise RuntimeError("dust-devil XML: the renders failed their checks")
    if max(dpairs["k3b-no_nee"]["z"]) > 4.0:
        raise RuntimeError(f"dust-devil XML: K3b is off the no-NEE estimate: "
                           f"z = {dpairs['k3b-no_nee']['z']}")
    out["dust"] = rec

    kernel = {
        "name": "deferred_nee", "route": "cuda", "source": "uivr_tpu_torch/ops/csrc/volpath_lane.cuh",
        "replaces": "uivr_tpu/ops/volpath_step.py:606", "launches": launches["deferred_nee"],
        "launches_per_train_step": first["counts"]["deferred_nee"],
        "max_abs_err": out["chunk"]["max_abs_err"], "agreement": out["chunk"]["agreement"],
        "ms": k3b_ms, "ms_k3": k3_ms, "plain_ms": out["chunk"]["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "gather_bound_ms": g_ms, "library_ms": None,
        "shape": f"volpath_primal with K3b, {co.shape[0]} rays, janga-smoke XML sensor 0 "
                 "(2,097,152-texel map, 2,048-texel proxy)",
        "dust_devil_4k": {"ms": d3b_ms, "ms_k3": d3_ms, "shape": f"{dco.shape[0]} rays"},
        **counts}
    return kernel, out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if not (HERE / "uivr_tpu_torch").is_dir():
        print(f"chip_smoke: the uivr_tpu_torch package is not next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import ctypes

    import numpy as np

    from uivr_tpu_torch.cli import render as cli_render
    from uivr_tpu_torch.config import get_int_config, get_scene_config
    from uivr_tpu_torch.core import exr_io, rng
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.ops import volpath_step as vs
    from uivr_tpu_torch.render import batched
    from uivr_tpu_torch.scene.camera import sample_rays
    from uivr_tpu_torch.scene.medium import finalize_medium
    from uivr_tpu_torch.scene.scene import Scene

    dev = torch.device("cuda")
    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    fmad_proc, fmad_lib = build_fmad_variant()
    vs.build()      # one nvcc per source, all started together
    for name in vs.LIBS:
        vs._load(name)
    build_s = time.time() - t0
    fmad_log, _ = fmad_proc.communicate()
    if fmad_proc.returncode != 0:
        raise RuntimeError(f"nvcc --fmad=true failed:\n{fmad_log}")
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "libraries": {k: str(b["path"].relative_to(HERE)) for k, b in vs.BUILD.items()},
          "build_s": round(build_s, 3),
          "nvcc_s": {k: b["seconds"] for k, b in vs.BUILD.items()},
          "ptxas": {k: ptxas_report(b["log"]) for k, b in vs.BUILD.items()}})

    rs = np.random.RandomState(20260417)
    # ---------------------------------------------------------- 2. tea
    n_tea = 1 << 20
    v0 = torch.from_numpy(rs.randint(0, 2 ** 32, n_tea, dtype=np.int64)).to(dev)
    v1 = torch.from_numpy(rs.randint(0, 2 ** 32, n_tea, dtype=np.int64)).to(dev)
    tea_exact = {}
    for rounds in (5, 6, 8):
        k0, k1 = vs.tea_i32(v0, v1, rounds)
        p0, p1 = rng.tea_plain(v0, v1, rounds)
        tea_exact[rounds] = bool(torch.equal(k0, p0) and torch.equal(k1, p1))
    emit({"phase": "tea", "pairs": n_tea, "bit_exact": tea_exact, "card": card})
    if not all(tea_exact.values()):
        raise RuntimeError(f"tea kernel differs from tea_plain: {tea_exact}")

    # ---------------------------------------------------------- 3. primal
    def scene_of(name):
        preset = get_scene_config(name)
        b = preset.build(device=dev)
        sc = Scene(finalize_medium(b.params, b.medium_cfg, b.to_world),
                   b.emitter, b.cameras)
        return preset, b, sc

    def sparse_variant(scene):
        """janga-smoke's density kept only in the central block [40:88]^3
        (x4), under one global majorant: empty subcells inside the
        majorant's cell, where SHADOW candidates classify (the sparse
        fixture of tests/pallas_common.py, at 128^3)."""
        preset, b, _ = scene
        mask = torch.zeros_like(b.params.sigma_t)
        mask[40:88, 40:88, 40:88] = 1.0
        params = b.params._replace(sigma_t=(b.params.sigma_t * mask * 4.0).contiguous())
        mcfg = dataclasses.replace(b.medium_cfg, majorant_factor=1)
        sc = Scene(finalize_medium(params, mcfg, b.to_world), b.emitter, b.cameras)
        return preset, dataclasses.replace(b, params=params, medium_cfg=mcfg), sc

    def random_pixel_rays(b, n):
        W, H = b.film_size
        pix = rs.randint(0, [W, H], size=(n, 2)).astype(np.float32)
        uv = torch.from_numpy((pix + rs.rand(n, 2).astype(np.float32))
                              / np.array([W, H], np.float32)).to(dev)
        o, d = sample_rays(b.cameras, torch.zeros(n, dtype=torch.int64, device=dev), uv)
        return o.contiguous(), d.contiguous()

    fmad = ctypes.CDLL(str(fmad_lib))
    fmad.volpath_primal_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fmad.volpath_primal_launch.restype = ctypes.c_int

    def run_fmad(cfg, sc, o, d, seed):
        L = torch.empty((o.shape[0], 3), dtype=torch.float32, device=dev)
        esc = torch.empty((o.shape[0],), dtype=torch.bool, device=dev)
        p = vs.primal_params(cfg, sc, o, d, seed, L, esc)
        rc = fmad.volpath_primal_launch(ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"--fmad=true build failed to launch ({rc})")
        torch.cuda.synchronize()
        return L

    n_cmp = 1 << 16
    seed = 42
    t_scenes = time.perf_counter()
    janga = scene_of("janga-smoke")
    dust = scene_of("dust-devil")
    cube = scene_of("tiny-cube")
    sparse = sparse_variant(janga)
    emit({"phase": "scenes", "seconds": time.perf_counter() - t_scenes,
          "subcells": {name: {"dims": list(sc_.medium.sub.shape),
                              "empty": int((sc_.medium.sub == 0).sum()),
                              "majorant_cells": list(sc_.medium.majorant_grid.shape)}
                       for name, (_, _, sc_) in (("janga-smoke", janga), ("dust-devil", dust),
                                                 ("tiny-cube", cube),
                                                 ("janga-smoke-sparse", sparse))}})
    runs = [("janga-smoke", janga, True, 0.90), ("dust-devil", dust, True, 0.90),
            ("tiny-cube", cube, True, 0.95), ("tiny-cube", cube, False, 0.95),
            ("janga-smoke-sparse", sparse, True, None)]
    for name, (preset, b, sc), nee, need in runs:
        cfg = dataclasses.replace(get_int_config("volpathsimple-basic").create(
            max_depth=preset.max_depth), use_nee=nee)
        off = no_cls(sc)
        o, d = random_pixel_rays(b, n_cmp)
        Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True)
        Lo, eo, so = vs.sample_primal_kernel(cfg, off, o, d, seed, return_stats=True)
        torch.cuda.synchronize()
        same = {"radiance_bits": torch.equal(Lk, Lo), "escaped": torch.equal(ek, eo),
                "dim": torch.equal(sk["dim"], so["dim"]),
                "steps": torch.equal(sk["steps"], so["steps"])}
        k_ms, off_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed),
                                 lambda: vs.sample_primal_kernel(cfg, off, o, d, seed), 3)
        cls = cls_counts(sk["cls"])
        rec = {"phase": "primal", "scene": name, "nee": nee, "rays": n_cmp,
               "cls_on_equals_off": same, "cls": cls, "kernel_ms": k_ms,
               "kernel_ms_cls_off": off_ms, "steps": int(sk["steps"].sum()),
               "max_steps_lane": int(sk["steps"].max()), "card": card}
        bad = not all(same.values())
        if need is not None:
            t0 = time.perf_counter()
            Lp, ep, sp = volpath_flat.sample_primal(cfg, sc, o, d, seed, return_stats=True,
                                                    deferred=True)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3
            agree = lane_agreement(Lk, Lp)
            mk, mp = Lk.mean(0).tolist(), Lp.mean(0).tolist()
            means_ok = all(abs(a - b_) <= 0.02 * abs(b_) for a, b_ in zip(mk, mp))
            rec.update({"agreement": agree, "need": need,
                        "same_draws": (sk["dim"] == sp["dim"]).float().mean().item(),
                        "escaped_equal": (ek == ep).float().mean().item(),
                        "mean_kernel": mk, "mean_plain": mp,
                        "max_abs_err": (Lk - Lp).abs().max().item(), "plain_ms": p_ms})
            if name == "janga-smoke":
                rec["agreement_fmad_true"] = lane_agreement(run_fmad(cfg, sc, o, d, seed), Lp)
            bad = bad or agree < need or not means_ok
        emit(rec)
        if bad:
            raise RuntimeError(f"{name} (nee={nee}): the kernel disagrees with itself "
                               "without K6 or with the plain twin")
        if name == "dust-devil" and not cls["cls_main_nulls"] > 0:
            raise RuntimeError("dust-devil: K6 classified no MAIN null")
        if name == "janga-smoke-sparse" and not (cls["cls_main_nulls"] > 0
                                                 and cls["cls_shadow"] > 0):
            raise RuntimeError(f"{name}: a K6 branch never fired: {cls}")

    # ---------------------------------------------------------- 4. render
    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    images, render_launches = {}, {}
    for name, (preset, b, sc) in (("janga-smoke", janga), ("dust-devil", dust)):
        exr = out_dir / f"{name}-s0.exr"
        for k in vs.LAUNCHES:
            vs.LAUNCHES[k] = 0
        volpath_flat.CALLS["volpath_primal"] = 0
        img, dt = cli_render.main(["--scene", name, "--sensor", "0",
                                   "--spp", "64", "--out", str(exr)])
        launches = dict(vs.LAUNCHES)
        plain_calls = volpath_flat.CALLS["volpath_primal"]
        back = exr_io.read_exr(str(exr))
        W, H = b.film_size
        rays = W * H * 64
        emit({"phase": "render", "scene": name, "sensor": 0, "spp": 64,
              "rays": rays, "seconds": dt, "mrays_per_s": rays / dt / 1e6,
              "image_mean": float(img.mean()), "launches": launches,
              "plain_twin_calls": plain_calls, "exr_shape": list(back.shape),
              "exr_finite": bool(np.isfinite(back).all()),
              "exr_matches": bool(np.array_equal(back, img)), "card": card})
        if not (launches["volpath_primal"] > 0 and launches["tea"] > 0
                and launches["subcell_classification"] > 0 and plain_calls == 0):
            raise RuntimeError(f"{name}: the render did not run through the kernels: "
                               f"{launches}, plain twin calls {plain_calls}")
        if back.shape != (H, W, 3) or not np.isfinite(back).all() \
                or not np.array_equal(back, img):
            raise RuntimeError(f"{name}: the rendered EXR is malformed")
        images[name], render_launches[name] = img, launches
    launches = render_launches["janga-smoke"]

    # ------------------------------------------------- 4b. where the time goes
    cfg = get_int_config("volpathsimple-drt").create(max_depth=janga[0].max_depth)
    for name, (preset, b, sc) in (("janga-smoke", janga), ("dust-devil", dust)):
        st = batched.RenderSettings(integrator=cfg, medium=b.medium_cfg,
                                    film_size=b.film_size, spp=64, spp_grad=64)
        st_off = dataclasses.replace(st, medium=dataclasses.replace(b.medium_cfg, cls_cells=0))
        repeats = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = batched.render_image(st, b.params, b.emitter, b.cameras, 0, seed=1234,
                                         medium_to_world=b.to_world)
            repeats.append(time.perf_counter() - t0)
        # K6 on and off in turns (on, off, off, on)
        turns = [time_render_parts(s_, b, seed=1234, spp=64) for s_ in (st, st_off, st_off, st)]
        emit({"phase": "breakdown", "scene": name, "render_s": repeats,
              "same_image": bool(np.array_equal(again, images[name])),
              "parts_ms": turns[0], "parts_ms_cls_off": turns[1],
              "kernel_ms_cls_on_off_turns": [t["kernel"] for t in turns], "card": card})
        if not np.array_equal(again, images[name]):
            raise RuntimeError(f"{name}: a repeated render differs from the first")

    # ---------------------------------------------------------- 5. kernels
    def render_chunk(b, spp=64, seed0=1234):
        """The rays of a full-frame render's first chunk (2**20 rays)."""
        W_ = b.film_size[0]
        chunk_pix = (1 << 20) // spp
        pix = torch.stack([torch.arange(chunk_pix, device=dev) % W_,
                           torch.arange(chunk_pix, device=dev) // W_], dim=-1)
        sidx = torch.zeros(chunk_pix, dtype=torch.int64, device=dev)
        sub_seed, _ = rng.sample_tea_32(seed0, 22)
        return batched._expand_rays(b.cameras, sidx, pix, b.film_size, spp, sub_seed)

    preset, b, sc = janga
    seed0 = 1234
    o, d = render_chunk(b)
    n = o.shape[0]
    Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed0, return_stats=True)
    torch.cuda.synchronize()
    k_ms, k_off_ms = on_off_ms(lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed0),
                               lambda: vs.sample_primal_kernel(cfg, no_cls(sc), o, d, seed0), 3)
    t0 = time.perf_counter()
    Lp, ep, sp = volpath_flat.sample_primal(cfg, sc, o, d, seed0, return_stats=True,
                                            deferred=True)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    steps = int(sk["steps"].sum())
    extra_draws = int(sk["dim"].sum()) - 2 * steps
    m = sc.medium
    em = sc.emitter
    in_bytes = (o.numel() + d.numel()) * 4 + m.grid.numel() * 4 + m.majorant_grid.numel() * 4 \
        + m.sub.numel() * 4 \
        + sum(t.numel() * 4 for t in (em.data, em.alias_tab, em.row_pmf, em.cond_pmf))
    out_bytes = n * (12 + 1)
    k_bound, k_by = bound(in_bytes + out_bytes,
                          FLOP_PER_STEP * steps + FLOP_PER_EXTRA_DRAW * extra_draws)
    scatters = extra_draws / 5
    chunk_cls = cls_counts(sk["cls"])
    gather_ms, _ = bound(event_fetch_bytes(steps, chunk_cls) + 28 * scatters + 36 * n, 0)
    gather_off_ms, _ = bound(event_fetch_bytes(steps, None) + 28 * scatters + 36 * n, 0)
    # dust-devil's first render chunk, K6 on and off
    dust_o, dust_d = render_chunk(dust[1])
    _, _, dust_sk = vs.sample_primal_kernel(cfg, dust[2], dust_o, dust_d, seed0,
                                            return_stats=True)
    dust_ms, dust_off_ms = on_off_ms(
        lambda: vs.sample_primal_kernel(cfg, dust[2], dust_o, dust_d, seed0),
        lambda: vs.sample_primal_kernel(cfg, no_cls(dust[2]), dust_o, dust_d, seed0), 2)

    tea_rounds = 8   # the wavefront sampler's vector hash of the ray generation
    t0_, t1_ = v0[:n], v1[:n]
    a32, b32 = t0_.to(torch.int32), t1_.to(torch.int32)   # the kernel's operands
    o0, o1 = torch.empty_like(a32), torch.empty_like(b32)
    lib = vs._load()
    stream = torch.cuda.current_stream().cuda_stream

    def tea_launch():
        if lib.tea_launch(a32.data_ptr(), b32.data_ptr(), o0.data_ptr(), o1.data_ptr(),
                          n, tea_rounds, stream):
            raise RuntimeError("tea_kernel launch failed")
    tea_launch()
    t_ms = cuda_ms(tea_launch, 20)
    tp_ms = cuda_ms(lambda: rng.tea_plain(t0_, t1_, tea_rounds), 5)
    t_bound, t_by = bound(16 * n, TEA_OPS_PER_ROUND * tea_rounds * n)
    kernels = [
        {"name": "tea", "route": "cuda", "source": "uivr_tpu_torch/ops/csrc/rng.cuh",
         "replaces": "uivr_tpu/ops/volpath_step.py:71", "launches": launches["tea"],
         "max_abs_err": 0.0, "ms": t_ms, "plain_ms": tp_ms, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": None, "agreement": 1.0,
         "shape": f"{n} pairs x {tea_rounds} rounds"},
        {"name": "volpath_primal", "route": "cuda",
         "source": "uivr_tpu_torch/ops/csrc/volpath_primal.cu",
         "replaces": "uivr_tpu/ops/volpath_step.py:303", "launches": launches["volpath_primal"],
         "max_abs_err": (Lk - Lp).abs().max().item(), "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
         "agreement": lane_agreement(Lk, Lp), "gather_bound_ms": gather_ms,
         "shape": f"{n} rays, janga-smoke sensor 0", "tracking_steps": steps,
         "extra_draws": extra_draws},
    ]
    if kernels[1]["agreement"] < 0.90:
        raise RuntimeError("main-path chunk: kernel disagrees with the plain twin")

    # ---------------------------------------------------------- 6-9. training
    phase_adjoint(card, dev, vs, janga, dust, cube, random_pixel_rays)
    train, start, truth = phase_train(card, vs, janga, out_dir, 3, 64)
    check_step(card, vs, "start", start)
    check = check_step(card, vs, "truth", truth)
    dust_train, _, dust_truth = phase_train(
        card, vs, dust, out_dir, 2, 16, {"lr": 1e-4, "lr_factors": {"albedo": 100.0}},
        checkpoints=False)
    dust_check = check_step(card, vs, "dust-devil truth", dust_truth)
    phase_cli(card, out_dir)
    phase_fd(card, vs, out_dir)
    k3b, _ = phase_xml(card, vs, dev, out_dir, random_pixel_rays, render_chunk)
    for k in kernels:
        k["launches_per_train_step"] = train["iterations"][0]["launches"].get(k["name"], 0)
    kernels += training_kernels(train, truth, check)

    # ---------------------------------------------------------- 10. kernels
    walking = {"janga-smoke": {"volpath_primal": {"ms_on": k_ms, "ms_off": k_off_ms,
                                                  "shape": f"{n} rays, render chunk"},
                               **walking_on_off(vs, truth, check)},
               "dust-devil": {"volpath_primal": {"ms_on": dust_ms, "ms_off": dust_off_ms,
                                                 "shape": f"{dust_o.shape[0]} rays, render chunk"},
                              **walking_on_off(vs, dust_truth, dust_check)}}
    counts = {"janga-smoke": {"volpath_primal": chunk_cls,
                              "volpath_adjoint": cls_counts(truth["adjoint"]["stats"]["cls"]),
                              "volpath_primal_state": check["recursive_cls"]},
              "dust-devil": {"volpath_primal": cls_counts(dust_sk["cls"]),
                             "volpath_adjoint": cls_counts(dust_truth["adjoint"]["stats"]["cls"]),
                             "volpath_primal_state": dust_check["recursive_cls"]}}
    kernels.append(
        {"name": "subcell_classification", "route": "cuda",
         "source": "uivr_tpu_torch/ops/csrc/volpath_lane.cuh",
         "replaces": "uivr_tpu/ops/volpath_step.py:892",
         "launches": train["launches"]["subcell_classification"],
         "launches_per_train_step":
             train["iterations"][0]["launches"]["subcell_classification"],
         "max_abs_err": kernels[1]["max_abs_err"], "ms": k_ms, "ms_cls_off": k_off_ms,
         "plain_ms": p_ms, "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
         "gather_bound_ms": gather_ms, "gather_bound_ms_cls_off": gather_off_ms,
         "shape": f"volpath_primal with K6, {n} rays, janga-smoke sensor 0",
         "walking_kernels_ms": walking, "counts": counts, "on_equals_off": True})
    kernels.append(k3b)
    emit({"kernels": kernels, "card": card})
    if not all(math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms")):
        raise RuntimeError("a kernel timing is not finite")

    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        emit({"phase": "failed", "error": traceback.format_exc().splitlines()[-1]})
        rc = 1
    sys.exit(rc)
