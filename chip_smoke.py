#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``uivr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero before the last line:

1. device: the card (``nvidia-smi`` name and power limit on a line of its
   own), torch and CUDA versions, and the kernels' nvcc builds (one nvcc
   per source, started together) with ptxas' registers and spills.
2. tea (K1): ``tea_kernel`` against the plain ``tea_plain`` on 2**20 random
   (v0, v1) pairs at 5, 6 and 8 rounds; bit for bit.
3. primal (K2 + K3): ``volpath_primal_kernel`` against the plain twin
   (``engine="flat"``) on the same 2**16 camera rays at random pixels of
   sensor 0: janga-smoke at full width (envmap, NEE on) and tiny-cube
   (constant emitter) with NEE on and off.  A lane agrees when
   |dL| <= 1e-4 (1 + |L|) on all three channels; janga-smoke needs >= 0.90
   of lanes, tiny-cube >= 0.95, and every channel mean within 2%.  Also
   the same janga rays through a build with ``--fmad=true``.
4. render: ``python -m uivr_tpu_torch.cli.render --scene janga-smoke
   --sensor 0 --spp 64`` (180 x 155 x 64 = 1,785,600 rays) with every
   launch counter set to 0 just before; the kernels must have launched and
   the plain twin must not have run.  The EXR is read back and checked.
   Then three more renders (host clock) and one timed part by part with
   CUDA events: scene set-up, ray generation, kernel, reduction.
5. the primal kernels at the shape the render gave them (its first chunk
   of 2**20 rays), timed with CUDA events beside their plain versions.
6. adjoint (K4 + K5): ``volpath_adjoint_kernel`` against the twin's
   adjoint walk after one replay primal each, on the same rays, seed and
   random dL: janga-smoke, 8,192 random-pixel rays, under
   ``volpathsimple-drt`` and under ``volpathsimple-basic`` with shadow RR
   0.05; tiny-cube, 16,384 rays, NEE on and off.  Per-lane primary draws,
   alt draws and reservoir depth equal on >= 0.90 of lanes (janga) and
   >= 0.95 (cube); gradients' relative L1 sum|a-b| / sum|a| <= 1e-2 on
   sigma and albedo (atomics reorder the sums).
7. train: ``opt.run_optimization`` on janga-smoke with
   ``volpathsimple-drt`` at full width (batch 32,768, 16 adjoint spp,
   primal factor 64: 33,554,432 primal and 524,288 adjoint rays a step),
   3 iterations, 128^3 grids trained (no upsampling), references at 64
   spp (a cut: the step does not depend on it), counters set to 0 just
   before: the kernels launched, the twins never ran, parameters changed,
   the .vol checkpoints read back.  Then ``run_optimization`` for one
   step from the ground-truth grids.  ``StepRecorder`` keeps what each
   step did: its seconds, loss and gradients, the inputs and outputs of
   its adjoint and DRT calls, and CUDA events around the pixel draw, the
   step and every kernel launch (``volpath_step.TIMINGS``), which give
   the step's parts.
8. adjoint_step and drt (``check_step``), for the first step and the
   ground-truth step: the adjoint call's per-lane primary draws, alt
   draws and reservoir depth on its last 8,192 rays against the twin
   keyed by their ray ids (``lane0``), >= 0.90 of lanes, and the step's
   gradients finite and nonzero; ``drt_backward_kernel`` against
   ``volpath_flat._drt_backward_flat`` on all 524,288 reservoirs of the
   step: equal wavefront maxima K_A and K_B, per-lane t_sel, wsum and
   found equal on >= 0.90 of lanes, gradients' relative L1 <= 1e-2.
9. cli: ``uivr_tpu_torch.cli.reproduce`` on tiny-cube (20 iterations at
   batch 557); metrics.jsonl must hold losses and the final checkpoint
   must exist.
10. kernels: every kernel of both paths at the shape the main path gives
   it, with its launches, time, plain version's time, bound and agreement.
11. the last line: {"ok": true, "device": {...}}.

``bound_ms`` is the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over 67 T/s, the H100 SXM's float32 rate outside the tensor cores (used for
the integer hash too).  The primal kernel's operations are counted from
this run's per-lane tracking steps and draws: ``FLOP_PER_STEP`` per
tracking event and ``FLOP_PER_EXTRA_DRAW`` per draw beyond the two every
event takes (one per real collision, four per scatter with NEE).
``gather_bound_ms`` counts instead the bytes the events fetch: 132 B of
grid and majorant per event, 28 B of envmap per scatter, 36 B per ray.
The training kernels' bounds (``adjoint_bound``, ``drt_bounds``) follow
the same two rules, from this run's per-lane counters.
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


def emit(obj):
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
    (``volpath_step.TIMINGS``); the adjoint walk's inputs and outputs; the
    delayed DRT term's inputs; the gradients the backward returns."""

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
                    t0 = time.perf_counter()
                    rec["start"] = event()
                    out = step(*args)
                    rec["end"] = event()
                    torch.cuda.synchronize()
                    rec["seconds"] = time.perf_counter() - t0
                    vs.TIMINGS = None
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


def phase_adjoint(card, dev, vs, janga, cube, rays_of):
    """Kernel vs twin on the adjoint walk (after one replay primal each)."""
    import torch
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.integrators import volpath_flat
    rs = np.random.RandomState(20261017)
    runs = [("janga-smoke", janga, "volpathsimple-drt", {}, 8192, 0.90),
            ("janga-smoke", janga, "volpathsimple-basic", {"shadow_rr": 0.05}, 8192, 0.90),
            ("tiny-cube", cube, "volpathsimple-drt", {}, 16384, 0.95),
            ("tiny-cube", cube, "volpathsimple-drt", {"use_nee": False}, 16384, 0.95)]
    for name, (preset, b, sc), integ, kw, n, need in runs:
        cfg = dataclasses.replace(get_int_config(integ).create(max_depth=preset.max_depth), **kw)
        o, d = rays_of(b, n)
        dL = torch.from_numpy(rs.rand(n, 3).astype(np.float32) / n).to(dev)
        seed = 4242
        Lk, _ = vs.sample_primal_kernel(cfg, sc, o, d, seed)
        acc_k, res_k, st_k = vs.adjoint_walk_kernel(cfg, sc, o, d, seed, dL, Lk)
        torch.cuda.synchronize()
        k_ms = cuda_ms(lambda: vs.adjoint_walk_kernel(cfg, sc, o, d, seed, dL, Lk), 3)
        t0 = time.perf_counter()
        Lt, _ = volpath_flat.sample_primal(cfg, sc, o, d, seed)
        acc_t, res_t, st_t = volpath_flat.adjoint_walk(cfg, sc, o, d, seed, dL, Lt)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        agree = {"dim": equal_frac(st_k["dim"], st_t["dim"]),
                 "alt_dim": equal_frac(st_k["alt_dim"], st_t["alt_dim"]),
                 "reservoir_depth": equal_frac(res_k.depth, res_t.depth)}
        rel = {"sigma": rel_l1(acc_k.sigma, acc_t.sigma),
               "albedo": rel_l1(acc_k.albedo, acc_t.albedo)}
        rec = {"phase": "adjoint", "scene": name, "integrator": integ, **kw, "rays": n,
               "agreement": agree, "need": need, "rel_l1": rel,
               "max_abs_err": max(float((acc_k.sigma - acc_t.sigma).abs().max()),
                                  float((acc_k.albedo - acc_t.albedo).abs().max())),
               "grad_abs_sum": float(acc_t.sigma.abs().sum()),
               "kernel_ms": k_ms, "plain_ms": p_ms, "events": int(st_k["steps"].sum()),
               "card": card}
        emit(rec)
        if min(agree.values()) < need or max(rel.values()) > 1e-2 or not rec["grad_abs_sum"] > 0:
            raise RuntimeError(f"adjoint {name} {integ} {kw}: kernel disagrees with the twin")


def check_step(card, vs, tag, step):
    """A recorded training step's kernels against the twins, at the shapes
    the step gave them: the adjoint call's per-lane primary draws, alt
    draws and reservoir depth on its last SLICE rays (the twin keyed by
    their ray ids), and ``drt_backward_kernel`` against
    ``_drt_backward_flat`` on all of the step's reservoirs."""
    import torch
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.scene.gradients import init_accum
    a, dr = step["adjoint"], step["drt"]
    cfg, sc = a["cfg"], a["scene"]
    n = a["o"].shape[0]
    sl = slice(n - SLICE, n)
    t0 = time.perf_counter()
    Lt, _ = volpath_flat.sample_primal(cfg, sc, a["o"][sl], a["d"][sl], a["seed"],
                                       lane0=n - SLICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, res_t, st_t = volpath_flat.adjoint_walk(cfg, sc, a["o"][sl], a["d"][sl], a["seed"],
                                               a["dL"][sl], a["L"][sl], lane0=n - SLICE)
    torch.cuda.synchronize()
    adj_plain_ms = (time.perf_counter() - t1) * 1e3
    adj_agree = {"replay_L": lane_agreement(a["L"][sl], Lt),
                 "dim": equal_frac(a["stats"]["dim"][sl], st_t["dim"]),
                 "alt_dim": equal_frac(a["stats"]["alt_dim"][sl], st_t["alt_dim"]),
                 "reservoir_depth": equal_frac(a["res"].depth[sl], res_t.depth)}
    adj_err = max(float((a["res"].wsum[sl] - res_t.wsum).abs().max()),
                  float((a["res"].cur_w[sl] - res_t.cur_w).abs().max()))

    m = sc.medium
    acc_k, k = vs.drt_backward_kernel(cfg, sc, dr["seed"], dr["res"], dr["adjoint"],
                                      init_accum(m, need_emission=False), return_stats=True)
    acc_t = init_accum(m, need_emission=False)
    with Laps(volpath_flat, ("drt_distance", "_nee_primal", "sample_primal")) as laps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, p = volpath_flat._drt_backward_flat(cfg, sc, dr["seed"], dr["res"], dr["adjoint"],
                                               acc_t, return_stats=True)
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
    g = step["grads"]
    adj_rec = {"phase": "adjoint_step", "step": tag, "adjoint_rays": n,
               "adjoint_slice": [n - SLICE, n], "adjoint_agreement": adj_agree,
               "need": 0.90, "adjoint_max_abs_err": adj_err, "adjoint_plain_ms": adj_plain_ms,
               "grads_finite": bool(torch.isfinite(g.sigma_t).all()
                                    and torch.isfinite(g.albedo).all()),
               "grads_abs_sum": [float(g.sigma_t.abs().sum()), float(g.albedo.abs().sum())],
               "card": card}
    rec = {"phase": "drt", "step": tag, "reservoirs": n,
           "vertices": int((dr["res"].active & k["found"]).sum()),
           "K_A": k["k_a"], "K_B": k["k_b"], "K_A_plain": int(p["k_a"]), "K_B_plain": int(p["k_b"]),
           "drt_agreement": agree, "need": 0.90, "drt_rel_l1": rel,
           "drt_max_abs_err": {
               "volpath_drt_walk": float((k["wsum"] - p["wsum"]).abs().max()),
               "volpath_drt_nee": float((k["nee"][both] - p["nee"][both]).abs().max()),
               "volpath_drt_phase": float((k["path_state"].d_w[both]
                                           - p["path_state"].d_w[both]).abs().max()),
               "volpath_primal_state": float((k["rec_L"][both] - p["rec_L"][both]).abs().max()),
               "volpath_drt_scatter": max(float((acc_k.sigma - acc_t.sigma).abs().max()),
                                          float((acc_k.albedo - acc_t.albedo).abs().max()))},
           "drt_plain_ms": drt_plain_ms, "drt_plain_total_ms": (t1 - t0) * 1e3,
           "card": card}
    emit(adj_rec)
    emit(rec)
    if min(adj_agree.values()) < 0.90:
        raise RuntimeError(f"adjoint_step {tag}: volpath_adjoint disagrees with the twin")
    if not (adj_rec["grads_finite"] and min(adj_rec["grads_abs_sum"]) > 0):
        raise RuntimeError(f"adjoint_step {tag}: the step's gradients are not finite and nonzero")
    if min(agree.values()) < 0.90 or [k["k_a"], k["k_b"]] != [int(p["k_a"]), int(p["k_b"])] \
            or max(rel.values()) > 1e-2 or not float(acc_t.sigma.abs().sum()) > 0:
        raise RuntimeError(f"drt {tag}: the DRT kernels disagree with the twin")
    return dict(adj_rec, **rec, drt_stats=k)


def phase_train(card, dev, vs, janga, out_dir):
    """run_optimization at full width (3 iterations of volpathsimple-drt on
    janga-smoke, 128^3 grids trained), then one step of it from the
    ground-truth grids; both recorded by StepRecorder."""
    import torch
    from uivr_tpu_torch.config import get_int_config
    from uivr_tpu_torch.core import vol_io
    from uivr_tpu_torch.integrators import volpath_flat
    from uivr_tpu_torch.opt import OptimizationConfig, loop, render_references
    from uivr_tpu_torch.render import RenderSettings
    preset, b, _ = janga
    cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
    ref_spp = 64
    t0 = time.perf_counter()
    refs = render_references(b, RenderSettings(integrator=cfg, medium=b.medium_cfg,
                                               film_size=b.film_size, spp=ref_spp,
                                               spp_grad=ref_spp),
                             str(out_dir / "references"), spp=ref_spp, overwrite=True)
    ref_s = time.perf_counter() - t0
    width = dict(spp=16, lr=5e-3, primal_spp_factor=64, batch_size=32768, upsample=None,
                 preview_spp=16)
    opt = OptimizationConfig(name="janga-smoke/volpathsimple-drt", n_iter=3,
                             preview_stride=0, checkpoint_stride=2, render_initial=False,
                             **width)
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
    one = OptimizationConfig(name="janga-smoke/truth", n_iter=1, preview_stride=0,
                             checkpoint_stride=0, checkpoint_initial=False,
                             checkpoint_final=False, render_initial=False,
                             render_final=False, **width)
    with StepRecorder(vs, loop) as truth:
        loop.run_optimization(str(out_dir / "truth"), one, b, cfg, ref_images=refs,
                              start_params=b.params, resume=False, verbose=False)
    vols = {}
    for tag, grids in (("initial", b.start_from), ("final", final)):
        for key in ("sigma_t", "albedo"):
            data, _ = vol_io.read_vol(str(out_dir / "train" / "params" / f"{tag}-medium1_{key}.vol"))
            vols[f"{tag}_{key}"] = bool(np.array_equal(data, getattr(grids, key).cpu().numpy()))
    changed = {k: not torch.equal(getattr(final, k), getattr(b.start_from, k))
               for k in ("sigma_t", "albedo")}
    steps = [{"seconds": s["seconds"], "loss": s["loss"], "parts_ms": step_parts(s)}
             for s in main.steps + truth.steps]
    rec = {"phase": "train", "scene": "janga-smoke", "integrator": "volpathsimple-drt",
           "batch": 32768, "spp_primal": 1024, "spp_grad": 16, "grid": list(b.params.sigma_t.shape),
           "ref_spp": ref_spp, "references_s": ref_s, "run_s": run_s,
           "iterations": steps[:-1], "truth_step": steps[-1],
           "launches": launches, "plain_twin_calls": plain_calls,
           "checkpoints_read_back": vols, "params_changed": changed, "card": card}
    emit(rec)
    missing = [k for k in TRAIN_KERNELS if not launches[k] > 0]
    if missing or any(plain_calls.values()):
        raise RuntimeError(f"training did not run through the kernels: missing {missing}, "
                           f"plain twin calls {plain_calls}")
    if not (all(changed.values()) and all(vols.values()) and len(main.steps) == 3
            and all(math.isfinite(s_["loss"]) for s_ in steps)):
        raise RuntimeError("training step checks failed")
    return rec, main.steps[0], truth.steps[0]


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
    fetch: 132 B per event, 128 B of atomics per real collision, 32 B per
    transmittance sample and per replay collision, 120 B per ray."""
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
    gather_ms, _ = bound(132 * events + 128 * real + 32 * (samples + replay) + 120 * n, 0)
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
    main run (and per step); times of their launches in the recorded step from
    the ground-truth grids (walks as long as late in a run), with bounds
    from that step's counts; plain times and errors from ``check_step`` on
    that step."""
    runs = {k: {"launches": train["launches"][k],
                "launches_per_train_step": train["launches"][k] / len(train["iterations"])}
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
    s_gather, _ = bound(132 * rec_steps + 28 * rec_extra / 5 + 49 * n, 0)
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
    janga = scene_of("janga-smoke")
    cube = scene_of("tiny-cube")
    runs = [("janga-smoke", janga, True, 0.90), ("tiny-cube", cube, True, 0.95),
            ("tiny-cube", cube, False, 0.95)]
    for name, (preset, b, sc), nee, need in runs:
        cfg = dataclasses.replace(get_int_config("volpathsimple-basic").create(
            max_depth=preset.max_depth), use_nee=nee)
        o, d = random_pixel_rays(b, n_cmp)
        Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed, return_stats=True)
        torch.cuda.synchronize()
        k_ms = cuda_ms(lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed), 5)
        t0 = time.perf_counter()
        Lp, ep, sp = volpath_flat.sample_primal(cfg, sc, o, d, seed, return_stats=True)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        agree = lane_agreement(Lk, Lp)
        mk, mp = Lk.mean(0).tolist(), Lp.mean(0).tolist()
        means_ok = all(abs(a - b_) <= 0.02 * abs(b_) for a, b_ in zip(mk, mp))
        rec = {"phase": "primal", "scene": name, "nee": nee, "rays": n_cmp,
               "agreement": agree, "need": need, "same_draws": (sk["dim"] == sp["dim"]).float().mean().item(),
               "escaped_equal": (ek == ep).float().mean().item(),
               "mean_kernel": mk, "mean_plain": mp,
               "max_abs_err": (Lk - Lp).abs().max().item(),
               "kernel_ms": k_ms, "plain_ms": p_ms,
               "steps": int(sk["steps"].sum()), "max_steps_lane": int(sk["steps"].max()),
               "card": card}
        if name == "janga-smoke":
            rec["agreement_fmad_true"] = lane_agreement(run_fmad(cfg, sc, o, d, seed), Lp)
        emit(rec)
        if agree < need or not means_ok:
            raise RuntimeError(f"{name} (nee={nee}): kernel disagrees with the plain twin")

    # ---------------------------------------------------------- 4. render
    out_dir = HERE / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    exr = out_dir / "janga-smoke-s0.exr"
    for k in vs.LAUNCHES:
        vs.LAUNCHES[k] = 0
    volpath_flat.CALLS["volpath_primal"] = 0
    img, dt = cli_render.main(["--scene", "janga-smoke", "--sensor", "0",
                               "--spp", "64", "--out", str(exr)])
    launches = dict(vs.LAUNCHES)
    plain_calls = volpath_flat.CALLS["volpath_primal"]
    back = exr_io.read_exr(str(exr))
    W, H = janga[1].film_size
    rays = W * H * 64
    emit({"phase": "render", "scene": "janga-smoke", "sensor": 0, "spp": 64,
          "rays": rays, "seconds": dt, "mrays_per_s": rays / dt / 1e6,
          "image_mean": float(img.mean()), "launches": launches,
          "plain_twin_calls": plain_calls, "exr_shape": list(back.shape),
          "exr_finite": bool(np.isfinite(back).all()),
          "exr_matches": bool(np.array_equal(back, img)), "card": card})
    if not (launches["volpath_primal"] > 0 and launches["tea"] > 0 and plain_calls == 0):
        raise RuntimeError(f"the render did not run through the kernels: {launches}, "
                           f"plain twin calls {plain_calls}")
    if back.shape != (H, W, 3) or not np.isfinite(back).all() or not np.array_equal(back, img):
        raise RuntimeError("the rendered EXR is malformed")

    # ------------------------------------------------- 4b. where the time goes
    preset, b, sc = janga
    cfg = get_int_config("volpathsimple-drt").create(max_depth=preset.max_depth)
    st = batched.RenderSettings(integrator=cfg, medium=b.medium_cfg, film_size=b.film_size,
                                spp=64, spp_grad=64)
    repeats = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = batched.render_image(st, b.params, b.emitter, b.cameras, 0, seed=1234,
                                     medium_to_world=b.to_world)
        repeats.append(time.perf_counter() - t0)
    parts = time_render_parts(st, b, seed=1234, spp=64)
    emit({"phase": "breakdown", "scene": "janga-smoke", "render_s": repeats,
          "same_image": bool(np.array_equal(again, img)), "parts_ms": parts,
          "card": card})
    if not np.array_equal(again, img):
        raise RuntimeError("a repeated render differs from the first")

    # ---------------------------------------------------------- 5. kernels
    spp, chunk_pix, seed0 = 64, (1 << 20) // 64, 1234
    xs = torch.arange(chunk_pix, device=dev) % W
    ys = torch.arange(chunk_pix, device=dev) // W
    pix = torch.stack([xs, ys], dim=-1)
    sidx = torch.zeros(chunk_pix, dtype=torch.int64, device=dev)
    sub_seed, _ = rng.sample_tea_32(seed0, 22)
    o, d = batched._expand_rays(b.cameras, sidx, pix, b.film_size, spp, sub_seed)
    n = o.shape[0]
    Lk, ek, sk = vs.sample_primal_kernel(cfg, sc, o, d, seed0, return_stats=True)
    torch.cuda.synchronize()
    k_ms = cuda_ms(lambda: vs.sample_primal_kernel(cfg, sc, o, d, seed0), 5)
    t0 = time.perf_counter()
    Lp, ep, sp = volpath_flat.sample_primal(cfg, sc, o, d, seed0, return_stats=True)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    steps = int(sk["steps"].sum())
    extra_draws = int(sk["dim"].sum()) - 2 * steps
    m = sc.medium
    em = sc.emitter
    in_bytes = (o.numel() + d.numel()) * 4 + m.grid.numel() * 4 + m.majorant_grid.numel() * 4 \
        + sum(t.numel() * 4 for t in (em.data, em.alias_tab, em.row_pmf, em.cond_pmf))
    out_bytes = n * (12 + 1)
    k_bound, k_by = bound(in_bytes + out_bytes,
                          FLOP_PER_STEP * steps + FLOP_PER_EXTRA_DRAW * extra_draws)
    scatters = extra_draws / 5
    gather_ms, _ = bound(132 * steps + 28 * scatters + 36 * n, 0)

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
    phase_adjoint(card, dev, vs, janga, cube, random_pixel_rays)
    train, start, truth = phase_train(card, dev, vs, janga, out_dir)
    check_step(card, vs, "start", start)
    check = check_step(card, vs, "truth", truth)
    phase_cli(card, out_dir)
    for k in kernels:
        k["launches_per_train_step"] = train["launches"].get(k["name"], 0) / 3
    kernels += training_kernels(train, truth, check)

    # ---------------------------------------------------------- 10. kernels
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
