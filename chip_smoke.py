#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``uivr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero before the last line:

1. device: the card (``nvidia-smi`` name and power limit on a line of its
   own), torch and CUDA versions, and the kernels' nvcc build.
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
5. kernels: each kernel at the shape the render gave it (its first chunk
   of 2**20 rays), timed with CUDA events beside its plain version, with
   the least time the card could take (``bound_ms``, below).
6. the last line: {"ok": true, "device": {...}}.

``bound_ms`` is the larger of the bytes the function must move (each input
read once, each output written once) over 3.35 TB/s and its operations
over 67 T/s, the H100 SXM's float32 rate outside the tensor cores (used for
the integer hash too).  The primal kernel's operations are counted from
this run's per-lane tracking steps and draws: ``FLOP_PER_STEP`` per
tracking event and ``FLOP_PER_EXTRA_DRAW`` per draw beyond the two every
event takes (one per real collision, four per scatter with NEE).
``gather_bound_ms`` counts instead the bytes the events fetch: 132 B of
grid and majorant per event, 28 B of envmap per scatter, 36 B per ray.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

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


def lane_agreement(L, Lref):
    ok = ((L - Lref).abs() <= 1e-4 * (1.0 + Lref.abs())).all(dim=-1)
    return ok.float().mean().item()


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
    vs._load()
    build_s = time.time() - t0
    fmad_log, _ = fmad_proc.communicate()
    if fmad_proc.returncode != 0:
        raise RuntimeError(f"nvcc --fmad=true failed:\n{fmad_log}")
    regs = [ln.strip() for ln in vs.BUILD["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "library": str(vs.BUILD["path"].relative_to(HERE)),
          "build_s": round(build_s, 3), "ptxas": regs})

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
    emit({"kernels": kernels, "card": card})
    if kernels[1]["agreement"] < 0.90:
        raise RuntimeError("main-path chunk: kernel disagrees with the plain twin")
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
