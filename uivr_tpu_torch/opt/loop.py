"""The inverse-rendering optimization loop.

Port of ``uivr_tpu/opt/loop.py``: reference images (rendered once, cached as
EXR with an spp sidecar), batched ray-centric rendering across all sensors,
TEA-derived per-iteration seeds, the learning-rate schedule with per-key
factors, multires upsampling with an optimizer-state reset, projection of
the grids, ``.vol`` checkpoints plus a resumable full state, previews and
``metrics.jsonl``.  Orchestration is host-side Python; each step's render,
adjoint, Adam update and projection run on the grids' device.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from os.path import join
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config.scenes import SceneBundle
from ..core import exr_io, vol_io
from ..core.grids import resize_trilinear
from ..core.rng import sample_tea_32
from ..render.batched import (RenderSettings, make_render, render_image,
                              sample_batch_pixels)
from ..scene.medium import MediumParams
from ..utils.cache import gallery
from . import losses as losses_mod
from .checkpoint import load_state, save_state
from .optimizer import adam_init, adam_step, reset_state_like, sgd_step
from .schedule import (Schedule, enforce_valid_params, initial_resolution,
                       learning_rates, upsample_iterations, upsample_params)


@dataclass
class OptimizationConfig:
    """Mirror of the reference OptimizationConfig."""
    name: str = "opt"
    spp: int = 16                  # adjoint spp
    n_iter: int = 6000
    lr: float = 5e-3
    primal_spp_factor: int = 64
    batch_size: int = 32768
    lr_schedule: Schedule = Schedule.Constant
    upsample: Optional[List[float]] = None
    base_seed: int = 988378
    preview_stride: int = 100
    checkpoint_stride: int = 1000
    checkpoint_initial: bool = True
    checkpoint_final: bool = True
    render_initial: bool = True
    render_final: bool = True
    preview_spp: Optional[int] = None
    opt_type: str = "adam"
    loss: Callable = staticmethod(losses_mod.l1)
    lr_factors: Dict[str, float] = field(
        default_factory=lambda: {"albedo": 2.0})
    # The reference scans up to this many iterations inside one device
    # program.  The port runs the same host loop for any value: the seeds
    # and pixels drawn are bit-identical either way.
    scan_stride: int = 0

    def __post_init__(self):
        self.upsample_at = upsample_iterations(self.upsample, self.n_iter)


def render_references(bundle: SceneBundle, settings: RenderSettings,
                      out_dir: str, spp: int = 512,
                      sensors: Optional[List[int]] = None,
                      overwrite: bool = False) -> np.ndarray:
    """Render (or load cached) reference images of every sensor from the
    ground-truth grids.  ``_refspp.json`` records the spp of the cached
    EXRs: a cache at a lower spp renders again, and a refresh resumes frame
    by frame (the sidecar lists the frames done)."""
    os.makedirs(out_dir, exist_ok=True)
    n = bundle.cameras.n_sensors
    sensors = sensors if sensors is not None else list(range(n))
    meta_path = join(out_dir, "_refspp.json")
    meta = {}
    if os.path.isfile(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            meta = {}
    cached_spp = meta.get("spp")
    partial = bool(meta.get("partial"))
    done = set(meta.get("done", []))
    if cached_spp == spp and partial:
        print(f"[refs] resuming partial spp={spp} refresh in {out_dir}: "
              f"{len(done)}/{len(sensors)} frames done")
    elif cached_spp is None or cached_spp < spp or partial:
        if any(os.path.isfile(join(out_dir, f"ref_{s:06d}.exr")) for s in sensors):
            print(f"[refs] cache in {out_dir} is spp={cached_spp}"
                  f"{' (partial)' if partial else ''}, run requests "
                  f"spp={spp}: re-rendering all references")
        done = set()
    elif cached_spp > spp:
        print(f"[refs] reusing cached references at spp={cached_spp} "
              f">= requested {spp}")
        spp = cached_spp
        done = set(sensors)
    else:
        done = set(sensors)
    if overwrite:
        done = set()
    W, H = bundle.film_size
    out = np.zeros((n, H, W, 3), np.float32)
    fresh = [s for s in sensors if s not in done]
    for s in sensors:
        fname = join(out_dir, f"ref_{s:06d}.exr")
        if s in done and os.path.isfile(fname):
            out[s] = exr_io.read_exr(fname)
        else:
            img = render_image(settings, bundle.params, bundle.emitter,
                               bundle.cameras, s, seed=1234, spp=spp,
                               medium_to_world=bundle.to_world)
            exr_io.write_exr(fname, img)
            out[s] = img
            if fresh:
                done.add(s)
                with open(meta_path, "w") as f:
                    json.dump({"spp": spp, "partial": True, "done": sorted(done)}, f)
    with open(meta_path, "w") as f:
        json.dump({"spp": spp}, f)
    return out


def load_references(ref_dir: str, bundle: SceneBundle,
                    sensors: Optional[List[int]] = None) -> np.ndarray:
    """Load precomputed reference EXRs (one ``ref_%06d.exr`` per sensor),
    checking film size and sensor coverage before reading any."""
    n = bundle.cameras.n_sensors
    sensors = sensors if sensors is not None else list(range(n))
    W, H = bundle.film_size
    out = np.zeros((n, H, W, 3), np.float32)
    missing = []
    for s in sensors:
        fname = join(ref_dir, f"ref_{s:06d}.exr")
        if not os.path.isfile(fname):
            missing.append(s)
            continue
        img = exr_io.read_exr(fname)
        if img.shape != (H, W, 3):
            raise ValueError(f"{fname}: reference image is {img.shape}, scene "
                             f"film is {(H, W, 3)}")
    if missing:
        raise FileNotFoundError(f"{ref_dir}: missing reference images for "
                                f"sensors {missing}")
    for s in sensors:
        out[s] = exr_io.read_exr(join(ref_dir, f"ref_{s:06d}.exr"))
    return out


def gather_ref_values(ref_images: torch.Tensor, sensor_idx: torch.Tensor,
                      pixels: torch.Tensor) -> torch.Tensor:
    """Reference pixel values (B, 3) of a batch; ``ref_images`` (S,H,W,3)."""
    return ref_images[sensor_idx, pixels[:, 1], pixels[:, 0]]


def save_checkpoint(out_dir: str, params: MediumParams, prefix: str) -> None:
    """Write the grids as Mitsuba ``.vol`` files."""
    os.makedirs(out_dir, exist_ok=True)
    for key in MediumParams._fields:
        vol_io.write_vol(join(out_dir, f"{prefix}-medium1_{key}.vol"),
                         getattr(params, key).detach().cpu().numpy())


def load_checkpoint(out_dir: str, prefix: str, device=None) -> MediumParams:
    vals = {}
    for key in MediumParams._fields:
        data, _ = vol_io.read_vol(join(out_dir, f"{prefix}-medium1_{key}.vol"))
        vals[key] = torch.as_tensor(data, device=device)
    return MediumParams(**vals)


def run_optimization(output_dir: str, opt: OptimizationConfig,
                     bundle: SceneBundle, int_cfg, ref_images=None,
                     ref_spp: int = 512, mesh=None,
                     start_params: Optional[MediumParams] = None,
                     resume: bool = True,
                     verbose: bool = True) -> MediumParams:
    """The optimization loop on the device of the bundle's grids; returns
    the optimized grids.  With ``resume`` a full state (params, Adam moments,
    iteration) is written at every checkpoint stride and a run continues
    from it when present."""
    if mesh is not None:
        raise NotImplementedError("data-parallel training: later slice")
    os.makedirs(output_dir, exist_ok=True)
    dev = bundle.params.sigma_t.device
    settings = RenderSettings(integrator=int_cfg, medium=bundle.medium_cfg,
                              film_size=bundle.film_size,
                              spp=opt.spp * opt.primal_spp_factor,
                              spp_grad=opt.spp)

    if ref_images is None:
        ref_settings = RenderSettings(
            integrator=int_cfg, medium=bundle.medium_cfg,
            film_size=bundle.film_size, spp=ref_spp, spp_grad=ref_spp)
        ref_images = render_references(bundle, ref_settings,
                                       join(output_dir, "references"), spp=ref_spp)
    ref_images = torch.as_tensor(np.asarray(ref_images), device=dev)

    params = start_params if start_params is not None else bundle.start_from
    if params is None:
        raise ValueError("bundle.start_from or start_params is required")
    params = MediumParams(*[torch.as_tensor(g, device=dev) for g in params])
    if opt.upsample_at:
        # downscale the start so that the schedule lands on the final size
        n_up = len(opt.upsample_at)
        params = MediumParams(*[resize_trilinear(g, initial_resolution(g.shape, n_up)[:3])
                                for g in params])

    opt_state = adam_init(params)
    start_it = 0
    state_path = join(output_dir, "state")
    if resume:
        restored = load_state(state_path, device=dev)
        if restored is not None:
            params, opt_state, start_it = restored
            start_it += 1
            if verbose:
                print(f"[i] Resumed from iteration {start_it - 1}")
    step_fn = _make_step(opt, settings, bundle, mesh)

    n_sensors = bundle.cameras.n_sensors
    metrics_f = open(join(output_dir, "metrics.jsonl"), "a")
    preview_sensors = list(bundle.preview_sensors
                           or (bundle.sensors[:1] if bundle.sensors else [0]))
    preview_settings = RenderSettings(
        integrator=int_cfg, medium=bundle.medium_cfg, film_size=bundle.film_size,
        spp=opt.preview_spp or opt.spp, spp_grad=opt.spp)

    def previews(params, tag):
        for s in preview_sensors:
            img = render_image(preview_settings, params, bundle.emitter,
                               bundle.cameras, s, seed=1234,
                               medium_to_world=bundle.to_world)
            exr_io.write_exr(join(output_dir, f"opt_{tag}_{s:04d}.exr"), img)
            psnr = float(losses_mod.psnr(torch.from_numpy(img),
                                         ref_images[s].cpu()))
            metrics_f.write(json.dumps(
                {"preview": tag, "sensor": s, "psnr": round(psnr, 3)}) + "\n")
            metrics_f.flush()
        # 9 evenly spaced z-slices of sigma_t, tiled 3x3
        sig = params.sigma_t.detach().cpu().numpy()[..., :1]
        sl = sig[np.linspace(0, sig.shape[0] - 1, 9).astype(int)]
        exr_io.write_exr(join(output_dir, f"opt_{tag}_sigma_gallery.exr"),
                         gallery(np.repeat(sl, 3, axis=-1), ncols=3))

    if opt.checkpoint_initial:
        save_checkpoint(join(output_dir, "params"), params, "initial")
    if opt.render_initial:
        previews(params, "init")

    t_start = time.time()
    it = start_it
    while it < opt.n_iter:
        if it in opt.upsample_at:
            params = upsample_params(params)
            opt_state = reset_state_like(params)
            if verbose:
                print(f"[i] Upsampled grids at iteration {it}: "
                      f"{tuple(params.sigma_t.shape)}")
        lr = learning_rates(opt.lr, opt.lr_schedule, it, opt.n_iter, opt.lr_factors)
        seed, _ = sample_tea_32(2 * it + 0, opt.base_seed)
        seed_grad, _ = sample_tea_32(2 * it + 1, opt.base_seed)
        sensor_idx, pixels = sample_batch_pixels(
            seed, n_sensors, bundle.film_size, opt.batch_size,
            sensors=bundle.sensors, device=dev)
        ref = gather_ref_values(ref_images, sensor_idx, pixels)
        params, opt_state, loss_val = step_fn(
            params, opt_state, bundle.emitter, bundle.cameras, sensor_idx,
            pixels, ref, seed, seed_grad, lr)
        if (it % 10) == 0 or it == opt.n_iter - 1:
            lv = float(loss_val)
            metrics_f.write(json.dumps({"it": it, "loss": lv,
                                        "elapsed_s": round(time.time() - t_start, 3)})
                            + "\n")
            metrics_f.flush()
            if verbose and (it % 100 == 0):
                print(f"[{opt.name}] it {it:6d} loss {lv:.6f}")
        if opt.checkpoint_stride and it > 0 and it % opt.checkpoint_stride == 0:
            save_checkpoint(join(output_dir, "params"), params, f"{it:08d}")
            save_state(state_path, params, opt_state, it)
        if (opt.preview_stride and it > 0 and it % opt.preview_stride == 0
                and opt.preview_stride <= opt.n_iter):
            previews(params, f"{it:08d}")
        it += 1

    if opt.checkpoint_final:
        save_checkpoint(join(output_dir, "params"), params, "final")
    if opt.render_final:
        previews(params, "final")
    metrics_f.close()
    return params


def _make_step(opt: OptimizationConfig, settings: RenderSettings,
               bundle: SceneBundle, mesh=None):
    """One optimization step: render, loss, backward (the render op's
    adjoint), Adam or SGD, projection."""
    if mesh is not None:
        raise NotImplementedError("data-parallel training: later slice")
    render = make_render(settings, bundle.to_world)
    loss_fn = opt.loss
    max_density = bundle.max_density
    opt_step = adam_step if opt.opt_type == "adam" else sgd_step

    def step(params, opt_state, emitter, cameras, sensor_idx, pixels, ref,
             seed, seed_grad, lr):
        leaves = MediumParams(*[p.detach().requires_grad_(True) for p in params])
        img = render(leaves, emitter, cameras, sensor_idx, pixels, seed, seed_grad)
        loss = loss_fn(img, ref)
        grads = MediumParams(*torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            params, opt_state = opt_step(params, grads, opt_state, lr)
            params = enforce_valid_params(params, max_density)
        return params, opt_state, loss.detach()

    return step
