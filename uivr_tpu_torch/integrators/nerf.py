"""Emissive-grid "nerf" integrator: jittered fixed-step ray marching.

Port of ``uivr_tpu/integrators/nerf.py`` (``NerfConfig``, ``_activation``,
``sample_primal``, ``sample_adjoint``), the bootstrap stage of the
reference's two-stage pipeline:

- ``queries_per_ray`` steps (default 128) with one jitter draw per ray;
- alpha compositing, weight = (1 - exp(-sigma dt)) throughput, the last
  step forced transparent;
- identity or relu activation on sigma;
- the background ``(1 - weights_sum) * emitter(d)``;
- the path-replay adjoint: ``result`` starts at the primal radiance and
  loses each step's term before that step's sigma cotangent, and the
  cotangents are scatter-added into the sigma and emission grids.

This is the plain version of the CUDA kernels ``nerf_primal_kernel`` and
``nerf_adjoint_kernel`` (``ops/csrc/nerf.cuh``; ``ops/nerf_step.py`` binds
them), which repeat its float32 arithmetic operation for operation: the
order of every product and sum here is part of that contract (``exp`` is
``core/fmath.exp``, the trilinear reads ``core/grids.trilinear_sample``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..core import fmath
from ..core.rng import Sampler, next_1d
from ..scene.gradients import (finalize_accum, init_accum, scatter_emission,
                               scatter_sigma)
from ..scene.medium import emission_at, intersect_bbox, sigma_t_at
from ..scene.scene import Scene

# calls of the plain version on cuda tensors; the main path on the card
# launches the kernels and leaves these at 0
CALLS = {"nerf_primal": 0, "nerf_adjoint": 0}


@dataclass(frozen=True)
class NerfConfig:
    queries_per_ray: int = 128
    jitter: bool = True
    activation: str = "identity"   # 'identity' | 'relu'
    emission_scaled: bool = True
    hide_emitters: bool = False


def _activation(cfg: NerfConfig, raw: torch.Tensor):
    """Returns (sigma, dsigma/draw)."""
    if cfg.activation == "identity":
        return raw, torch.ones_like(raw)
    if cfg.activation == "relu":
        return torch.clamp(raw, min=0.0), (raw > 0.0).to(raw.dtype)
    raise ValueError(f"Unsupported activation: {cfg.activation}")


def _setup(cfg: NerfConfig, scene: Scene, o: torch.Tensor, d: torch.Tensor,
           sampler: Sampler):
    m = scene.medium
    tn, tf, hit, ol, dl = intersect_bbox(m, o, d)
    active = hit & (tf > tn)
    seg = torch.where(active, tf - tn, 0.0)
    entry = ol + tn[:, None] * dl
    jit, sampler = next_1d(sampler)
    steps = cfg.queries_per_ray
    # a true division, as the kernel's (a scalar divisor may turn into a
    # multiplication by its reciprocal)
    step = seg / torch.full_like(seg, steps if cfg.jitter else steps - 1)
    return m, active, entry, dl, step, jit, sampler


def _query(cfg: NerfConfig, m, entry, dl, step, jit, j: int, t_a):
    """Step ``j``'s point and its (dsigma/draw, emission, dt, alpha_recip,
    t_b); the last step is forced transparent."""
    t_b = step * ((j + 1) + (jit if cfg.jitter else 0.0))
    dt = t_b - t_a
    p = entry + t_b[:, None] * dl
    sig, dact = _activation(cfg, sigma_t_at(m, p))
    em = emission_at(m, p, cfg.emission_scaled)
    if j + 1 < cfg.queries_per_ray:
        alpha_recip = fmath.exp(-sig * dt)
    else:
        alpha_recip = torch.ones_like(sig)
    return p, dact, em, dt, alpha_recip, t_b


def sample_primal(cfg: NerfConfig, scene: Scene, o: torch.Tensor,
                  d: torch.Tensor, sampler: Sampler
                  ) -> Tuple[torch.Tensor, torch.Tensor, Sampler]:
    """Primal radiance estimate.  Returns (L (n,3), valid (n,), sampler)."""
    if o.is_cuda:
        CALLS["nerf_primal"] += 1
    m, active, entry, dl, step, jit, sampler = _setup(cfg, scene, o, d, sampler)
    act = active[:, None]
    result = torch.zeros_like(entry)
    thr = torch.ones_like(step)
    wsum = torch.zeros_like(step)
    t_a = torch.zeros_like(step)
    for j in range(cfg.queries_per_ray):
        _, _, em, _, alpha_recip, t_a = _query(cfg, m, entry, dl, step, jit, j, t_a)
        weight = (1.0 - alpha_recip) * thr
        result = result + torch.where(act, weight[:, None] * em, 0.0)
        thr = thr * (alpha_recip + 1e-10)
        wsum = wsum + torch.where(active, weight, 0.0)
    bg = scene.emitter.eval(d)
    valid = (torch.ones_like(active) if not cfg.hide_emitters else wsum > 0.0)
    result = result + torch.where(valid[:, None], (1.0 - wsum)[:, None] * bg, 0.0)
    return result, valid, sampler


def sample_adjoint(cfg: NerfConfig, scene: Scene, o: torch.Tensor,
                   d: torch.Tensor, sampler: Sampler, dL: torch.Tensor,
                   state_in: torch.Tensor):
    """Path-replay adjoint: the grids' gradients (MediumParams; albedo's
    zero) given the per-ray adjoint radiance ``dL`` (n,3) and the primal
    radiance ``state_in`` (n,3).  ``sampler`` must replay the primal's
    (same seed), so the jitter matches.  Returns (gradients, sampler)."""
    if o.is_cuda:
        CALLS["nerf_adjoint"] += 1
    m, active, entry, dl, step, jit, sampler = _setup(cfg, scene, o, d, sampler)
    act = active[:, None]
    acc = init_accum(m)
    result = state_in.clone()
    thr = torch.ones_like(step)
    t_a = torch.zeros_like(step)
    for j in range(cfg.queries_per_ray):
        p, dact, em, dt, alpha_recip, t_a = _query(cfg, m, entry, dl, step, jit, j, t_a)
        last = j + 1 >= cfg.queries_per_ray
        weight = (1.0 - alpha_recip) * thr
        sar = alpha_recip + 1e-10
        # result now holds the later steps' and the background's terms
        result = result - torch.where(act, weight[:, None] * em, 0.0)
        thr = thr * sar
        # d/d em of weight * em, pulled back by dL
        acc = scatter_emission(acc, m, p, dL * weight[:, None], active,
                               scaled=cfg.emission_scaled)
        # d weight/d sig = thr dt alpha_recip (this step), d sar/d sig =
        # -dt alpha_recip (the later steps through thr); thr is already
        # multiplied by sar, so thr / sar is the throughput of `weight`
        dalpha = torch.zeros_like(dt) if last else dt * alpha_recip
        x = dL * (em * (thr / sar * dalpha)[:, None] - result * (dalpha / sar)[:, None])
        cot_sig = x[:, 0] + x[:, 1] + x[:, 2]
        acc = scatter_sigma(acc, m, p, cot_sig * dact, active)
    return finalize_accum(acc, m), sampler
