"""Ray-centric batched differentiable rendering.

Port of ``uivr_tpu/render/batched.py``: (sensor, pixel) batches, jittered
camera rays, the engine dispatch, the full-frame ``render_image`` and the
differentiable batch render of :func:`make_render`, whose backward (a
``torch.autograd.Function``) re-samples decorrelated adjoint rays through
the same pixels, replays their primal detached and runs the path-replay
adjoint.  The volumetric path tracer runs on the CUDA kernels (cuda
tensors), their plain twin (cpu tensors, or ``engine="flat"``) or the
nested engine (``engine="nested"``, the ``volpathsimple-drt-quadratic``
preset).  Seeds are TEA-derived per purpose exactly as in the reference
(pixel sampler ``tea(seed, 5)``, primal subpixel sampler ``tea(seed, 22)``,
adjoint subpixel sampler ``tea(seed_grad, 39)``), so both packages trace
the same rays and paths.  The integrator is either config of the
reference: the volumetric path tracer (``VolpathConfig``) or the NeRF
bootstrap march (``NerfConfig``, ``ops/nerf_step.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.rng import make_sampler, next_2d, sample_tea_32
from ..integrators import volpath_flat, volpathsimple
from ..integrators.nerf import NerfConfig
from ..integrators.volpathsimple import VolpathConfig
from ..ops import nerf_step, volpath_step
from ..scene.camera import Cameras, sample_rays
from ..scene.medium import MediumConfig, MediumParams, finalize_medium
from ..scene.scene import Emitter, Scene


def sample_batch_pixels(seed, n_sensors: int, film_size: Tuple[int, int],
                        batch_size: int, sensors=None, device=None):
    """Draw (sensor, pixel) pairs for one batch.  Returns
    (sensor_idx (B,) int64, pixels (B, 2) int64 as (x, y)).  ``sensors``
    restricts the draw to a sensor subset and returns absolute ids."""
    device = resolve_device(device)
    if sensors is not None:
        sensors = torch.as_tensor(sensors, dtype=torch.int64, device=device)
        n_sensors = int(sensors.shape[0])
    sub_seed, _ = sample_tea_32(seed, 5)
    s = make_sampler(sub_seed, n_lanes=batch_size, device=device)
    u1, s = next_2d(s)
    sensor_idx = torch.clamp((u1[:, 0] * n_sensors).to(torch.int64),
                             max=n_sensors - 1)
    if sensors is not None:
        sensor_idx = sensors[sensor_idx]
    u2, s = next_2d(s)
    fs = torch.tensor(film_size, dtype=torch.float32, device=device)
    pixels = torch.minimum((u2 * fs).to(torch.int64),
                           torch.tensor(film_size, device=device) - 1)
    return sensor_idx, pixels


def _expand_rays(cameras: Cameras, sensor_idx, pixels, film_size, spp: int,
                 subpixel_seed):
    """Repeat each pixel spp times with jittered subpixel positions and
    generate the camera rays."""
    B = sensor_idx.shape[0]
    dev = sensor_idx.device
    rep = torch.arange(B * spp, device=dev) // spp
    sidx = sensor_idx[rep]
    pix = pixels[rep].to(torch.float32)
    s = make_sampler(subpixel_seed, n_lanes=B * spp, device=dev)
    offset, _ = next_2d(s)
    # XLA folds the division by the constant film size into a multiplication
    # by its float32 reciprocal; the port does the same
    return sample_rays(cameras, sidx, (pix + offset) * _inv_film(tuple(film_size), dev))


@functools.lru_cache(maxsize=None)
def _inv_film(film_size, device) -> torch.Tensor:
    """1 / film size, float32 (2,) on ``device``, made once: a copy from
    the host waits for the device, and the forward's chunks must not wait
    between their launches."""
    return 1.0 / torch.tensor(film_size, dtype=torch.float32, device=device)


IntegratorConfig = Union[NerfConfig, VolpathConfig]


@dataclass(frozen=True)
class RenderSettings:
    integrator: IntegratorConfig
    medium: MediumConfig
    film_size: Tuple[int, int]
    spp: int
    spp_grad: int
    # K-candidate batching (K7) of the forward pass: None reads UIVR_KCAND
    # once, when make_render makes the render
    k_cand: Optional[int] = None
    # above this many rays a batch renders in spp chunks with per-chunk
    # seeds, as the reference does
    max_rays_per_pass: int = 1024 * 1024


def resolve_k_cand(k_cand: Optional[int] = None) -> int:
    """``k_cand``, or the ``UIVR_KCAND`` environment variable (default 1)."""
    return int(os.environ.get("UIVR_KCAND", 1)) if k_cand is None else int(k_cand)


def _resolve_engine(cfg, o: torch.Tensor) -> str:
    """'auto' and 'pallas' -> the CUDA kernel on cuda tensors, the plain twin
    on cpu tensors; 'flat' -> the plain twin and 'nested' -> the nested
    engine (``integrators/volpathsimple.py``), on the tensors' device."""
    e = getattr(cfg, "engine", "auto")
    if e in ("auto", "pallas"):
        return "kernel" if o.is_cuda else "flat"
    if e in ("flat", "nested"):
        return e
    raise ValueError(f"unknown engine {e!r}")


def _dispatch_primal(cfg: IntegratorConfig, scene: Scene, o, d, seed, k_cand=None):
    """``k_cand``: K-candidate batching of the kernel engine, None reading
    ``UIVR_KCAND``; the backward's replay passes 1.  The flat and nested
    engines ignore it, as the reference's do; on cpu tensors the K twin
    stands in for the kernel (``sample_primal_kernel`` there).  NeRF
    ignores it: its march runs ``nerf_primal_kernel`` on cuda tensors, the
    plain version on cpu tensors."""
    if isinstance(cfg, NerfConfig):
        return nerf_step.sample_primal_kernel(cfg, scene, o, d, seed)
    engine = _resolve_engine(cfg, o)
    if engine == "nested":
        L, valid, _ = volpathsimple.sample_primal(
            cfg, scene, o, d, make_sampler(seed, n_lanes=o.shape[0], device=o.device))
        return L, valid
    k = 1 if getattr(cfg, "engine", "auto") == "flat" else resolve_k_cand(k_cand)
    if engine == "kernel" or k > 1:
        return volpath_step.sample_primal_kernel(cfg, scene, o, d, seed, k_cand=k)
    return volpath_flat.sample_primal_compact(cfg, scene, o, d, seed)


def _dispatch_adjoint(cfg: IntegratorConfig, scene: Scene, o, d, seed, dL, L):
    if isinstance(cfg, NerfConfig):
        return nerf_step.sample_adjoint_kernel(cfg, scene, o, d, seed, dL, L)
    engine = _resolve_engine(cfg, o)
    if engine == "kernel":
        return volpath_step.sample_adjoint_kernel(cfg, scene, o, d, seed, dL, L)
    if engine == "nested":
        g, _ = volpathsimple.sample_adjoint(
            cfg, scene, o, d, make_sampler(seed, n_lanes=o.shape[0], device=o.device), dL, L)
        return g
    return volpath_flat.sample_adjoint(cfg, scene, o, d, seed, dL, L)


def _scene(st: RenderSettings, params: MediumParams, emitter: Emitter,
           cameras: Cameras, medium_to_world) -> Scene:
    return Scene(medium=finalize_medium(params, st.medium, medium_to_world),
                 emitter=emitter, cameras=cameras)


def _spp_chunk(st: RenderSettings, B: int, spp: int) -> int:
    """Largest divisor of spp keeping B * chunk <= max_rays_per_pass."""
    if B * spp <= st.max_rays_per_pass:
        return spp
    c = max(1, st.max_rays_per_pass // B)
    while spp % c:
        c -= 1
    return c


def _primal_image(st: RenderSettings, scene: Scene, cameras: Cameras,
                  sensor_idx, pixels, seed) -> torch.Tensor:
    """The primal image (B, 3) at ``st.spp``, split into spp chunks above
    ``max_rays_per_pass`` rays (seeds 1000+c for the subpixel offsets,
    7070+c for the paths), with ``st.k_cand`` (None: ``UIVR_KCAND``)."""
    B = sensor_idx.shape[0]
    spp_c = _spp_chunk(st, B, st.spp)
    if spp_c == st.spp:
        sub_seed, _ = sample_tea_32(seed, 22)
        o, d = _expand_rays(cameras, sensor_idx, pixels, st.film_size, st.spp,
                            sub_seed)
        L, _ = _dispatch_primal(st.integrator, scene, o, d, seed, st.k_cand)
        return L.reshape(B, st.spp, 3).mean(dim=1)
    acc = torch.zeros((B, 3), dtype=torch.float32, device=sensor_idx.device)
    n_chunks = st.spp // spp_c
    for c in range(n_chunks):
        sub_seed, _ = sample_tea_32(sample_tea_32(seed, 22)[0], 1000 + c)
        seed_c, _ = sample_tea_32(seed, 7070 + c)
        o, d = _expand_rays(cameras, sensor_idx, pixels, st.film_size, spp_c,
                            sub_seed)
        L, _ = _dispatch_primal(st.integrator, scene, o, d, seed_c, st.k_cand)
        acc = acc + L.reshape(B, spp_c, 3).mean(dim=1)
    return acc / n_chunks


def _adjoint_pass(st: RenderSettings, scene: Scene, cameras: Cameras,
                  sensor_idx, pixels, g_img, spp_c: int, sub_seed,
                  seed_c) -> MediumParams:
    """One pass of the backward: decorrelated adjoint rays through the same
    pixels, each carrying 1/spp_grad of its pixel's cotangent (the image is
    the mean over spp), a detached primal replay and the adjoint on the same
    stream.  The replay is pinned to K=1: the adjoint walks K=1 paths."""
    B = sensor_idx.shape[0]
    o, d = _expand_rays(cameras, sensor_idx, pixels, st.film_size, spp_c,
                        sub_seed)
    rep = torch.arange(B * spp_c, device=sensor_idx.device) // spp_c
    dL = (g_img[rep] / st.spp_grad).contiguous()
    L, _ = _dispatch_primal(st.integrator, scene, o, d, seed_c, k_cand=1)
    return _dispatch_adjoint(st.integrator, scene, o, d, seed_c, dL, L)


def render_backward(st: RenderSettings, scene: Scene, cameras: Cameras,
                    sensor_idx, pixels, seed_grad, g_img) -> MediumParams:
    """Gradients of sum(g_img * image) with respect to the grids: the
    reference's ``render_bwd``; above ``max_rays_per_pass`` adjoint rays the
    passes run in spp chunks (seeds 2000+c and 9090+c)."""
    B = sensor_idx.shape[0]
    spp_g = st.spp_grad
    spp_c = _spp_chunk(st, B, spp_g)
    if spp_c == spp_g:
        sub_seed, _ = sample_tea_32(seed_grad, 39)
        return _adjoint_pass(st, scene, cameras, sensor_idx, pixels, g_img,
                             spp_g, sub_seed, seed_grad)
    grads = None
    for c in range(spp_g // spp_c):
        sub_seed, _ = sample_tea_32(sample_tea_32(seed_grad, 39)[0], 2000 + c)
        seed_c, _ = sample_tea_32(seed_grad, 9090 + c)
        g = _adjoint_pass(st, scene, cameras, sensor_idx, pixels, g_img, spp_c,
                          sub_seed, seed_c)
        grads = g if grads is None else MediumParams(*[a + b for a, b in zip(grads, g)])
    return grads


class RenderOp(torch.autograd.Function):
    """The batch render as an autograd function of the three grids:
    forward renders the primal image, backward runs
    :func:`render_backward` and returns the gradients of all three (the
    path tracer's emission gradient is zero, NeRF's albedo gradient)."""

    @staticmethod
    def forward(ctx, st, medium_to_world, emitter, cameras, sensor_idx, pixels,
                seed, seed_grad, sigma_t, albedo, emission):
        params = MediumParams(sigma_t.detach(), albedo.detach(), emission.detach())
        scene = _scene(st, params, emitter, cameras, medium_to_world)
        ctx.st, ctx.scene, ctx.cameras = st, scene, cameras
        ctx.batch = (sensor_idx, pixels, seed_grad)
        return _primal_image(st, scene, cameras, sensor_idx, pixels, seed)

    @staticmethod
    def backward(ctx, g_img):
        sensor_idx, pixels, seed_grad = ctx.batch
        with torch.no_grad():
            g = render_backward(ctx.st, ctx.scene, ctx.cameras, sensor_idx,
                                pixels, seed_grad, g_img.contiguous())
        return (None,) * 8 + (g.sigma_t, g.albedo, g.emission)


def make_render(settings: RenderSettings, medium_to_world: np.ndarray = None):
    """The differentiable batched render:

        image (B, 3) = render(params, emitter, cameras, sensor_idx (B,),
                              pixels (B, 2), seed, seed_grad)

    differentiable with respect to the grids of ``params``; emitter and
    camera gradients are not propagated (as in the reference).  The
    forward's ``k_cand`` is resolved here, once: ``settings.k_cand`` or
    ``UIVR_KCAND``."""
    if medium_to_world is None:
        medium_to_world = np.eye(4, dtype=np.float32)
    settings = dataclasses.replace(settings, k_cand=resolve_k_cand(settings.k_cand))

    def render(params: MediumParams, emitter: Emitter, cameras: Cameras,
               sensor_idx, pixels, seed, seed_grad):
        return RenderOp.apply(settings, medium_to_world, emitter, cameras,
                              sensor_idx, pixels, seed, seed_grad,
                              params.sigma_t, params.albedo, params.emission)

    return render


@torch.no_grad()
def render_batch(settings: RenderSettings, params: MediumParams,
                 emitter: Emitter, cameras: Cameras, sensor_idx, pixels, seed,
                 medium_to_world: np.ndarray = None) -> torch.Tensor:
    """Primal image (B, 3) of a (sensor, pixel) batch at ``settings.spp``,
    split into spp chunks above ``max_rays_per_pass`` rays, with
    ``settings.k_cand`` (None: ``UIVR_KCAND``)."""
    scene = _scene(settings, params, emitter, cameras, medium_to_world)
    return _primal_image(settings, scene, cameras, sensor_idx, pixels, seed)


@torch.no_grad()
def render_image(settings: RenderSettings, params: MediumParams,
                 emitter: Emitter, cameras: Cameras, sensor: int, seed=0,
                 spp: int = None, chunk: int = None,
                 medium_to_world: np.ndarray = None) -> np.ndarray:
    """Full-frame render of one sensor, in chunks of about ``chunk`` rays
    (None: ``UIVR_RENDER_CHUNK``, default 2**20, read per call) with
    per-chunk seed ``seed + first_pixel`` as in the reference.  The
    device is that of ``params``.  Returns (H, W, 3) numpy.  As in the
    reference, every chunk reads ``UIVR_KCAND`` and ``settings.k_cand`` is
    not used (ROADMAP C3)."""
    if chunk is None:
        chunk = int(os.environ.get("UIVR_RENDER_CHUNK", 1 << 20))
    st = settings
    W, H = st.film_size
    spp = spp or st.spp
    dev = params.sigma_t.device
    scene = _scene(st, params, emitter, cameras, medium_to_world)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    all_pixels = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    n_pix = all_pixels.shape[0]
    chunk_pix = max(1, chunk // spp)
    out = torch.empty((n_pix, 3), dtype=torch.float32, device=dev)
    for i in range(0, n_pix, chunk_pix):
        pix = all_pixels[i:i + chunk_pix]
        seed_i = seed + i
        sub_seed, _ = sample_tea_32(seed_i, 22)
        sidx = torch.full((pix.shape[0],), sensor, dtype=torch.int64, device=dev)
        o, d = _expand_rays(cameras, sidx, pix, st.film_size, spp, sub_seed)
        L, _ = _dispatch_primal(st.integrator, scene, o, d, seed_i, k_cand=None)
        out[i:i + pix.shape[0]] = L.reshape(pix.shape[0], spp, 3).mean(dim=1)
    return out.reshape(H, W, 3).cpu().numpy()
