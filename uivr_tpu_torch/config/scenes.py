"""Procedural scene builders.

Port of ``uivr_tpu/config/scenes.py`` (the cube test scene and the smoke
plume stand-in), plus :func:`bundle_from_numpy`, :func:`params_from_numpy`
and :func:`adam_state_from_numpy`, which build a bundle, grids and Adam
moments from plain numpy arrays: the way scenes and training state are
carried across from the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..scene.camera import Cameras, look_at, make_cameras, orbit_cameras
from ..scene.emitters import ConstantEmitter, EnvmapEmitter, make_envmap, nee_proxy
from ..scene.medium import MediumConfig, MediumParams
from ..scene.scene import Emitter


@dataclass
class SceneBundle:
    """Everything needed to render one scene."""
    params: MediumParams          # ground-truth grids
    medium_cfg: MediumConfig
    emitter: Emitter
    cameras: Cameras
    to_world: np.ndarray          # medium local->world (4, 4)
    film_size: Tuple[int, int]
    max_depth: int = 64
    max_density: float = 250.0
    start_from: Optional[MediumParams] = None   # optimization start grids
    sensors: Optional[Tuple[int, ...]] = None
    preview_sensors: Optional[Tuple[int, ...]] = None


def _params(sigma, albedo, emission, device) -> MediumParams:
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
    return MediumParams(sigma_t=t(sigma), albedo=t(albedo), emission=t(emission))


def _start(params: MediumParams, density_scale: float) -> MediumParams:
    return MediumParams(
        sigma_t=torch.full_like(params.sigma_t, 0.04 / density_scale),
        albedo=torch.full_like(params.albedo, 0.6),
        emission=torch.full_like(params.emission, 0.1 / density_scale))


def cube_test_grids():
    """The reference's deterministic 3x3x3 test grids."""
    sigma = np.full((3, 3, 3, 1), 1.0, np.float32) * 0.5
    sigma[0, 0, 0, :] = 0.1
    sigma[0, -1, 0, :] = 2.0
    sigma[0, 0, -1, :] = 0.2
    emission = np.full((3, 3, 3, 3), 1.0, np.float32)
    emission[..., 0] = 0.3
    emission[..., 1] = 0.5
    emission[..., 2] = 0.9
    n = emission.shape[0]
    for i in range(n):
        emission[i, :, :, 0] *= np.square((i + 1) / n)
        emission[i, :, :, 1] *= 1 - (i + 1) / n
        emission[:, i, :, 1] *= np.square((i + 1) / n)
    albedo = np.clip(emission, 0, 1)
    return sigma, albedo, emission


def cube_test_scene(resx: int = 128, resy: int = 128,
                    density_scale: float = 1.0, majorant_factor: int = 8,
                    max_depth: int = 64, device=None) -> SceneBundle:
    """Unit cube scaled x2 near the origin, constant emitter
    [1.0, 0.8, 0.2], one sensor at (4,4,4) looking at (0,-0.15,0), fov 30."""
    device = resolve_device(device)
    params = _params(*cube_test_grids(), device)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] *= 2.0
    T[:3, 3] = [-0.5, -0.5, -0.5]
    cams = make_cameras(look_at([4.0, 4.0, 4.0], [0.0, -0.15, 0.0],
                                [0.0, 1.0, 0.0]), 30.0, resx, resy,
                        device=device)
    return SceneBundle(
        params=params,
        medium_cfg=MediumConfig(majorant_factor=majorant_factor,
                                scale=density_scale),
        emitter=ConstantEmitter(radiance=torch.tensor(
            [1.0, 0.8, 0.2], dtype=torch.float32, device=device)),
        cameras=cams, to_world=T, film_size=(resx, resy),
        max_depth=max_depth, start_from=_start(params, density_scale))


def procedural_smoke_grids(res: int = 64, seed: int = 0):
    """A smooth smoke-like density (randomised Gaussian blobs + falloff)."""
    rs = np.random.RandomState(seed)
    z, y, x = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                          np.linspace(0, 1, res), indexing="ij")
    density = np.zeros((res, res, res), np.float32)
    for _ in range(24):
        c = rs.rand(3) * 0.7 + 0.15
        s = rs.rand() * 0.12 + 0.04
        a = rs.rand() * 1.2
        density += a * np.exp(-(((x - c[0]) ** 2 + (y - c[1]) ** 2
                                 + (z - c[2]) ** 2) / (2 * s * s)))
    density *= np.exp(-2.5 * np.abs(y - 0.4))
    density = (density / density.max()).astype(np.float32)
    albedo = np.stack([0.7 + 0.2 * x, 0.7 + 0.2 * y, 0.7 + 0.2 * z],
                      axis=-1).astype(np.float32)
    emission = (0.1 * density)[..., None] * np.array([1.0, 0.6, 0.3],
                                                     np.float32)
    return density[..., None], np.clip(albedo, 0, 1), emission


def procedural_sky(h: int = 64, w: int = 128) -> np.ndarray:
    """Simple analytic sky + sun HDR environment (H, W, 3)."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    uu, vv = np.meshgrid(u, v)
    horizon = np.exp(-8.0 * np.square(vv - 0.55))
    zenith = np.clip(1.0 - vv * 1.4, 0, 1)
    sky = np.stack([0.25 + 0.3 * horizon + 0.2 * zenith,
                    0.35 + 0.3 * horizon + 0.3 * zenith,
                    0.6 + 0.25 * horizon + 0.4 * zenith], axis=-1)
    sun = 60.0 * np.exp(-((uu - 0.3) ** 2 + (vv - 0.3) ** 2) / 0.002)
    sky += sun[..., None] * np.array([1.0, 0.9, 0.7])
    return sky.astype(np.float32)


def smoke_scene(res: int = 64, resx: int = 128, resy: int = 128,
                n_sensors: int = 26, density_scale: float = 20.0,
                majorant_factor: int = 8, seed: int = 0,
                envmap: Optional[np.ndarray] = None,
                device=None) -> SceneBundle:
    """Synthetic stand-in for the paper's production scenes: a plume in a
    2x cube, an orbit of sensors and an envmap (procedural sky if none)."""
    device = resolve_device(device)
    params = _params(*procedural_smoke_grids(res, seed), device)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] *= 2.0
    T[:3, 3] = [-1.0, -1.0, -1.0]
    if envmap is None:
        envmap = procedural_sky(64, 128)
    cams = orbit_cameras(n_sensors, radius=4.5, target=(0.0, 0.0, 0.0),
                         elevation_deg=15.0, fov_x_deg=40.0,
                         resx=resx, resy=resy, device=device)
    return SceneBundle(
        params=params,
        medium_cfg=MediumConfig(majorant_factor=majorant_factor,
                                scale=density_scale),
        emitter=make_envmap(envmap, device=device),
        cameras=cams, to_world=T, film_size=(resx, resy),
        start_from=_start(params, density_scale))


def bundle_from_numpy(d: dict, device=None) -> SceneBundle:
    """Build a bundle from plain numpy arrays.

    Keys: ``sigma_t``, ``albedo``, ``emission`` (grids); optional
    ``start_sigma_t``/``start_albedo``/``start_emission``;
    ``majorant_factor``, ``scale``, ``phase_g`` and optional
    ``kernel_majorant_max_cells`` (medium config); ``cam_to_world``,
    ``tan_half_fov``, ``aspect`` (cameras); ``to_world``; ``film_size``;
    optional ``max_depth``; and either ``radiance`` (constant emitter) or
    ``env_data``, ``env_alias_tab``, ``env_flat_data``, ``env_row_pmf``,
    ``env_cond_pmf``, ``env_to_world`` (envmap emitter).  An envmap's
    coarse NEE proxy is built from ``env_data`` as ``make_envmap`` builds
    it (maps above 8192 texels); it equals the JAX bundle's
    ``emitter.nee`` bit for bit."""
    device = resolve_device(device)

    def t(x):   # a copy: the caller's arrays may be read-only views
        return torch.as_tensor(np.array(x, np.float32), device=device)

    params = MediumParams(sigma_t=t(d["sigma_t"]), albedo=t(d["albedo"]),
                          emission=t(d["emission"]))
    start = None
    if "start_sigma_t" in d:
        start = MediumParams(sigma_t=t(d["start_sigma_t"]),
                             albedo=t(d["start_albedo"]),
                             emission=t(d["start_emission"]))
    cfg_kw = {k: d[k] for k in ("majorant_factor", "scale", "phase_g",
                                "kernel_majorant_max_cells") if k in d}
    cfg_kw["majorant_factor"] = int(cfg_kw["majorant_factor"])
    for k in ("scale", "phase_g"):
        if k in cfg_kw:
            cfg_kw[k] = float(cfg_kw[k])
    if "radiance" in d:
        emitter = ConstantEmitter(radiance=t(d["radiance"]))
    else:
        nee = nee_proxy(np.asarray(d["env_data"], np.float32),
                        np.asarray(d["env_to_world"], np.float32), device=device)
        emitter = EnvmapEmitter(
            data=t(d["env_data"]), row_pmf=t(d["env_row_pmf"]),
            cond_pmf=t(d["env_cond_pmf"]), alias_tab=t(d["env_alias_tab"]),
            flat_data=t(d["env_flat_data"]), to_world=t(d["env_to_world"]), nee=nee)
    cams = Cameras(cam_to_world=t(d["cam_to_world"]),
                   tan_half_fov=t(d["tan_half_fov"]), aspect=t(d["aspect"]))
    return SceneBundle(
        params=params, medium_cfg=MediumConfig(**cfg_kw), emitter=emitter,
        cameras=cams, to_world=np.asarray(d["to_world"], np.float32),
        film_size=tuple(int(x) for x in d["film_size"]),
        max_depth=int(d.get("max_depth", 64)), start_from=start)


def params_from_numpy(d: dict, device=None) -> MediumParams:
    """Grids from numpy arrays under keys ``sigma_t``, ``albedo`` and
    ``emission`` (a copy, on ``device``)."""
    device = resolve_device(device)
    return MediumParams(*[torch.as_tensor(np.array(d[k], np.float32), device=device)
                          for k in MediumParams._fields])


def adam_state_from_numpy(d: dict, device=None):
    """An AdamState from the full-state checkpoint layout: ``step`` and
    ``mu.<grid>``, ``nu.<grid>`` for each grid."""
    from ..opt.optimizer import AdamState
    device = resolve_device(device)

    def grids(prefix):
        return params_from_numpy({k: d[f"{prefix}.{k}"] for k in MediumParams._fields},
                                 device=device)

    return AdamState(step=int(d["step"]), mu=grids("mu"), nu=grids("nu"))
