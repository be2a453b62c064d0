"""Mitsuba 3 XML scene ingestion.

Port of ``uivr_tpu/config/xml_scene.py``: the scene subset the reference's
files use (perspective sensors, ONE shape with a null BSDF and an interior
heterogeneous medium of gridvolumes, an envmap or constant emitter):

- ``<default name= value=>`` + ``$var`` substitution (user vars override)
- ``<transform>`` with matrix / lookat / translate / rotate / scale
- ``<sensor type="perspective">``: fov (+fov_axis), film width/height
- ``<emitter type="envmap"|"constant">``: .exr/.hdr radiance, scale,
  to_world; an envmap above 8192 texels gets its coarse NEE proxy
  (``make_envmap``), so the walking kernels take K3b on it
- ``<shape>``: to_world box (type ``cube`` = [-1,1]^3, obj files get their
  AABB parsed; anything else = unit cube), ``<medium type="heterogeneous">``
  with gridvolume sigma_t/albedo/emission (.vol files or constant
  spectra), scale, majorant resolution factor, phase isotropic/hg

Albedo and emission grids of another resolution than sigma_t's are
resampled onto it (``core/grids.resize_trilinear``): the walking kernels
read one interleaved sigma+albedo grid.  Returns a
:class:`uivr_tpu_torch.config.scenes.SceneBundle` on ``device``.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.exr_io import read_exr
from ..core.grids import resize_trilinear
from ..core.hdr_io import read_hdr
from ..core.vol_io import read_vol
from ..scene.camera import Cameras
from ..scene.emitters import constant_emitter, make_envmap
from ..scene.medium import MediumConfig, MediumParams
from .scenes import SceneBundle

def _subst(value: str, variables: Dict[str, str]) -> str:
    if "$" not in value:
        return value
    # longest-first so $resx2 is not clobbered by $resx
    for k in sorted(variables, key=len, reverse=True):
        value = value.replace("$" + k, str(variables[k]))
    return value


def _floats(s: str):
    return [float(x) for x in s.replace(",", " ").split()]


def _parse_transform(node: Optional[ET.Element],
                     variables: Dict[str, str]) -> np.ndarray:
    """Compose child ops in document order (Mitsuba semantics: each op
    PRE-multiplies, i.e. later elements apply after earlier ones)."""
    m = np.eye(4, dtype=np.float64)
    if node is None:
        return m.astype(np.float32)
    for ch in node:
        g = lambda k, d=None: _subst(ch.get(k, d), variables) \
            if ch.get(k, d) is not None else None
        op = np.eye(4, dtype=np.float64)
        if ch.tag == "matrix":
            v = _floats(g("value"))
            if len(v) == 16:
                op = np.array(v, np.float64).reshape(4, 4)
            elif len(v) == 9:
                op[:3, :3] = np.array(v, np.float64).reshape(3, 3)
            else:
                raise ValueError(f"matrix needs 9/16 values, got {len(v)}")
        elif ch.tag == "translate":
            if g("value") is not None:
                t = _floats(g("value"))
            else:
                t = [float(g("x", "0")), float(g("y", "0")),
                     float(g("z", "0"))]
            op[:3, 3] = t
        elif ch.tag == "scale":
            if g("value") is not None:
                v = _floats(g("value"))
                s = v * 3 if len(v) == 1 else v
            else:
                s = [float(g("x", "1")), float(g("y", "1")),
                     float(g("z", "1"))]
            op[0, 0], op[1, 1], op[2, 2] = s
        elif ch.tag == "rotate":
            axis = np.array([float(g("x", "0")), float(g("y", "0")),
                             float(g("z", "0"))], np.float64)
            n = np.linalg.norm(axis)
            axis = axis / (n if n > 0 else 1.0)
            a = np.deg2rad(float(g("angle", "0")))
            c, s_ = np.cos(a), np.sin(a)
            x, y, z = axis
            op[:3, :3] = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s_,
                 x * z * (1 - c) + y * s_],
                [y * x * (1 - c) + z * s_, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s_],
                [z * x * (1 - c) - y * s_, z * y * (1 - c) + x * s_,
                 c + z * z * (1 - c)]])
        elif ch.tag == "lookat":
            origin = np.array(_floats(g("origin")), np.float64)
            target = np.array(_floats(g("target")), np.float64)
            up = np.array(_floats(g("up", "0, 1, 0")), np.float64)
            fwd = target - origin
            fwd /= np.linalg.norm(fwd)
            right = np.cross(up, fwd)
            nr = np.linalg.norm(right)
            if nr < 1e-9:
                right = np.cross(np.array([0.0, 0.0, 1.0]), fwd)
                nr = np.linalg.norm(right)
            right /= nr
            new_up = np.cross(fwd, right)
            # Mitsuba camera space: x-left-handed differences are absorbed
            # by our x-right/y-up/+z-forward convention (scene/camera.py)
            op[:3, 0] = -right
            op[:3, 1] = new_up
            op[:3, 2] = fwd
            op[:3, 3] = origin
        else:
            raise ValueError(f"unsupported transform op <{ch.tag}>")
        m = op @ m
    return m.astype(np.float32)


def _props(node: ET.Element, variables: Dict[str, str]) -> Dict[str, object]:
    """Collect the simple typed children of a plugin node."""
    out: Dict[str, object] = {}
    for ch in node:
        nm = ch.get("name")
        if ch.tag in ("float", "integer"):
            out[nm] = (float if ch.tag == "float" else int)(
                _subst(ch.get("value"), variables))
        elif ch.tag in ("string", "boolean"):
            v = _subst(ch.get("value"), variables)
            out[nm] = (v == "true") if ch.tag == "boolean" else v
        elif ch.tag in ("rgb", "spectrum", "vector", "point"):
            out[nm] = _floats(_subst(ch.get("value"), variables))
    return out


def _obj_aabb(path: str):
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                v = np.array([float(x) for x in line.split()[1:4]])
                lo = np.minimum(lo, v)
                hi = np.maximum(hi, v)
    return lo, hi


def _read_radiance(path: str) -> np.ndarray:
    """(H, W, 3) float32 radiance of a .hdr or .exr envmap."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".exr":
        img = read_exr(path)
        return np.asarray(img, np.float32)[..., :3]
    raise ValueError(f"unsupported envmap format: {path}")


def _load_gridvolume(vol: ET.Element, variables: Dict[str, str],
                     base_dir: str, channels: int) -> np.ndarray:
    p = _props(vol, variables)
    ty = vol.get("type")
    if ty == "gridvolume":
        data, _bbox = read_vol(os.path.join(base_dir, str(p["filename"])))
        if data.ndim == 3:
            data = data[..., None]
        if data.shape[-1] == 1 and channels == 3:
            data = np.repeat(data, 3, axis=-1)
        return np.asarray(data[..., :channels], np.float32)
    if ty == "constvolume":
        v = p.get("value", 1.0)
        v = [v] * channels if isinstance(v, (int, float)) else v
        return np.broadcast_to(np.asarray(v, np.float32),
                               (1, 1, 1, channels)).copy()
    raise ValueError(f"unsupported volume type {ty!r}")


def xml_variables(root: ET.Element, variables: Dict[str, object] = None
                  ) -> Dict[str, str]:
    """The scene's variables: ``variables`` over the file's ``<default>``s."""
    out = {k: str(v) for k, v in (variables or {}).items()}
    for ch in root.iter("default"):
        out.setdefault(ch.get("name"), ch.get("value"))
    return out


def load_xml_scene(path: str, variables: Dict[str, object] = None,
                   start_from_value: Dict[str, float] = None,
                   max_density: float = 250.0, device=None) -> SceneBundle:
    """Parse a Mitsuba XML scene into a SceneBundle on ``device``.

    ``variables``: the reference's scene vars (``resx``, ``resy``,
    ``envmap_filename``, ``medium_filename``, ...); they override the
    file's ``<default>`` values.  ``start_from_value``: optional constant
    start grids per parameter key (``medium1.sigma_t.data``, ...)."""
    device = resolve_device(device)
    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    variables = xml_variables(root, variables)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

    # ---- sensors ----------------------------------------------------------
    cams, film = [], None
    for sensor in root.iter("sensor"):
        if sensor.get("type") != "perspective":
            raise ValueError(f"unsupported sensor {sensor.get('type')!r}")
        p = _props(sensor, variables)
        fov = float(p.get("fov", 34.0))
        to_world = _parse_transform(sensor.find("transform"), variables)
        f = sensor.find("film")
        own = None
        if f is not None:
            fp = _props(f, variables)
            own = (int(fp.get("width", 768)), int(fp.get("height", 576)))
            # only a sensor WITH a film block sets the film size
            film = film or own
        if str(p.get("fov_axis", "x")) == "y":
            # an x-axis fov through this sensor's own aspect ratio
            fw, fh = own or (768, 576)
            fov = np.rad2deg(2 * np.arctan(
                np.tan(np.deg2rad(fov) / 2) * (fw / fh)))
        cams.append((to_world, fov))
    if not cams:
        raise ValueError("scene has no perspective sensors")
    film = film or (768, 576)
    cameras = Cameras(
        cam_to_world=t(np.stack([c[0] for c in cams])),
        tan_half_fov=t(np.tan(np.deg2rad(
            np.array([c[1] for c in cams], np.float32)) * 0.5)),
        aspect=torch.full((len(cams),), film[1] / film[0], dtype=torch.float32,
                          device=device))

    # ---- emitter -----------------------------------------------------------
    emitter = None
    for em in root.iter("emitter"):
        ty = em.get("type")
        p = _props(em, variables)
        if ty == "envmap":
            img = _read_radiance(os.path.join(base_dir, str(p["filename"])))
            img = img * float(p.get("scale", 1.0))
            rot = _parse_transform(em.find("transform"), variables)
            emitter = make_envmap(img, to_world=rot[:3, :3], device=device)
        elif ty == "constant":
            rad = p.get("radiance", [1.0, 1.0, 1.0])
            rad = [rad] * 3 if isinstance(rad, float) else rad
            emitter = constant_emitter(rad, device=device)
        else:
            raise ValueError(f"unsupported emitter {ty!r}")
    if emitter is None:
        raise ValueError("scene has no emitter")

    # ---- the single medium shape ------------------------------------------
    media = [(sh, md) for sh in root.iter("shape")
             for md in sh.iter("medium")]
    if len(media) != 1:
        raise ValueError(f"expected exactly 1 shape with an interior medium,"
                         f" found {len(media)}")
    shape, medium = media[0]
    shape_tw = _parse_transform(shape.find("transform"), variables)
    # the medium's local frame is the unit cube [0,1]^3: the shape's
    # object-space bounds go in front of its to_world
    sty = shape.get("type")
    if sty == "cube":
        lo, hi = np.full(3, -1.0), np.full(3, 1.0)
    elif sty == "obj":
        sp = _props(shape, variables)
        objp = os.path.join(base_dir, str(sp.get("filename", "")))
        if os.path.exists(objp):
            lo, hi = _obj_aabb(objp)
        else:
            lo, hi = np.zeros(3), np.ones(3)
    else:
        lo, hi = np.zeros(3), np.ones(3)
    box = np.eye(4, dtype=np.float32)
    box[[0, 1, 2], [0, 1, 2]] = (hi - lo).astype(np.float32)
    box[:3, 3] = lo.astype(np.float32)
    to_world = shape_tw @ box

    mp = _props(medium, variables)
    vols = {v.get("name"): v for v in medium.findall("volume")}
    if "sigma_t" not in vols:
        raise ValueError("medium has no sigma_t gridvolume")
    sigma = _load_gridvolume(vols["sigma_t"], variables, base_dir, 1)
    D, H_, W_ = sigma.shape[:3]

    def grid_or(name, channels, default):
        if name in vols:
            g = _load_gridvolume(vols[name], variables, base_dir, channels)
            if g.shape[:3] == (1, 1, 1):
                g = np.broadcast_to(g, (D, H_, W_, channels)).copy()
            return g
        return np.full((D, H_, W_, channels), default, np.float32)

    def on_sigma_grid(name, g):
        """Resample a grid of another resolution onto sigma_t's (the one
        place ingestion is not bit-faithful to the assets, so it says so)."""
        g = t(g)
        if tuple(g.shape[:3]) == (D, H_, W_):
            return g
        print(f"[xml] {name} grid {tuple(g.shape[:3])} resampled to sigma_t "
              f"resolution {(D, H_, W_)} (the kernels read one interleaved "
              "sigma+albedo grid)")
        return resize_trilinear(g, (D, H_, W_))

    params = MediumParams(sigma_t=t(sigma),
                          albedo=on_sigma_grid("albedo", grid_or("albedo", 3, 0.8)),
                          emission=on_sigma_grid("emission", grid_or("emission", 3, 0.0)))

    phase_g = 0.0
    ph = medium.find("phase")
    if ph is not None and ph.get("type") == "hg":
        phase_g = float(_props(ph, variables).get("g", 0.0))
    cfg = MediumConfig(
        majorant_factor=int(mp.get("majorant_resolution_factor", 8)),
        scale=float(mp.get("scale", 1.0)),
        phase_g=phase_g)

    start = None
    if start_from_value:
        sv = {k.split(".")[-2] if ".data" in k else k: v
              for k, v in start_from_value.items()}
        start = MediumParams(
            sigma_t=torch.full_like(params.sigma_t, sv.get("sigma_t", 0.002)),
            albedo=torch.full_like(params.albedo, sv.get("albedo", 0.6)),
            emission=torch.full_like(params.emission, sv.get("emission", 0.005)))

    return SceneBundle(params=params, medium_cfg=cfg, emitter=emitter,
                       cameras=cameras, to_world=to_world, film_size=film,
                       max_density=max_density, start_from=start)
