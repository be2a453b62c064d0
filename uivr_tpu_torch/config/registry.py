"""Config registries: scene and integrator presets.

Port of ``uivr_tpu/config/registry.py`` with the same names and values.
A preset with a Mitsuba XML scene loads it (``config/xml_scene.py``) when
the XML file and every asset it names are under ``$UIVR_SCENE_DIR``
(default ``./scenes``); without the assets (a checkout holds the XML files
only) it builds through its procedural ``builder``.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from copy import deepcopy
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Union

from ..integrators.nerf import NerfConfig
from ..integrators.volpathsimple import VolpathConfig
from .scenes import SceneBundle, cube_test_scene, smoke_scene
from .xml_scene import load_xml_scene, xml_variables


# ---------------------------------------------------------------- integrators

@dataclass(frozen=True)
class IntegratorPreset:
    name: str
    pretty_name: str
    kind: str                      # 'nerf' | 'volpath'
    params: Dict = field(default_factory=dict)
    uses_fd: bool = False
    fd_epsilon: Optional[float] = None
    fd_spp_multiplier: int = 16

    def create(self, max_depth: int) -> Union[NerfConfig, VolpathConfig]:
        if self.kind == "nerf":
            return NerfConfig(**self.params)
        # rr_depth = max_depth + 1000 disables Russian roulette
        return VolpathConfig(max_depth=max_depth, rr_depth=max_depth + 1000,
                             **self.params)


_INTEGRATORS: Dict[str, IntegratorPreset] = {}


def add_int_config(name: str, **kwargs) -> None:
    if name in _INTEGRATORS:
        raise ValueError(f"duplicate integrator config: {name}")
    _INTEGRATORS[name] = IntegratorPreset(name=name, **kwargs)


def get_int_config(name: str) -> IntegratorPreset:
    return deepcopy(_INTEGRATORS[name])


def list_int_configs() -> List[str]:
    return sorted(_INTEGRATORS)


add_int_config("fd-forward", pretty_name="Finite differences",
               kind="volpath", params={"use_drt": False},
               uses_fd=True, fd_epsilon=5e-3)
add_int_config("volpathsimple-drt",
               pretty_name="Differential Ratio Tracking", kind="volpath",
               params={"use_drt": True, "use_drt_subsampling": True,
                       "use_drt_mis": True})
add_int_config("volpathsimple-drt-quadratic",
               pretty_name="Differential Ratio Tracking (quadratic)",
               kind="volpath",
               params={"use_drt": True, "use_drt_subsampling": False,
                       "use_drt_mis": True, "engine": "nested"})
add_int_config("volpathsimple-basic", pretty_name="Free-flight based",
               kind="volpath", params={"use_drt": False})
add_int_config("nerf", pretty_name="NeRF (grid-backed)", kind="nerf",
               params={"queries_per_ray": 128})


# ---------------------------------------------------------------- scenes

@dataclass(frozen=True)
class ScenePreset:
    name: str
    builder: Callable[..., SceneBundle]
    builder_kwargs: Dict = field(default_factory=dict)
    max_depth: int = 64
    ref_spp: int = 8192
    ref_integrator: str = "volpathsimple-basic"
    max_density: float = 250.0
    param_lr_factors: Dict[str, float] = field(
        default_factory=lambda: {"albedo": 2.0})
    warm_start_from: Optional[str] = None
    scene_xml: Optional[str] = None
    scene_vars: Dict = field(default_factory=dict)
    ref_scene_vars: Optional[Dict] = None
    ref_xml: Optional[str] = None
    start_from_value: Dict = field(default_factory=dict)
    sensors: Optional[tuple] = None
    preview_sensors: Optional[tuple] = None

    def _apply_rig(self, b: SceneBundle) -> SceneBundle:
        n = b.cameras.n_sensors
        if self.sensors and max(self.sensors) < n:
            b.sensors = tuple(self.sensors)
        if self.preview_sensors and max(self.preview_sensors) < n:
            b.preview_sensors = tuple(self.preview_sensors)
        return b

    @staticmethod
    def _xml_path(xml: str) -> str:
        return os.path.join(os.environ.get("UIVR_SCENE_DIR", "scenes"), xml)

    def _xml_ready(self, xml: Optional[str], variables: Dict) -> bool:
        """The XML scene ``xml`` and every asset its variables name
        (``*_filename``, the file's defaults included) exist under
        $UIVR_SCENE_DIR."""
        if not xml or not os.path.exists(self._xml_path(xml)):
            return False
        path = self._xml_path(xml)
        names = xml_variables(ET.parse(path).getroot(), variables)
        return all(os.path.exists(os.path.join(os.path.dirname(path), v))
                   for k, v in names.items() if k.endswith("_filename"))

    def _load_xml(self, xml: str, variables: Dict, device, **kw) -> SceneBundle:
        b = load_xml_scene(self._xml_path(xml), variables=variables,
                           max_density=self.max_density, device=device, **kw)
        b.max_depth = self.max_depth
        return self._apply_rig(b)

    def build(self, device=None) -> SceneBundle:
        """Training scene: the XML scene with the normal scene vars and the
        ``start_from_value`` start grids where it and its assets exist,
        else the procedural stand-in ``builder``."""
        if self._xml_ready(self.scene_xml, self.scene_vars):
            return self._load_xml(self.scene_xml, self.scene_vars, device,
                                  start_from_value=self.start_from_value)
        b = self.builder(**self.builder_kwargs, device=device)
        b.max_depth = self.max_depth
        b.max_density = self.max_density
        return self._apply_rig(b)

    def build_ref(self, device=None) -> SceneBundle:
        """Reference-render scene: the ground-truth volumes through
        ``ref_scene_vars`` and the dedicated reference XML where the scene
        has one; the procedural stand-in's grids are the ground truth."""
        xml = self.ref_xml or self.scene_xml
        if xml:
            path = self._xml_path(xml)
            if (self.ref_xml and not os.path.exists(path)
                    and self._xml_ready(self.scene_xml, self.scene_vars)):
                # references of the training scene's start grids would be
                # meaningless
                raise FileNotFoundError(
                    f"{self.name}: reference scene {path} is missing while "
                    f"{self.scene_xml} exists; references rendered from the "
                    "training scene would be meaningless")
            if os.path.exists(path) and self.ref_xml and self.ref_integrator == "path":
                raise NotImplementedError(
                    f"{self.name}: the reference renders its reference images "
                    "from a SURFACE scene with a 'path' integrator, which a "
                    "volumes-only tracer cannot; provide precomputed references")
            vars_ = self.ref_scene_vars if self.ref_scene_vars is not None \
                else self.scene_vars
            if self._xml_ready(xml, vars_):
                return self._load_xml(xml, vars_, device)
        return self.build(device=device)


_SCENES: Dict[str, ScenePreset] = {}


def add_scene_config(name: str, **kwargs) -> None:
    if name in _SCENES:
        raise ValueError(f"duplicate scene config: {name}")
    _SCENES[name] = ScenePreset(name=name, **kwargs)


def add_scene_config_variant(name: str, base: str, **kwargs) -> None:
    if name in _SCENES:
        raise ValueError(f"duplicate scene config: {name}")
    _SCENES[name] = replace(deepcopy(_SCENES[base]), name=name, **kwargs)


def get_scene_config(name: str) -> ScenePreset:
    return deepcopy(_SCENES[name])


def list_scene_configs() -> List[str]:
    return sorted(_SCENES)


add_scene_config("tiny-cube", builder=cube_test_scene,
                 builder_kwargs={"resx": 64, "resy": 64}, max_depth=16,
                 max_density=20.0)
# calibrated 64-camera rig subsets; they apply only to 64-sensor rigs, so
# the procedural stand-ins (62/63/61 cameras) train on every camera
_SENS_NO_52_53 = tuple(i for i in range(64) if i not in (52, 53))
_SENS_NO_53 = tuple(i for i in range(64) if i != 53)
_SENS_ALL = tuple(range(64))

add_scene_config("janga-smoke", builder=smoke_scene,
                 scene_xml='janga-smoke/janga-smoke.xml',
                 scene_vars={'resx': 720, 'resy': 620, 'envmap_filename': 'textures/gamrig_2k.hdr', 'majorant_resolution_factor': 8},
                 ref_scene_vars={'resx': 720, 'resy': 620, 'medium_filename': 'volumes/janga-smoke-264-136-136.vol', 'albedo_filename': 'volumes/albedo-noise-256-128-128.vol', 'emission_filename': 'volumes/albedo-noise-256-128-128.vol', 'envmap_filename': 'textures/gamrig_2k.hdr', 'majorant_resolution_factor': 8},
                 sensors=_SENS_NO_52_53,
                 start_from_value={'medium1.sigma_t.data': 0.002, 'medium1.albedo.data': 0.6, 'medium1.emission.data': 0.005},
                 builder_kwargs={"res": 128, "resx": 180, "resy": 155,
                                 "n_sensors": 62, "density_scale": 20.0,
                                 "seed": 1, "majorant_factor": 16})
add_scene_config("dust-devil", builder=smoke_scene,
                 scene_xml='dust-devil/dust-devil.xml',
                 scene_vars={'resx': 620, 'resy': 720, 'envmap_filename': 'textures/kloofendal_38d_partly_cloudy_4k.exr', 'majorant_resolution_factor': 8},
                 ref_scene_vars={'resx': 620, 'resy': 720, 'medium_filename': 'volumes/embergen_dust_devil_tornado_a_50-256-256-256.vol', 'albedo_filename': 'volumes/albedo-constant-sand-256-256-256.vol', 'emission_filename': 'volumes/albedo-constant-sand-256-256-256.vol', 'envmap_filename': 'textures/kloofendal_38d_partly_cloudy_4k.exr', 'majorant_resolution_factor': 8},
                 sensors=_SENS_NO_53,
                 start_from_value={'medium1.sigma_t.data': 0.0004, 'medium1.albedo.data': 0.6, 'medium1.emission.data': 0.001},
                 builder_kwargs={"res": 256, "resx": 155, "resy": 180,
                                 "n_sensors": 63, "density_scale": 100.0,
                                 "seed": 2, "majorant_factor": 32})
add_scene_config("astronaut-rotated", builder=smoke_scene,
                 scene_xml='astronaut-rotated/astronaut-rotated.xml',
                 ref_xml='astronaut-rotated/astronaut-rotated-ref.xml',
                 ref_integrator="path",
                 scene_vars={'resx': 720, 'resy': 1080, 'medium_filename': 'volumes/sigma_t-constant-sand-256-256-256.vol', 'albedo_filename': 'volumes/albedo-constant-sand-256-256-256.vol', 'emission_filename': 'volumes/albedo-constant-sand-256-256-256.vol', 'envmap_filename': 'textures/skylit_garage_4k.exr', 'majorant_resolution_factor': 8},
                 ref_scene_vars={'resx': 720, 'resy': 1080, 'envmap_filename': 'textures/skylit_garage_4k.exr'},
                 sensors=_SENS_ALL, preview_sensors=(0,),
                 start_from_value={'medium1.sigma_t.data': 0.04, 'medium1.albedo.data': 0.6, 'medium1.emission.data': 0.1},
                 builder_kwargs={"res": 128, "resx": 120, "resy": 180,
                                 "n_sensors": 64, "density_scale": 2.0,
                                 "seed": 3, "majorant_factor": 16})
add_scene_config("rover", builder=smoke_scene,
                 scene_xml='rover/rover.xml',
                 ref_xml='rover/rover-ref.xml',
                 ref_integrator="path",
                 scene_vars={'resx': 860, 'resy': 720, 'medium_filename': 'volumes/sigma_t-constant-sand-256-256-256.vol', 'albedo_filename': 'volumes/albedo-constant-sand-256-256-256.vol', 'emission_filename': 'volumes/albedo-constant-sand-256-256-256.vol', 'envmap_filename': 'textures/gamrig_2k.hdr', 'majorant_resolution_factor': 8},
                 ref_scene_vars={'resx': 860, 'resy': 720, 'envmap_filename': 'textures/gamrig_2k.hdr'},
                 sensors=_SENS_NO_52_53,
                 start_from_value={'medium1.sigma_t.data': 0.04, 'medium1.albedo.data': 0.6, 'medium1.emission.data': 0.1},
                 builder_kwargs={"res": 128, "resx": 215, "resy": 180,
                                 "n_sensors": 61, "density_scale": 2.0,
                                 "seed": 4, "majorant_factor": 16})
add_scene_config("tree-2", builder=smoke_scene,
                 scene_xml='tree-2/tree-2.xml',
                 ref_xml='tree-2/tree-2-ref.xml',
                 ref_integrator="path",
                 scene_vars={'resx': 720, 'resy': 900, 'medium_filename': 'volumes/sigma_t-constant-sand-256-256-256.vol', 'albedo_filename': 'volumes/albedo-constant-sand-256-256-256.vol', 'emission_filename': 'volumes/albedo-constant-sand-256-256-256.vol', 'envmap_filename': 'textures/round_platform_2k.hdr', 'majorant_resolution_factor': 8},
                 ref_scene_vars={'resx': 720, 'resy': 900, 'envmap_filename': 'textures/round_platform_2k.hdr'},
                 sensors=_SENS_ALL,
                 start_from_value={'medium1.sigma_t.data': 0.04, 'medium1.albedo.data': 0.6, 'medium1.emission.data': 0.1},
                 builder_kwargs={"res": 128, "resx": 144, "resy": 180,
                                 "n_sensors": 64, "density_scale": 2.0,
                                 "seed": 5, "majorant_factor": 16})
for _base in ("janga-smoke", "dust-devil", "astronaut-rotated", "rover",
              "tree-2"):
    _extra = {}
    if _base == "dust-devil":
        _extra["param_lr_factors"] = {"albedo": 100.0}
    add_scene_config_variant(f"{_base}-from-nerf", _base,
                             warm_start_from=f"{_base}/nerf/params",
                             **_extra)
