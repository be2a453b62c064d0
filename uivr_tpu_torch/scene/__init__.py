from . import camera, emitters, medium, phase, scene  # noqa: F401
from .camera import Cameras, look_at, make_cameras, orbit_cameras, sample_rays  # noqa: F401
from .emitters import ConstantEmitter, EnvmapEmitter, make_envmap  # noqa: F401
from .medium import (  # noqa: F401
    Medium, MediumConfig, MediumParams, albedo_at, emission_at, finalize_medium,
    intersect_bbox, majorant_at, sigma_albedo_at, sigma_t_at,
)
from .phase import phase_eval, phase_sample  # noqa: F401
from .scene import Emitter, Scene, make_scene, update_medium_params  # noqa: F401
