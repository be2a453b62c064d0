"""Scene tuple: one medium + one infinite emitter + stacked cameras.

Port of ``uivr_tpu/scene/scene.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np

from .camera import Cameras
from .emitters import ConstantEmitter, EnvmapEmitter
from .medium import Medium, MediumConfig, MediumParams, finalize_medium

Emitter = Union[ConstantEmitter, EnvmapEmitter]


class Scene(NamedTuple):
    medium: Medium
    emitter: Emitter
    cameras: Cameras


def make_scene(params: MediumParams, cfg: MediumConfig, emitter: Emitter,
               cameras: Cameras, medium_to_world: np.ndarray = None) -> Scene:
    return Scene(medium=finalize_medium(params, cfg, medium_to_world),
                 emitter=emitter, cameras=cameras)
