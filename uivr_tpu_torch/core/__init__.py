from . import aabb, exr_io, grids, rng  # noqa: F401
from .device import resolve_device  # noqa: F401
