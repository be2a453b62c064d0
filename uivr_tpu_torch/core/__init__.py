from . import aabb, exr_io, grids, rng, vol_io  # noqa: F401
from .aabb import Rays, ray_unit_cube, transform_dirs, transform_points  # noqa: F401
from .device import resolve_device  # noqa: F401
from .grids import (  # noqa: F401
    build_majorant_grid, global_majorant, resize_trilinear,
    trilinear_sample, trilinear_scatter,
)
from .rng import Sampler, clone, fork, make_sampler, next_1d, next_2d, sample_tea_32  # noqa: F401
