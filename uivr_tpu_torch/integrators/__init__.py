from . import common, nerf, volpath_flat, volpathsimple  # noqa: F401
from .common import mis_weight  # noqa: F401
from .nerf import NerfConfig  # noqa: F401
from .volpathsimple import PathState, VolpathConfig  # noqa: F401
