from . import common, volpath_flat, volpathsimple  # noqa: F401
from .common import mis_weight  # noqa: F401
from .volpathsimple import PathState, VolpathConfig  # noqa: F401
