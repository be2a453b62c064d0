from .profiling import PhaseTimer, ThroughputMeter, trace  # noqa: F401
from .cache import gallery, pickle_cache, render_cache  # noqa: F401
