from .trackers import drt_distance, transmittance  # noqa: F401
