from .trackers import drt_distance, free_flight, transmittance  # noqa: F401
