from .fd import fd_gradients  # noqa: F401
