from .batched import (  # noqa: F401
    RenderSettings, render_batch, render_image, sample_batch_pixels,
)
