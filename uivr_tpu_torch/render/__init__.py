from .batched import (  # noqa: F401
    RenderOp, RenderSettings, make_render, render_backward, render_batch,
    render_image, sample_batch_pixels,
)
