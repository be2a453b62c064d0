"""Image helpers (port of ``gallery`` from ``uivr_tpu/utils/cache.py``)."""
from __future__ import annotations

import numpy as np


def gallery(array: np.ndarray, ncols: int = 3) -> np.ndarray:
    """Tile a stack of images (N, H, W, C) into a row-major montage; N must
    fill the rows exactly."""
    array = np.asarray(array)
    n = array.shape[0]
    if n % ncols:
        raise ValueError(f"gallery: {n} images do not fill rows of {ncols}")
    rows = [np.concatenate(list(array[i:i + ncols]), axis=1)
            for i in range(0, n, ncols)]
    return np.concatenate(rows, axis=0)
