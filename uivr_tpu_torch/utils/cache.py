"""Disk memoization and image-montage helpers.

Port of ``uivr_tpu/utils/cache.py``: one codec-based memoizer,
``disk_memo``, owns the hit / miss / write protocol, and ``pickle_cache``
and ``render_cache`` are its pickle and EXR codecs (the EXR one through the
port's ``core/exr_io``); ``gallery`` tiles grid slices for previews.
"""
from __future__ import annotations

import functools
import os
import pickle
from typing import Callable, Tuple

import numpy as np


def _pickle_codec() -> Tuple[Callable, Callable]:
    def load(path):
        with open(path, "rb") as f:
            return pickle.load(f)

    def store(path, value):
        with open(path, "wb") as f:
            pickle.dump(value, f)
        return value

    return load, store


def _exr_codec() -> Tuple[Callable, Callable]:
    from ..core import exr_io

    def store(path, value):
        value = np.asarray(value)
        exr_io.write_exr(path, value)
        return value

    return exr_io.read_exr, store


_CODECS = {"pickle": _pickle_codec, "exr": _exr_codec}


def disk_memo(path: str, codec: str = "pickle", overwrite: bool = False,
              verbose: bool = False):
    """Decorator: memoize one call's result at ``path`` with ``codec``.

    The key is the path itself: a hit loads the file and skips the call, a
    miss runs it, makes the parent directory and stores the result."""
    load, store = _CODECS[codec]()

    def wrap(fn):
        @functools.wraps(fn)
        def memoized(*args, **kwargs):
            if os.path.exists(path) and not overwrite:
                if verbose:
                    print(f"[cache hit] {path}")
                return load(path)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            value = store(path, fn(*args, **kwargs))
            if verbose:
                print(f"[cached] {path}")
            return value
        return memoized
    return wrap


def pickle_cache(fname: str, overwrite: bool = False):
    """Pickle-codec memoizer."""
    return disk_memo(fname, codec="pickle", overwrite=overwrite)


def render_cache(fname: str, overwrite: bool = False, verbose: bool = True):
    """EXR-codec memoizer for rendered images."""
    return disk_memo(fname, codec="exr", overwrite=overwrite, verbose=verbose)


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
