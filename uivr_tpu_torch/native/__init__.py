"""Host-side native helpers: the envmap's alias table, the EXR ZIP
predictors and Radiance HDR scanline decoding, in C++ bound with ctypes.

Port of ``uivr_tpu/native/__init__.py`` over a copy of its source of our
own (``uivr_native.cpp`` beside this file).  g++ builds the library at
first use into ``build/uivr_tpu_torch/`` at the root of the checkout, under
a name keyed by the source, the flags and the compiler, so an edited source
or another host's compiler builds anew.  The build is written to a
temporary name and renamed into place, so processes that build at once
never load a partial file.

Each entry point returns None where the caller is to run its Python
version (``scene/emitters._build_alias_python``, ``core/exr_io``'s
``_zip_*_python``, ``core/hdr_io._decode_scanlines_python``): when no
``g++`` is on the PATH, as the reference does for hosts without a
toolchain, and, for the HDR decoder, on malformed input, which the Python
reader then reports.  A build that fails raises with the compiler's log;
it never falls back.  :data:`CALLS` counts the calls each side served.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("uivr_native.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# calls served by the library / returned to the caller's Python version
CALLS = {"native": 0, "python": 0}

_lib = None


def build_dir() -> Path:
    """``build/uivr_tpu_torch`` at the root of the checkout."""
    return SOURCE.parents[2] / "build" / "uivr_tpu_torch"


def lib_path(gxx: str) -> Path:
    """Where ``gxx`` builds the library, keyed by the source, the flags, the
    compiler's version and the machine."""
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                             check=True).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (" ".join(GXX_FLAGS), version, platform.machine()):
        h.update(part.encode())
    return build_dir() / f"libuivr_native-{h.hexdigest()[:16]}.so"


def build(gxx: str) -> Path:
    """Build the library with ``gxx`` unless it is built; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    path = lib_path(gxx)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    """The bound library, built at the first call; None where no g++ is on
    the PATH."""
    global _lib
    if _lib is None:
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        lib = ctypes.CDLL(str(build(gxx)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.build_alias_table.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        lib.build_alias_table.restype = None
        for fn in (lib.exr_zip_predict, lib.exr_zip_unpredict):
            fn.argtypes = [u8p, ctypes.c_int64, u8p]
            fn.restype = None
        lib.hdr_decode_scanlines.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                             ctypes.c_int64, u8p]
        lib.hdr_decode_scanlines.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here: False where no g++ is on
    the PATH (the callers then run their Python versions); a build that
    fails raises."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _served(result) -> bool:
    """Count a call: served by the library when ``result`` is not None."""
    CALLS["native" if result is not None else "python"] += 1
    return result is not None


def build_alias_table(pmf: np.ndarray):
    """(alias (N,) int32, prob (N,) float32) of a float64 pmf, or None."""
    lib = _load()
    if not _served(lib):
        return None
    pmf = np.ascontiguousarray(pmf, np.float64).reshape(-1)
    alias = np.empty(pmf.size, np.int32)
    prob = np.empty(pmf.size, np.float32)
    lib.build_alias_table(_ptr(pmf, ctypes.c_double), pmf.size,
                          _ptr(alias, ctypes.c_int32), _ptr(prob, ctypes.c_float))
    return alias, prob


def _bytes_filter(fn_name: str, data: bytes):
    lib = _load()
    if not _served(lib):
        return None
    src = np.frombuffer(data, np.uint8)
    dst = np.empty_like(src)
    getattr(lib, fn_name)(_ptr(src, ctypes.c_uint8), src.size, _ptr(dst, ctypes.c_uint8))
    return dst.tobytes()


def exr_zip_predict(data: bytes):
    """EXR ZIP pre-compression filter (even bytes, odd bytes, deltas + 128),
    or None."""
    return _bytes_filter("exr_zip_predict", data)


def exr_zip_unpredict(data: bytes):
    """Inverse of :func:`exr_zip_predict`, or None."""
    return _bytes_filter("exr_zip_unpredict", data)


def hdr_decode_scanlines(payload: bytes, W: int, H: int):
    """The (H, W, 4) uint8 RGBE pixels of a Radiance file's scanlines, or
    None (also for malformed input, which the Python reader reports)."""
    if W < 0 or H < 0:
        raise ValueError(f"bad HDR resolution {W}x{H}")
    lib = _load()
    out = None
    if lib is not None:
        src = np.frombuffer(payload, np.uint8)
        out = np.empty((H, W, 4), np.uint8)
        if lib.hdr_decode_scanlines(_ptr(src, ctypes.c_uint8), src.size, W, H,
                                    _ptr(out, ctypes.c_uint8)) != 0:
            out = None
    _served(out)
    return out
