"""Mitsuba ``.vol`` volume-grid codec (read/write), numpy only.

Port of ``uivr_tpu/core/vol_io.py``; the files are byte-identical.

Format (Mitsuba 3 volume data file, version 3):
  bytes 0-2   ASCII 'VOL'
  byte  3     version (3)
  int32       encoding id (1 = float32)
  int32 x3    resolution (xres, yres, zres)
  int32       channel count
  float32 x6  bbox (xmin, ymin, zmin, xmax, ymax, zmax)
  payload     xres*yres*zres*channels float32, x fastest, then y, then z

Arrays are (D, H, W, C) = (zres, yres, xres, channels).
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_MAGIC = b"VOL"
_VERSION = 3
_ENC_FLOAT32 = 1


def write_vol(path: str, data: np.ndarray,
              bbox: Tuple[float, ...] = (0, 0, 0, 1, 1, 1)) -> None:
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 3:
        data = data[..., None]
    if data.ndim != 4:
        raise ValueError(f".vol data must be (D, H, W[, C]), got {data.shape}")
    D, H, W, C = data.shape
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<B", _VERSION))
        f.write(struct.pack("<i", _ENC_FLOAT32))
        f.write(struct.pack("<3i", W, H, D))
        f.write(struct.pack("<i", C))
        f.write(struct.pack("<6f", *bbox))
        f.write(data.tobytes(order="C"))


def read_vol(path: str) -> Tuple[np.ndarray, Tuple[float, ...]]:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:3] != _MAGIC:
        raise ValueError(f"not a .vol file: {path}")
    if raw[3] != _VERSION:
        raise ValueError(f"unsupported .vol version {raw[3]}")
    enc, = struct.unpack_from("<i", raw, 4)
    if enc != _ENC_FLOAT32:
        raise ValueError(f"unsupported encoding {enc}")
    W, H, D = struct.unpack_from("<3i", raw, 8)
    C, = struct.unpack_from("<i", raw, 20)
    bbox = struct.unpack_from("<6f", raw, 24)
    n = W * H * D * C
    data = np.frombuffer(raw, dtype="<f4", count=n, offset=48)
    return data.reshape(D, H, W, C).copy(), bbox
