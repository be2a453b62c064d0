"""Radiance RGBE (.hdr) codec, numpy only.

Port of ``uivr_tpu/core/hdr_io.py``: the same writer (flat RGBE pixels, so
the files are byte-identical) and a reader of the same scanline formats
(new-style per-component run-length scanlines, flat RGBE pixels with
old-style (1,1,1,n) run markers).  A flat scanline without run markers is
copied whole; run-length scanlines decode run by run.

Format: text header terminated by an empty line, a resolution line
``-Y H +X W``, then H scanlines.  Pixel decode: rgb = mantissa / 256 *
2^(e - 128).
"""
from __future__ import annotations

import numpy as np


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 as flat (non-RLE) RGBE."""
    img = np.asarray(img, np.float32)
    H, W, _ = img.shape
    maxc = img.max(axis=-1)
    valid = maxc > 1e-32
    e = np.zeros((H, W), np.int32)
    mant = np.zeros((H, W), np.float64)
    m, ex = np.frexp(maxc[valid])            # maxc = m * 2^ex, m in [0.5,1)
    e[valid] = ex
    mant[valid] = m / maxc[valid] * 256.0
    rgbe = np.zeros((H, W, 4), np.uint8)
    scaled = np.clip(img * mant[..., None], 0, 255)
    rgbe[..., :3] = scaled.astype(np.uint8)
    rgbe[..., 3] = np.where(valid, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {H} +X {W}\n".encode())
        f.write(rgbe.tobytes())


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)  # 2^(e-128)/256
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]
            ).astype(np.float32)


def _rle_scanline(buf: np.ndarray, i: int, row: np.ndarray) -> int:
    """Decode one new-style scanline's four run-length component planes
    into ``row`` (W, 4) from ``buf[i:]``; returns the next offset."""
    W = row.shape[0]
    for c in range(4):
        x = 0
        while x < W:
            n = int(buf[i])
            if n > 128:             # run of one value
                row[x:x + n - 128, c] = buf[i + 1]
                x += n - 128
                i += 2
            else:                   # literal dump of n values
                row[x:x + n, c] = buf[i + 1:i + 1 + n]
                x += n
                i += 1 + n
    return i


def _flat_scanline(buf: np.ndarray, i: int, row: np.ndarray) -> int:
    """Decode one flat scanline (RGBE pixels, old-style run markers) into
    ``row`` (W, 4) from ``buf[i:]``; returns the next offset."""
    W = row.shape[0]
    px = buf[i:i + 4 * W].reshape(-1, 4)
    marker = (px[:, 0] == 1) & (px[:, 1] == 1) & (px[:, 2] == 1)
    marker[0] = False               # a marker needs a pixel before it
    if px.shape[0] == W and not marker.any():
        row[:] = px
        return i + 4 * W
    x = 0
    rshift = 0
    while x < W:
        p = buf[i:i + 4]
        if p[0] == 1 and p[1] == 1 and p[2] == 1 and x > 0:
            # old-style run marker; CONSECUTIVE markers shift the count 8
            # bits further each (Radiance color.c rule for runs longer than
            # 255 pixels)
            if rshift > 24:         # corrupt: count would overflow W
                raise ValueError("corrupt old-style RLE run")
            n = int(p[3]) << rshift
            if x + n > W:
                raise ValueError("old-style RLE run exceeds width")
            row[x:x + n] = row[x - 1]
            x += n
            rshift += 8
        else:
            row[x] = p
            x += 1
            rshift = 0
        i += 4
    return i


def read_hdr(path: str) -> np.ndarray:
    """Read a .hdr file into (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    # header: lines until the first empty line, then the resolution line
    pos = 0
    while True:
        nl = data.index(b"\n", pos)
        if nl == pos:                       # empty line ends the header
            pos = nl + 1
            break
        pos = nl + 1
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    H, W = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=pos)
    out = np.zeros((H, W, 4), np.uint8)
    i = 0
    for y in range(H):
        if (W >= 8 and W < 32768 and buf[i] == 2 and buf[i + 1] == 2
                and (int(buf[i + 2]) << 8 | int(buf[i + 3])) == W):
            i = _rle_scanline(buf, i + 4, out[y])
        else:
            i = _flat_scanline(buf, i, out[y])
    return _decode_rgbe(out)
