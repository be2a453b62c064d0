"""Minimal OpenEXR scanline codec (pure Python + numpy).

Port of ``uivr_tpu/core/exr_io.py`` (its pure numpy/zlib path; files are
byte-identical to the reference writer's):

- write: FLOAT RGB/RGBA/Y, scanline, uncompressed or ZIP(S) via zlib
- read:  FLOAT/HALF channels, NO_COMPRESSION / ZIPS / ZIP
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = 0x01312F76
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_NO_COMPRESSION, _ZIPS_COMPRESSION, _ZIP_COMPRESSION = 0, 2, 3
_PT_SIZE = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def _chlist(names) -> bytes:
    out = b""
    for n in sorted(names):
        out += n.encode() + b"\0" + struct.pack("<i", _PT_FLOAT)
        out += struct.pack("<B3x", 0) + struct.pack("<2i", 1, 1)
    return out + b"\0"


def _zip_predict(data: bytes) -> bytes:
    """EXR pre-compression reorder: interleave split + delta encode."""
    arr = np.frombuffer(data, dtype=np.uint8)
    half = (len(arr) + 1) // 2
    re = np.empty_like(arr)
    re[:half] = arr[0::2]
    re[half:] = arr[1::2]
    d = re.astype(np.int16)
    d[1:] = d[1:] - d[:-1] + 128 + 256
    return d.astype(np.uint8).tobytes()


def _zip_unpredict(data: bytes) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    arr[1:] -= 128
    rec = np.cumsum(arr) & 0xFF
    rec = rec.astype(np.uint8)
    half = (len(rec) + 1) // 2
    out = np.empty_like(rec)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def write_exr(path: str, image: np.ndarray, compression: str = "zip") -> None:
    """Write (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) float image."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        image = image[..., None]
    H, W, C = image.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[C]
    order = {n: i for i, n in enumerate(names)}
    sorted_names = sorted(names)

    comp = {"none": _NO_COMPRESSION, "zips": _ZIPS_COMPRESSION,
            "zip": _ZIP_COMPRESSION}[compression]
    lines_per_chunk = {_NO_COMPRESSION: 1, _ZIPS_COMPRESSION: 1,
                       _ZIP_COMPRESSION: 16}[comp]

    header = b""
    header += _attr(b"channels", b"chlist", _chlist(names))
    header += _attr(b"compression", b"compression", struct.pack("<B", comp))
    header += _attr(b"dataWindow", b"box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
    header += _attr(b"displayWindow", b"box2i", struct.pack("<4i", 0, 0, W - 1, H - 1))
    header += _attr(b"lineOrder", b"lineOrder", struct.pack("<B", 0))
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<2f", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    chunks = []
    for y0 in range(0, H, lines_per_chunk):
        ny = min(lines_per_chunk, H - y0)
        # Per scanline, channels in alphabetical order.
        lines = []
        for y in range(y0, y0 + ny):
            for n in sorted_names:
                lines.append(image[y, :, order[n]].tobytes())
        raw = b"".join(lines)
        if comp == _NO_COMPRESSION:
            payload = raw
        else:
            z = zlib.compress(_zip_predict(raw))
            payload = z if len(z) < len(raw) else raw
        chunks.append((y0, payload))

    n_chunks = len(chunks)
    offset = 8 + len(header) + 8 * n_chunks
    table = []
    body = []
    for y0, payload in chunks:
        table.append(offset)
        body.append(struct.pack("<2i", y0, len(payload)) + payload)
        offset += len(body[-1])

    with open(path, "wb") as f:
        f.write(struct.pack("<2i", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}q", *table))
        f.write(b"".join(body))


def _parse_header(raw: bytes, pos: int):
    attrs: Dict[str, Tuple[str, bytes]] = {}
    while raw[pos] != 0:
        e = raw.index(b"\0", pos)
        name = raw[pos:e].decode(); pos = e + 1
        e = raw.index(b"\0", pos)
        typ = raw[pos:e].decode(); pos = e + 1
        size, = struct.unpack_from("<i", raw, pos); pos += 4
        attrs[name] = (typ, raw[pos:pos + size]); pos += size
    return attrs, pos + 1


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR into (H, W, C) float32, channels ordered
    R,G,B[,A] when present, else alphabetically."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, version = struct.unpack_from("<2i", raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    attrs, pos = _parse_header(raw, 8)

    # channels
    chdata = attrs["channels"][1]
    channels = []
    cpos = 0
    while chdata[cpos] != 0:
        e = chdata.index(b"\0", cpos)
        cname = chdata[cpos:e].decode(); cpos = e + 1
        ptype, = struct.unpack_from("<i", chdata, cpos); cpos += 4
        cpos += 4  # pLinear + reserved
        cpos += 8  # x/y sampling
        channels.append((cname, ptype))
    channels.sort(key=lambda c: c[0])

    comp = attrs["compression"][1][0]
    if comp not in (_NO_COMPRESSION, _ZIPS_COMPRESSION, _ZIP_COMPRESSION):
        raise ValueError(f"unsupported compression {comp}")
    lines_per_chunk = 16 if comp == _ZIP_COMPRESSION else 1

    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = x1 - x0 + 1, y1 - y0 + 1
    n_chunks = -(-H // lines_per_chunk)
    offsets = struct.unpack_from(f"<{n_chunks}q", raw, pos)

    line_bytes = sum(W * _PT_SIZE[pt] for _, pt in channels)
    out = {c: np.empty((H, W), dtype=np.float32) for c, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<2i", raw, off)
        payload = raw[off + 8: off + 8 + size]
        ny = min(lines_per_chunk, y1 - y + 1)
        expect = line_bytes * ny
        if comp != _NO_COMPRESSION and size != expect:
            payload = _zip_unpredict(zlib.decompress(payload))
        if len(payload) != expect:
            raise ValueError(f"corrupt EXR chunk at scanline {y}")
        p = 0
        for yi in range(y - y0, y - y0 + ny):
            for cname, pt in channels:
                nb = W * _PT_SIZE[pt]
                vals = np.frombuffer(payload, dtype=_PT_DTYPE[pt], count=W, offset=p)
                out[cname][yi] = vals.astype(np.float32)
                p += nb

    names = [c for c, _ in channels]
    for pref in (["R", "G", "B", "A"], ["R", "G", "B"], ["Y"]):
        if all(n in names for n in pref) and len(names) == len(pref):
            return np.stack([out[n] for n in pref], axis=-1)
    return np.stack([out[n] for n in names], axis=-1)
