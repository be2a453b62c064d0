"""Counter-based RNG: every random number is a TEA hash of (seed, lane, dim).

Port of ``uivr_tpu/core/rng.py``; the streams are bit-identical to it.

torch has no unsigned 32-bit arithmetic on the CPU, so a uint32 value lives
in an int64 tensor in ``[0, 2**32)`` and every TEA update is masked with
``0xFFFFFFFF``.  Scalars (seeds, the wavefront sampler's shared counter)
stay Python ints and hash on the host.

On ``cuda`` tensors the vector hash runs the hand-written TEA kernel
(``ops/volpath_step.tea_i32``); :func:`tea_plain` is its plain version.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
# TEA key/delta constants (public domain algorithm, Wheeler & Needham 1994).
_TEA_DELTA = 0x9E3779B9
_TEA_K0, _TEA_K1, _TEA_K2, _TEA_K3 = 0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E

# Per-draw TEA rounds of the LaneSampler streams (see the reference module
# for why 5 rounds suffice there and not for the wavefront Sampler).  The
# CUDA kernel receives this value from its wrapper.
_DRAW_ROUNDS = 5


def _as_u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _tea_numpy(v0, v1, rounds: int):
    """TEA on CPU tensors in numpy's wrapping uint32: the same bits as the
    masked int64 loop below at less than half its per-call cost."""
    a = np.asarray(v0.numpy() if isinstance(v0, torch.Tensor) else v0, np.uint32)
    b = np.asarray(v1.numpy() if isinstance(v1, torch.Tensor) else v1, np.uint32)
    k0, k1, k2, k3 = (np.uint32(k) for k in (_TEA_K0, _TEA_K1, _TEA_K2, _TEA_K3))
    four, five = np.uint32(4), np.uint32(5)
    s = 0
    with np.errstate(over="ignore"):
        for _ in range(rounds):
            s = (s + _TEA_DELTA) & _M32
            su = np.uint32(s)
            a = a + (((b << four) + k0) ^ (b + su) ^ ((b >> five) + k1))
            b = b + (((a << four) + k2) ^ (a + su) ^ ((a >> five) + k3))
    return (torch.from_numpy(np.asarray(a, np.int64)),
            torch.from_numpy(np.asarray(b, np.int64)))


def tea_plain(v0, v1, rounds: int = 6):
    """TEA block mix of two uint32 values (Python ints or int64 tensors,
    broadcasting).  Returns masked values of the same kind."""
    v0, v1 = _as_u32(v0), _as_u32(v1)
    tensors = [x for x in (v0, v1) if isinstance(x, torch.Tensor)]
    if tensors and tensors[0].device.type == "cpu":
        return _tea_numpy(v0, v1, rounds)
    s = 0
    for _ in range(rounds):
        s = (s + _TEA_DELTA) & _M32
        v0 = (v0 + (((v1 << 4) + _TEA_K0) ^ (v1 + s) ^ ((v1 >> 5) + _TEA_K1))) & _M32
        v1 = (v1 + (((v0 << 4) + _TEA_K2) ^ (v0 + s) ^ ((v0 >> 5) + _TEA_K3))) & _M32
    return v0, v1


def tea(v0, v1, rounds: int = 6):
    """TEA on Python ints (host) or tensors; a ``cuda`` tensor argument
    runs the TEA kernel."""
    tensors = [x for x in (v0, v1) if isinstance(x, torch.Tensor)]
    if tensors and tensors[0].is_cuda:
        from ..ops.volpath_step import tea_i32
        return tea_i32(v0, v1, rounds)
    return tea_plain(v0, v1, rounds)


def sample_tea_32(v0, v1, rounds: int = 6):
    """Analogue of ``mi.sample_tea_32`` for seed decorrelation."""
    return tea(v0, v1, rounds)


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


class Sampler(NamedTuple):
    """Wavefront sampler: one shared draw counter for all lanes."""
    seed: int             # uint32 stream id
    dim: int              # uint32 draw counter
    lanes: torch.Tensor   # (n,) int64 lane ids


def make_sampler(seed, n_lanes: int = None, lanes: torch.Tensor = None,
                 device=None) -> Sampler:
    if lanes is None:
        if n_lanes is None:
            raise ValueError("make_sampler needs n_lanes or lanes")
        lanes = torch.arange(n_lanes, dtype=torch.int64, device=device)
    return Sampler(seed=_as_u32(seed), dim=0, lanes=_as_u32(lanes))


def next_1d(s: Sampler) -> Tuple[torch.Tensor, Sampler]:
    """One uniform float in [0,1) per lane; advances the shared counter."""
    h0, h1 = tea_plain(s.dim, s.seed, rounds=4)
    bits, _ = tea(s.lanes, torch.full_like(s.lanes, h0 ^ h1), rounds=8)
    return _to_unit_float(bits), s._replace(dim=(s.dim + 1) & _M32)


def next_2d(s: Sampler) -> Tuple[torch.Tensor, Sampler]:
    """(n, 2) uniform floats."""
    u0, s = next_1d(s)
    u1, s = next_1d(s)
    return torch.stack([u0, u1], dim=-1), s


class LaneSampler(NamedTuple):
    """Per-lane-counter sampler of the flat tracking loop."""
    h: torch.Tensor    # (n,) hashed (seed, lane)
    dim: torch.Tensor  # (n,) per-lane draw counter


def make_lane_sampler(seed, n_lanes: int = None, lanes: torch.Tensor = None,
                      device=None) -> LaneSampler:
    if lanes is None:
        if n_lanes is None:
            raise ValueError("make_lane_sampler needs n_lanes or lanes")
        lanes = torch.arange(n_lanes, dtype=torch.int64, device=device)
    lanes = _as_u32(lanes)
    h0, h1 = tea(lanes, torch.full_like(lanes, _as_u32(seed)), rounds=6)
    return LaneSampler(h=h0 ^ h1, dim=torch.zeros_like(h0))


def lane_next_1d(s: LaneSampler, consume: torch.Tensor = None
                 ) -> Tuple[torch.Tensor, LaneSampler]:
    """One uniform float per lane; advances the counters of consuming lanes
    only (``consume`` bool mask, default all)."""
    bits, _ = tea(s.h, s.dim, rounds=_DRAW_ROUNDS)
    inc = 1 if consume is None else consume.to(torch.int64)
    return _to_unit_float(bits), s._replace(dim=(s.dim + inc) & _M32)


def lane_fork(s: LaneSampler, salt) -> LaneSampler:
    """Decorrelated per-lane stream (the adjoint's alt stream)."""
    h0, h1 = tea(s.h, torch.full_like(s.h, _as_u32(salt)), rounds=6)
    return LaneSampler(h=h0 ^ h1, dim=torch.zeros_like(s.dim))
