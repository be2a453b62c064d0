"""Profiling helpers: per-phase timers and throughput meters that wait for
the device, a ``torch.profiler`` trace, and what a trace says of the
device's time.

Port of ``uivr_tpu/utils/profiling.py``: ``PhaseTimer`` and
``ThroughputMeter`` synchronize on a CUDA tensor where ``sync_on`` is one
(``jax.block_until_ready`` there); :func:`trace` takes the place of
``xla_trace``.  :func:`device_summary` reads a trace's device timeline: the
busy and idle shares of the window from the first device event to the
last, the kernels by device time, the longest idle gaps (where the device
waits for the host) and the device-to-host copies and host syncs.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# host calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def _sync(t) -> None:
    """Wait for the device work that produces ``t`` (any tensor, or a
    nest of them in a list/tuple/dict); nothing for CPU tensors."""
    if isinstance(t, torch.Tensor):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
    elif isinstance(t, dict):
        for v in t.values():
            _sync(v)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _sync(v)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, cuda: Optional[bool] = None):
    """Profile a code block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present or ``cuda`` asks for it); yields the
    profiler.  With ``log_dir``, writes ``trace.json`` (Chrome trace
    format) there."""
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    if log_dir:
        import os
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timeline(events: Iterable[Tuple[float, float, str]], n_gaps: int = 5) -> Dict:
    """The busy and idle time of one device timeline: ``events`` are
    (start_us, end_us, name) of device work.  The window runs from the
    first start to the last end; overlapping events count once.  Returns
    window_ms, busy_ms, idle_share (None without events) and the
    ``n_gaps`` longest gaps with the names of the events on either side."""
    ev = sorted(events)
    if not ev:
        return {"window_ms": 0.0, "busy_ms": 0.0, "idle_share": None, "gaps": []}
    busy, gaps = 0.0, []
    cur_s, cur_e, cur_name = ev[0]
    for s, e, name in ev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_name, name))
            cur_s, cur_e, cur_name = s, e, name
        elif e > cur_e:
            cur_e, cur_name = e, name
    busy += cur_e - cur_s
    window = max(e for _, e, _ in ev) - ev[0][0]
    gaps.sort(key=lambda g: -g[0])
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window > 0 else 0.0,
            "gaps": [{"ms": g / 1e3, "after": a, "before": b} for g, a, b in gaps[:n_gaps]]}


def _is_device(evt) -> bool:
    """A device event (kernel, copy, set), not a user range's projection
    onto the device timeline."""
    dt = getattr(evt, "device_type", None)
    return (dt is not None and str(dt).split(".")[-1] in ("CUDA", "PrivateUse1")
            and not getattr(evt, "is_user_annotation", False))


def host_ranges(prof, name: str) -> List[Tuple[float, float]]:
    """(start_us, end_us) of the host events called ``name`` in the trace
    ``prof`` (for example ``torch.profiler.record_function`` ranges), in
    order."""
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name == name and not _is_device(e))


def device_summary(prof, top: int = 10, n_gaps: int = 5,
                   window: Optional[Tuple[float, float]] = None) -> Dict:
    """What the trace ``prof`` (a finished :func:`trace`) says of the
    device: its timeline (:func:`timeline`), the ``top`` kernels by total
    device time (ms, launches), the device-to-host copies and the host
    calls that wait for the device (:data:`SYNC_CALLS`).  ``window``
    (start_us, end_us): only the events that start in it.
    ``device_events`` 0 means the trace holds no device time."""
    lo, hi = window or (float("-inf"), float("inf"))
    dev: List[Tuple[float, float, str]] = []
    by_name: Dict[str, List[float]] = {}
    dtoh = 0
    for evt in prof.events():
        tr = evt.time_range
        if not (_is_device(evt) and lo <= tr.start <= hi):
            continue
        dev.append((tr.start, tr.end, evt.name))
        acc = by_name.setdefault(evt.name, [0.0, 0])
        acc[0] += (tr.end - tr.start) / 1e3
        acc[1] += 1
        dtoh += "DtoH" in evt.name
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_events": len(dev), **timeline(dev, n_gaps),
            "top_kernels": [{"name": k, "ms": v[0], "count": v[1]} for k, v in kernels],
            "memcpy_dtoh": dtoh, "syncs": syncs_between(prof, lo, hi)}


def syncs_between(prof, lo: float, hi: float) -> Dict[str, int]:
    """Host calls that wait for the device (:data:`SYNC_CALLS`), by name,
    that start between ``lo`` and ``hi`` (us, the trace's clock)."""
    out: Dict[str, int] = {}
    for e in prof.events():
        if (not _is_device(e) and e.name.startswith(SYNC_CALLS)
                and lo <= e.time_range.start <= hi):
            out[e.name] = out.get(e.name, 0) + 1
    return out


class PhaseTimer:
    """Accumulates per-phase wall time, waiting for the device work that
    produces ``sync_on`` at the end of each phase."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _sync(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3),
                    "count": self.counts[k]}
                for k, v in self.totals.items()}

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


class ThroughputMeter:
    """rays/s (or any unit/s) over a timed window, waiting for the device."""

    def __init__(self):
        self.units = 0
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()
        self.units = 0

    def add(self, n: int):
        self.units += n

    def rate(self, sync_on=None) -> float:
        if sync_on is not None:
            _sync(sync_on)
        dt = time.perf_counter() - self.t0
        return self.units / max(dt, 1e-9)
