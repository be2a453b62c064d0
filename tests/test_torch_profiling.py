"""The port's profiling helpers (``uivr_tpu_torch/utils/profiling.py``), on
the CPU: the timers and the meter with a CPU tensor to wait on, and the
device timeline's busy and idle shares, gaps, kernels and host syncs on
made-up events (``chip_smoke.py`` traces a training step on the card)."""
import time
from types import SimpleNamespace

import pytest
import torch

from uivr_tpu_torch.utils import profiling


def test_phase_timer_and_meter():
    t = profiling.PhaseTimer()
    x = torch.ones(8)
    for _ in range(2):
        with t.phase("a", sync_on=x):
            time.sleep(0.01)
    with t.phase("b", sync_on={"k": [x]}):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0.02
    assert 10.0 <= s["a"]["mean_ms"] < 1000.0 and s["b"]["count"] == 1
    m = profiling.ThroughputMeter()
    m.start()
    m.add(1000)
    time.sleep(0.01)
    assert 0 < m.rate(sync_on=x) <= 1000 / 0.01


def test_timeline_busy_idle_and_gaps():
    # 0-10 and 5-20 overlap (busy 20), gap 10, 30-40, gap 60, 100-110
    ev = [(30.0, 40.0, "b"), (0.0, 10.0, "a"), (5.0, 20.0, "a2"), (100.0, 110.0, "c")]
    tl = profiling.timeline(ev, n_gaps=1)
    assert tl["window_ms"] == pytest.approx(0.110)
    assert tl["busy_ms"] == pytest.approx(0.040)
    assert tl["idle_share"] == pytest.approx(70.0 / 110.0)
    assert tl["gaps"] == [{"ms": pytest.approx(0.060), "after": "b", "before": "c"}]
    assert profiling.timeline([])["idle_share"] is None


class _Evt:
    """A trace event as ``torch.profiler`` gives it."""

    def __init__(self, name, start, end, device=False, annotation=False):
        self.name, self.device_type = name, "DeviceType.CUDA" if device else "DeviceType.CPU"
        self.time_range = SimpleNamespace(start=start, end=end)
        self.is_user_annotation = annotation


def test_device_summary_of_a_trace():
    """Kernels and copies count as device time, a range's projection onto
    the device does not; syncs and ranges come from the host events."""
    ev = [_Evt("step", 0.0, 200.0), _Evt("step", 0.0, 200.0, device=True, annotation=True),
          _Evt("k", 10.0, 50.0, device=True), _Evt("k", 60.0, 100.0, device=True),
          _Evt("Memcpy DtoH (Device -> Pageable)", 100.0, 110.0, device=True),
          _Evt("launch", 5.0, 6.0), _Evt("launch", 55.0, 56.0),
          _Evt("cudaStreamSynchronize", 20.0, 40.0), _Evt("cudaStreamSynchronize", 150.0, 151.0)]
    prof = SimpleNamespace(events=lambda: ev)
    s = profiling.device_summary(prof, window=profiling.host_ranges(prof, "step")[0])
    assert s["device_events"] == 3 and s["memcpy_dtoh"] == 1
    assert s["window_ms"] == pytest.approx(0.100) and s["busy_ms"] == pytest.approx(0.090)
    assert s["top_kernels"][0] == {"name": "k", "ms": pytest.approx(0.080), "count": 2}
    assert s["gaps"] == [{"ms": pytest.approx(0.010), "after": "k", "before": "k"}]
    assert s["syncs"] == {"cudaStreamSynchronize": 2}
    lo, hi = (r[0] for r in profiling.host_ranges(prof, "launch"))
    assert profiling.syncs_between(prof, lo, hi) == {"cudaStreamSynchronize": 1}
