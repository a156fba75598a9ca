"""The profiler walk on a made-up trace: the union of device intervals,
the host span's copy on the device left out, kernel time by name, and each
idle gap named by the innermost host event on the window's thread."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark.core.trace import summarize


class Ev:
    def __init__(self, name, start, dur, device=False, tid=1, annotation=False):
        self._n, self._s, self._d, self._dev, self._t, self._a = (name, start, dur, device, tid,
                                                                  annotation)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_busy_kernels_and_named_gaps():
    events = [
        Ev("benchmark.window", 0, 1000, annotation=True),
        Ev("benchmark.window", 0, 1000, device=True),          # its device-side copy
        Ev("benchmark.dispatch", 0, 300, annotation=True),
        Ev("aten::empty", 100, 50),
        Ev("cudaEventSynchronize", 400, 500),
        Ev("aten::add", 950, 40, tid=2),                       # another thread
        Ev("k_a", 120, 180, device=True),                      # 120-300
        Ev("k_b", 250, 150, device=True),                      # 250-400, overlaps
        Ev("k_a", 500, 300, device=True),                      # 500-800
    ]
    s = summarize(_prof(events), window_s=1e-6)
    assert s.busy_s == pytest.approx(580e-9)                  # 120-400, 500-800
    assert s.kernels == {"k_a": pytest.approx(480e-9), "k_b": pytest.approx(150e-9)}
    # gaps 0-120 (mid 60: the dispatch span), 400-500 (mid 450: the
    # synchronize), 800-1000 (mid 900: the synchronize ends at 900)
    assert s.gaps == {"benchmark.dispatch": pytest.approx(120e-9),
                      "cudaEventSynchronize": pytest.approx(300e-9)}
    assert s.breakdown()["device_ops"][0] == ["k_a", pytest.approx(480e-9)]


def test_no_device_events_reads_nothing():
    assert summarize(_prof([Ev("aten::add", 0, 10)]), window_s=1.0) is None
