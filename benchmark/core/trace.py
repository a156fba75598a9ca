"""The one profiler walk of the benchmark: from a ``torch.profiler`` run
over the window, the card's busy time (the union of its kernels', copies'
and sets' intervals), device time by kernel name, the idle gaps named by
what the host was doing, and the ``breakdown`` of the result line.

It follows the port's ``chip_smoke.device_busy`` (the union of the device
events' intervals) and ``profile_split`` (device time by name), reading
the profiler's raw events (``kineto_results``) in one pass, which holds
for windows of a million events where building ``prof.events()`` would
not.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

WINDOW_SPAN = "benchmark.window"


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernels: Dict[str, float]          # device seconds by name
    gaps: Dict[str, float]             # idle seconds by what the host was doing
    device_events: int = 0
    host_events: int = 0

    def seconds(self, pattern: str) -> Optional[float]:
        """Device seconds of the kernels whose names match ``pattern``
        (a regular expression); None where none ran."""
        rx = re.compile(pattern)
        hits = [s for name, s in self.kernels.items() if rx.search(name)]
        return sum(hits) if hits else None

    def breakdown(self, top: int = 10) -> Dict[str, List[Tuple[str, float]]]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(k), v] for k, v in ops],
                "idle_gaps": [[_short(k), v] for k, v in gaps]}


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


@contextlib.contextmanager
def traced(on: bool, host_ops: bool = True) -> Iterator[Optional[object]]:
    """The window under torch.profiler when ``on``: the device's activity,
    and the host's operators unless ``host_ops`` is false (recording each
    of them costs the host time)."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host_ops or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def summarize(prof, window_s: float) -> Optional[TraceSummary]:
    """The walk over one profiled window; None where the profiler recorded
    no device activity."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    on_device = [e.device_type() == DeviceType.CUDA for e in events]
    # a host span (record_function) has a copy on the device's timeline,
    # under the same name, that is no device work
    spans = {e.name() for e, d in zip(events, on_device) if not d and _annotation(e)}
    dev: List[Tuple[int, int]] = []
    kernels: Dict[str, float] = {}
    host: List[Tuple[int, int, str, int]] = []
    win: Optional[Tuple[int, int, int]] = None
    for e, d_ in zip(events, on_device):
        a, d, name = e.start_ns(), e.duration_ns(), e.name()
        if d_:
            if d > 0 and name not in spans and not _annotation(e):
                dev.append((a, a + d))
                kernels[name] = kernels.get(name, 0.0) + d / 1e9
        else:
            if name == WINDOW_SPAN:
                win = (a, a + d, e.start_thread_id())
            host.append((a, a + d, name, e.start_thread_id()))
    if not dev:
        return None
    if win is not None:
        lo, hi, tid = win
        dev = [(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi]
        host = [(a, b, n) for a, b, n, t in host if t == tid and n != WINDOW_SPAN]
    else:
        lo, hi = min(a for a, _ in dev), max(b for _, b in dev)
        host = [(a, b, n) for a, b, n, _ in host]
    busy, gaps = _union(dev, lo, hi)
    return TraceSummary(busy_s=busy / 1e9, window_s=window_s, kernels=kernels,
                        gaps=_name_gaps(gaps, host), device_events=len(dev),
                        host_events=len(host))


def _annotation(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "annotation" in kind()
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _union(spans: List[Tuple[int, int]], lo: int, hi: int):
    """Busy nanoseconds of the union of ``spans`` and the idle gaps
    between ``lo`` and ``hi``."""
    busy, end, gaps = 0, lo, []
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def _name_gaps(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]
               ) -> Dict[str, float]:
    """Each gap's length summed under the innermost host event on the
    window's thread that holds the gap's midpoint ('host: not recorded'
    where none does: Python, or operators when they are not recorded).  Events on one thread nest, so a stack sweep finds it."""
    out: Dict[str, float] = {}
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            h = host[i]
            while stack and stack[-1][1] <= h[0]:
                stack.pop()
            stack.append(h)
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host: not recorded"
        out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return out
