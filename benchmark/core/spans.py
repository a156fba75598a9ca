"""The port's program spans joined to one profiled window: the idle gaps
named by what the program was doing, and by span name the device idle
that overlaps the spans, the kernel launches made inside them and the
device time of what those launches ran.

The port stamps its spans with ``time.time_ns()``
(``specenh_torch.utils.logging.recording``), the clock of the profiler's
host events, onto which the profiler maps the device's timestamps; a
kernel is tied to the runtime call that launched it by the two events'
correlation id.  Nothing here changes what ``core/trace.py`` reads from
the same trace: ``join`` starts from its ``summarize``, and only the
names of the idle gaps differ.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.core.trace import (WINDOW_SPAN, TraceSummary, _annotation, _name_gaps, _union,
                                  summarize)

# the CUDA calls that launch a kernel (the runtime API's and the lower-level cu* API's)
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaLaunchCooperativeKernel)")


@dataclass
class SpanSummary(TraceSummary):
    """``TraceSummary`` with the gaps named by program spans too, and by
    span name: ``idle_s`` (device idle overlapping the name's spans),
    ``launches`` (launch calls starting inside them, nested spans
    included), ``device_s`` (device time of what was launched where the
    name's span was the innermost) and ``durations`` (each closed span's
    seconds, in order)."""

    idle_s: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)
    device_s: Dict[str, float] = field(default_factory=dict)
    durations: Dict[str, List[float]] = field(default_factory=dict)

    def idle_total_s(self) -> float:
        return sum(self.gaps.values())

    def mean_ms(self, name: str) -> Optional[float]:
        d = self.durations.get(name)
        return 1e3 * sum(d) / len(d) if d else None


def join(prof, window_s: float, spans: Sequence, tid: int) -> Optional[SpanSummary]:
    """``summarize(prof, window_s)`` with the closed ``spans`` of the
    thread ``tid`` joined to it; None where the profiler recorded no
    device activity."""
    from torch.autograd import DeviceType

    base = summarize(prof, window_s)
    if base is None:
        return None
    mine = [s for s in spans if s.tid == tid and s.end_ns is not None]
    events = prof.profiler.kineto_results.events()
    dev: List[Tuple[int, int, int]] = []            # start, end, correlation id
    calls: List[Tuple[int, int, str, int]] = []     # start, end, name, correlation id
    call_tids: List[int] = []
    win: Optional[Tuple[int, int, int]] = None
    annotations = set()
    for e in events:
        if e.device_type() != DeviceType.CUDA and _annotation(e):
            annotations.add(e.name())
    for e in events:
        a, d, name = e.start_ns(), e.duration_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if d > 0 and name not in annotations and not _annotation(e):
                dev.append((a, a + d, e.correlation_id()))
        elif name == WINDOW_SPAN:
            win = (a, a + d, e.start_thread_id())
        else:
            calls.append((a, a + d, name, e.correlation_id()))
            call_tids.append(e.start_thread_id())
    if win is not None:
        lo, hi, window_tid = win
        dev = [(max(a, lo), min(b, hi), c) for a, b, c in dev if b > lo and a < hi]
        calls = [c for c, t in zip(calls, call_tids) if t == window_tid]
    else:
        lo, hi = min(a for a, _, _ in dev), max(b for _, b, _ in dev)
    _, gaps = _union([(a, b) for a, b, _ in dev], lo, hi)
    host = [(a, b, n) for a, b, n, _ in calls] + [(s.start_ns, s.end_ns, s.name) for s in mine]
    out = SpanSummary(busy_s=base.busy_s, window_s=base.window_s, kernels=base.kernels,
                      gaps=_name_gaps(gaps, host), device_events=base.device_events,
                      host_events=base.host_events + len(mine))
    _by_name(out, mine, gaps, calls, dev)
    return out


def _by_name(out: SpanSummary, spans: Sequence, gaps: List[Tuple[int, int]],
             calls: List[Tuple[int, int, str, int]], dev: List[Tuple[int, int, int]]) -> None:
    """Fill ``out``'s per-name fields from one thread's closed spans (which
    nest), the idle gaps, the runtime calls and the device events."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start_ns, -spans[i].end_ns))
    by_name: Dict[str, List[Tuple[int, int]]] = {}
    for i in order:
        s = spans[i]
        out.durations.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e9)
        by_name.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    for name, iv in by_name.items():
        out.idle_s[name] = _overlap(_merged(iv), gaps) / 1e9
    # each runtime call's enclosing spans: a sweep over spans and calls by start
    launched_at = {}
    items = sorted([(spans[i].start_ns, 0, i) for i in order]
                   + [(a, 1, k) for k, (a, _, _, _) in enumerate(calls)])
    stack: List[int] = []
    for t, kind, i in items:
        while stack and spans[stack[-1]].end_ns <= t:
            stack.pop()
        if kind == 0:
            stack.append(i)
            continue
        _, _, name, corr = calls[i]
        if stack:
            launched_at[corr] = spans[stack[-1]].name
        if LAUNCH.match(name):
            for n in {spans[j].name for j in stack}:
                out.launches[n] = out.launches.get(n, 0) + 1
    for a, b, corr in dev:
        n = launched_at.get(corr)
        if n is not None:
            out.device_s[n] = out.device_s.get(n, 0.0) + (b - a) / 1e9


def _merged(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(iv: List[Tuple[int, int]], gaps: List[Tuple[int, int]]) -> int:
    """Nanoseconds of the disjoint sorted intervals ``iv`` inside the
    disjoint sorted ``gaps``."""
    starts = [g[0] for g in gaps]
    total = 0
    for a, b in iv:
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(gaps) and gaps[k][0] < b:
            total += max(0, min(b, gaps[k][1]) - max(a, gaps[k][0]))
            k += 1
    return total


def metrics(s: Optional[SpanSummary], window_s: float) -> Dict[str, float]:
    """The per-layer numbers the spans give, by metric name; a number whose
    spans the window did not record is left out."""
    if s is None or not window_s:
        return {}
    out: Dict[str, Optional[float]] = {
        "step_host_ms.train": s.mean_ms("train.step"),
        "validate_ms.train": s.mean_ms("fit.validate"),
        "dispatch_span_ms.serve": s.mean_ms("serve.dispatch"),
    }
    steps = s.durations.get("train.step")
    if steps:
        out["launches_per_step.train"] = s.launches.get("train.step", 0) / len(steps)
        out["adam_share.train"] = 100.0 * s.device_s.get("step.adam", 0.0) / s.busy_s
    if "fit.steps" in s.durations:
        inside = s.idle_s["fit.steps"]
        out["idle_steps.train"] = 100.0 * inside / window_s
        out["idle_outside_steps.train"] = 100.0 * (s.idle_total_s() - inside) / window_s
    return {k: v for k, v in out.items() if v is not None}
