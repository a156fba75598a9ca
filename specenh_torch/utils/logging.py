"""Observability: JSONL metrics logger, spans and their recorder, profiler
traces (the counterpart of ``specenh.utils.logging``).

* ``MetricsLogger``: an append-only JSONL event stream (the
  ``metrics.jsonl`` files of train, serve and sweep), a copy of the JAX
  package's, held equal by ``tests/test_torch_guard.py``;
* ``span``: a wall-clock span; ``span(sync=True)`` waits for the card
  (``torch.cuda.synchronize``) when the spanned result holds a CUDA
  tensor, so the clock stops after the work, not after its launch;
* ``recording``: turns the process-wide span recorder on for a block and
  gives back what it recorded (``SpanRecorder``): each span's name, key,
  start and end on ``time.time_ns()`` (the clock of ``torch.profiler``'s
  events), parent and native thread id, and per name the count, total
  and self time.  Off, a span costs one test of a module-level flag;
* ``profile_trace``: ``torch.profiler`` around a block, its trace written
  into ``log_dir`` (TensorBoard / Perfetto), and the block's spans beside
  it as ``program_spans.json`` on the trace's timebase;
* ``nan_guard``: autograd's anomaly mode with its NaN check.  It checks
  the backward pass only, where JAX's ``jax_debug_nans`` checks the output
  of every operation.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

__all__ = ["MetricsLogger", "span", "recording", "SpanRecorder", "SpanRecord",
           "profile_trace", "nan_guard"]


class MetricsLogger:
    """Append-only JSONL metrics: one event per line, flushed immediately
    (crash-safe, greppable, pandas-loadable)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def log(self, event: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"event": event, "time": time.time()}
        rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of the tensors in ``obj`` (nested tuples, lists and
    dicts)."""
    import torch

    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


class SpanRecord(NamedTuple):
    """One recorded span: ``start_ns`` and ``end_ns`` on ``time.time_ns()``
    (``end_ns`` None while it is open), ``parent`` the index of the
    enclosing span on its thread (None at the top), ``tid`` the native
    thread id."""

    name: str
    key: Any
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    tid: int


class _Thread(threading.local):
    """A thread's innermost open span and its native id."""

    top: Optional[list] = None

    def __init__(self):
        self.tid = threading.get_native_id()


class SpanRecorder:
    """The spans recorded while ``recording()`` was on, kept in memory in
    the order they started: ``spans()`` lists them, ``stats()`` sums them
    by name."""

    def __init__(self):
        # each span a list [name, key, start_ns, end_ns, enclosing span, tid]
        self._recs: List[list] = []
        self._thread = _Thread()

    def _enter(self, name: str, key) -> list:
        th = self._thread
        up = th.top
        if key is None and up is not None:
            key = up[1]
        rec = [name, key, time.time_ns(), None, up, th.tid]
        th.top = rec
        self._recs.append(rec)
        return rec

    def _exit(self, rec: list) -> None:
        rec[3] = time.time_ns()
        self._thread.top = rec[4]

    def spans(self) -> List[SpanRecord]:
        recs = list(self._recs)
        index = {id(r): i for i, r in enumerate(recs)}
        return [SpanRecord(r[0], r[1], r[2], r[3], None if r[4] is None else index.get(id(r[4])),
                           r[5]) for r in recs]

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per name, the closed spans' ``count``, ``total_s`` and ``self_s``
        (each span's duration less the time its child spans cover; the
        children of a span run on its thread and nest, so they do not
        overlap)."""
        spans = self.spans()
        child = [0] * len(spans)
        for s in spans:
            if s.end_ns is not None and s.parent is not None:
                child[s.parent] += s.end_ns - s.start_ns
        out: Dict[str, Dict[str, float]] = {}
        for s, c in zip(spans, child):
            if s.end_ns is None:
                continue
            d = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            d["count"] += 1
            d["total_s"] += (s.end_ns - s.start_ns) / 1e9
            d["self_s"] += (s.end_ns - s.start_ns - c) / 1e9
        return out


# the recorder ``recording()`` turned on, None while none is: a span tests it
_RECORDER: Optional[SpanRecorder] = None


@contextlib.contextmanager
def recording() -> Iterator[SpanRecorder]:
    """Record every span that starts in the process, on any thread, while
    the block runs; yields the recorder, which keeps what it recorded
    after the block.  A recording inside another takes the spans that
    start within it, and the outer one goes on after it."""
    global _RECORDER
    prev, rec = _RECORDER, SpanRecorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = prev


class _Span:
    """``span``'s context manager; ``.result`` is what the sync fence waits
    on."""

    __slots__ = ("name", "logger", "sync", "key", "result", "_t0", "_rec", "_open")

    def __init__(self, name, logger, sync, key):
        self.name, self.logger, self.sync, self.key = name, logger, sync, key
        self.result = None

    def __enter__(self):
        self._rec = rec = _RECORDER
        if rec is not None:
            self._open = rec._enter(self.name, self.key)
        if self.logger is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            if self.sync:
                import torch

                if self.result is not None:
                    for dev in _cuda_devices(self.result, set()):
                        torch.cuda.synchronize(dev)
                elif torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            if self.logger is not None:
                self.logger.log("span", name=self.name,
                                seconds=time.perf_counter() - self._t0)
        if self._rec is not None:
            self._rec._exit(self._open)
        return False


def span(name: str, logger: Optional[MetricsLogger] = None, sync: bool = False,
         key: Any = None) -> _Span:
    """One-off timed span; logs a ``span`` event if a logger is given, and
    is recorded while ``recording()`` is on.

    ``sync=True`` fences on the spanned OUTPUT: assign it inside the block
    (``with span("x", sync=True) as sp: sp.result = f(...)``) and the clock
    stops after ``torch.cuda.synchronize`` of each CUDA device its tensors
    are on (a CPU result is ready when the block ends).  With no result
    assigned, sync waits for the current CUDA device if CUDA is in use.
    ``key`` names the shot or step the span belongs to; a span given none
    takes its parent's."""
    return _Span(name, logger, sync, key)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace of the block (host and, with a card, CUDA
    activity), written into ``log_dir`` as ``*.pt.trace.json`` (TensorBoard,
    Perfetto or chrome://tracing), and the block's spans, recorded as
    ``recording()`` records them, beside it as ``program_spans.json``: a
    complete ("X") event a span, on the trace's timebase (microseconds from
    its ``baseTimeNanoseconds``) and on the process and thread rows of its
    host events, so the two files' ``traceEvents`` joined show the spans
    over the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(log_dir)
    written: List[str] = []

    def on_ready(prof) -> None:
        pattern = os.path.join(log_dir, "*.pt.trace.json")
        before = set(glob.glob(pattern))
        handler(prof)
        written.extend(sorted(set(glob.glob(pattern)) - before))

    with recording() as rec:
        with profile(activities=activities, on_trace_ready=on_ready):
            yield
    base = _trace_base_ns(written[-1]) if written else 0
    _write_chrome_spans(rec, os.path.join(log_dir, "program_spans.json"), base)


def _trace_base_ns(trace_path: str) -> int:
    """The ``baseTimeNanoseconds`` of a kineto trace, which it writes ahead
    of its events (0 where it has none: its times are then absolute)."""
    with open(trace_path) as fh:
        m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', fh.read(1 << 16))
    return int(m.group(1)) if m else 0


def _write_chrome_spans(rec: SpanRecorder, path: str, base_ns: int) -> None:
    """The recorder's closed spans as a Chrome trace at ``path``, in
    microseconds from ``base_ns`` on ``time.time_ns()``'s clock."""
    pid = os.getpid()
    events = [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.tid,
               "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"key": s.key}}
              for s in rec.spans() if s.end_ns is not None]
    with open(path, "w") as fh:
        json.dump({"baseTimeNanoseconds": base_ns, "displayTimeUnit": "ms",
                   "traceEvents": events}, fh, default=str)


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Temporarily turn on autograd's anomaly mode with its NaN check: a
    backward function that returns a NaN raises, with the traceback of the
    forward operation that made it.  Unlike ``jax_debug_nans`` it does not
    check forward outputs."""
    import torch

    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)
