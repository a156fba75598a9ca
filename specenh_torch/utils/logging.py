"""Observability: JSONL metrics logger, span timers, profiler traces (the
counterpart of ``specenh.utils.logging``).

* ``MetricsLogger``: an append-only JSONL event stream (the
  ``metrics.jsonl`` files of train, serve and sweep); with ``SpanTimer``, a
  copy of the JAX package's, held equal by ``tests/test_torch_guard.py``;
* ``span`` / ``SpanTimer``: wall-clock spans; ``span(sync=True)`` waits for
  the card (``torch.cuda.synchronize``) when the spanned result holds a
  CUDA tensor, so the clock stops after the work, not after its launch;
* ``profile_trace``: ``torch.profiler`` around a block, its trace written
  into ``log_dir`` (TensorBoard / Perfetto);
* ``nan_guard``: autograd's anomaly mode with its NaN check.  It checks
  the backward pass only, where JAX's ``jax_debug_nans`` checks the output
  of every operation.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Iterator, Optional

__all__ = ["MetricsLogger", "SpanTimer", "span", "profile_trace", "nan_guard"]


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


class SpanTimer:
    """Named wall-clock spans; ``report()`` returns {name: total_seconds}."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            n: {"total_s": self.totals[n], "count": self.counts[n],
                "mean_s": self.totals[n] / self.counts[n]}
            for n in self.totals
        }


class _SpanHandle:
    """Set ``.result`` to the spanned computation's output so the sync
    fence has something to wait on."""

    result = None


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


@contextlib.contextmanager
def span(name: str, logger: Optional[MetricsLogger] = None, sync: bool = False):
    """One-off timed span; logs a ``span`` event if a logger is given.

    ``sync=True`` fences on the spanned OUTPUT: assign it inside the block
    (``with span("x", sync=True) as sp: sp.result = f(...)``) and the clock
    stops after ``torch.cuda.synchronize`` of each CUDA device its tensors
    are on (a CPU result is ready when the block ends).  With no result
    assigned, sync waits for the current CUDA device if CUDA is in use."""
    sp = _SpanHandle()
    t0 = time.perf_counter()
    yield sp
    if sync:
        import torch

        if sp.result is not None:
            for dev in _cuda_devices(sp.result, set()):
                torch.cuda.synchronize(dev)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log("span", name=name, seconds=dt)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace of the block (host and, with a card, CUDA
    activity), written into ``log_dir`` as ``*.pt.trace.json`` (TensorBoard,
    Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


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
