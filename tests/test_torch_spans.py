"""The port's span recorder (``specenh_torch.utils.logging``): off by
default, nesting with parents, keys and thread ids, self time, the clock
of ``torch.profiler``'s events, the span trees of ``train.fit`` and
``EnhanceService.dispatch``, and the Chrome-trace export beside a
profiler trace; on the CPU."""

import glob
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from specenh_torch import ModelConfig, TrainConfig, train
from specenh_torch.config import Config, SpecParams
from specenh_torch.serve import EnhanceService
from specenh_torch.utils import logging as L
from specenh_torch.utils.logging import profile_trace, recording, span

TINY = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)))


def _tree(rec):
    """(name, key, parent's name) of each recorded span, in start order."""
    spans = rec.spans()
    return [(s.name, s.key, None if s.parent is None else spans[s.parent].name) for s in spans]


def test_recording_off_records_nothing():
    """Spans outside ``recording()`` are kept nowhere: the recorder is off
    before and after a recording, and a recording holds only its own."""
    assert L._RECORDER is None
    with span("before", key=1):
        pass
    with recording() as rec:
        with span("inside"):
            pass
    with span("after"):
        pass
    assert L._RECORDER is None
    assert [s.name for s in rec.spans()] == ["inside"]


def test_spans_nest_with_parents_keys_and_threads():
    """Parents by a per-thread stack, keys inherited from the parent unless
    given, each span's native thread id; an inner recording takes its own
    spans and the outer goes on after it."""
    def worker():
        with span("w.outer", key="shot"):
            with span("w.inner"):
                pass

    with recording() as rec:
        with span("a", key=7):
            with span("b"):
                with span("c", key=8):
                    pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with recording() as inner:
                with span("d"):
                    pass
        with span("e"):
            pass
    assert _tree(rec) == [("a", 7, None), ("b", 7, "a"), ("c", 8, "b"),
                          ("w.outer", "shot", None), ("w.inner", "shot", "w.outer"),
                          ("e", None, None)]
    assert _tree(inner) == [("d", None, None)]
    tids = {s.name: s.tid for s in rec.spans()}
    assert tids["a"] == tids["b"] == tids["c"] == tids["e"] == threading.get_native_id()
    assert tids["w.outer"] == tids["w.inner"] != tids["a"]
    for s in rec.spans():
        assert s.start_ns <= s.end_ns


def test_self_time(monkeypatch):
    """A span's self time is its duration less its children's; per name,
    the count and the totals."""
    clock = iter([0, 10, 30, 40, 70, 100, 200, 205])

    class FakeTime:
        time_ns = staticmethod(lambda: next(clock))
        perf_counter = staticmethod(lambda: 0.0)

    monkeypatch.setattr(L, "time", FakeTime)
    with recording() as rec:
        with span("p"):
            with span("c"):
                pass
            with span("c"):
                pass
        with span("p"):
            pass
    assert rec.stats() == {"p": {"count": 2, "total_s": pytest.approx(105e-9),
                                 "self_s": pytest.approx(55e-9)},
                           "c": {"count": 2, "total_s": pytest.approx(50e-9),
                                 "self_s": pytest.approx(50e-9)}}


def test_span_shares_the_profilers_clock():
    """A ``record_function`` event inside a program span starts and ends
    within the span's ``time.time_ns()`` stamps."""
    with recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with record_function("inner"):
                torch.ones(64, 64).sum()
    (outer,) = rec.spans()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert outer.start_ns <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= outer.end_ns


@pytest.mark.parametrize("engine", ["autograd", "kernel"])
def test_fit_records_its_span_tree(engine):
    """One ``fit``; a ``fit.epoch`` per epoch keyed by it, with its five
    parts; a ``train.step`` per batch keyed by the step count under
    ``fit.steps``, with ``step.loss`` and ``step.adam`` (and, on the
    kernel engine, ``step.weights``) under it."""
    cfg = TINY if engine == "autograd" else ModelConfig()
    tc = TrainConfig(batch_size=2, epochs=2)
    state = train.create_state(cfg, tc, device="cpu")
    x = torch.rand(3, 256, 128, generator=torch.Generator().manual_seed(0))
    y = 0.8 * x + 0.1
    epoch_fn = (None if engine == "autograd"
                else train.kernel_epoch_for(cfg, tc, dtype=torch.float32))
    with recording() as rec:
        train.fit(state, x, y, x[:2], y[:2], tc, epoch_fn=epoch_fn)
    tree = _tree(rec)
    parts = ["fit.batches", "fit.steps", "fit.loss_sync", "fit.validate", "fit.record"]
    assert [t for t in tree if t[2] == "fit"] == [("fit.epoch", 0, "fit"), ("fit.epoch", 1, "fit")]
    assert [(n, k) for n, k, p in tree if p == "fit.epoch"] == [(n, e) for e in (0, 1)
                                                                for n in parts]
    assert [(n, k) for n, k, p in tree if p == "fit.steps"] == [("train.step", s)
                                                                for s in range(4)]
    step_parts = (["step.weights"] if engine == "kernel" else []) + ["step.loss", "step.adam"]
    assert [(n, k) for n, k, p in tree if p == "train.step"] == [(n, s) for s in range(4)
                                                                 for n in step_parts]
    assert tree[0] == ("fit", None, None) and len(tree) == 1 + 2 * 6 + 4 * (1 + len(step_parts))
    stats = rec.stats()
    assert stats["train.step"]["count"] == 4 and stats["fit"]["count"] == 1


@pytest.mark.parametrize("engine", ["autograd", "kernel"])
def test_step_clears_stale_gradients(engine):
    """A step entered with ``.grad`` already set (a backward the caller
    ran, or a step that raised after its backward) updates the weights as
    a step entered clean does: the gradients are cleared before the
    forward, inside the ``train.step`` span, on both engines."""
    from specenh_torch.ops.ae_train_kernel import make_kernel_train_step

    cfg = TINY if engine == "autograd" else ModelConfig()
    tc = TrainConfig(batch_size=2)
    step = (train.train_step if engine == "autograd"
            else make_kernel_train_step(cfg, dtype=torch.float32))
    x = torch.rand(2, 256, 128, generator=torch.Generator().manual_seed(1))
    y, mask = 0.8 * x + 0.1, torch.ones(2)
    clean, stale = (train.create_state(cfg, tc, device="cpu") for _ in range(2))
    for p in stale.model.parameters():
        p.grad = torch.full_like(p, 1e3)
    with recording() as rec:
        clean, _ = step(clean, x, y, mask)
        stale, _ = step(stale, x, y, mask)
    assert [n for n, _, _ in _tree(rec)].count("train.step") == 2
    for a, b in zip(clean.model.parameters(), stale.model.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_dispatch_records_the_shot_spans():
    """``EnhanceService.dispatch`` records ``serve.dispatch`` keyed by the
    service's shot count, with ``shot.stft`` and ``shot.ae`` under it."""
    svc = EnhanceService(Config(spec=SpecParams(cut_shot=0.1)), TINY, n_channels=2,
                         device="cpu")
    traces = np.random.default_rng(0).standard_normal((2, svc.cfg.spec.n_samples))
    with recording() as rec:
        for _ in range(2):
            svc.dispatch(traces.astype(np.float32))
    assert _tree(rec) == [("serve.dispatch", 0, None), ("shot.stft", 0, "serve.dispatch"),
                          ("shot.ae", 0, "serve.dispatch"), ("serve.dispatch", 1, None),
                          ("shot.stft", 1, "serve.dispatch"), ("shot.ae", 1, "serve.dispatch")]


def test_profile_trace_writes_program_spans(tmp_path):
    """``profile_trace`` writes ``program_spans.json`` beside the trace: a
    Chrome complete event a span on the trace's timebase and thread rows,
    holding the operators run inside it."""
    with profile_trace(str(tmp_path)):
        with span("work", key=3):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (trace_path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(trace_path) as fh:
        trace = json.load(fh)
    with open(tmp_path / "program_spans.json") as fh:
        spans = json.load(fh)
    assert spans["baseTimeNanoseconds"] == trace.get("baseTimeNanoseconds", 0)
    (work,) = spans["traceEvents"]
    assert (work["ph"], work["name"], work["args"]) == ("X", "work", {"key": 3})
    (mm,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert (mm["pid"], mm["tid"]) == (work["pid"], work["tid"])
    assert work["ts"] <= mm["ts"] <= mm["ts"] + mm["dur"] <= work["ts"] + work["dur"]
