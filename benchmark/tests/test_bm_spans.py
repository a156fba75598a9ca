"""The program spans joined to a made-up trace (``core/spans.py``): the
gaps named by the innermost span or runtime call, by span name the idle,
the launches and the device time, the span metrics, and every existing
per-layer metric read the same with and without the spans; then
``span_run.measure`` rehearsed on the CPU on the port's own spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.core import spans as S
from benchmark.core.manifest import Bench
from benchmark.core.trace import summarize
from benchmark.tests.test_bm_trace import Ev, _prof
from benchmark.tests.tiny import ROOT, tiny_run

TID = 4242


class CEv(Ev):
    def __init__(self, name, start, dur, corr=0, **kw):
        super().__init__(name, start, dur, **kw)
        self._c = corr

    def correlation_id(self):
        return self._c


def _span(name, a, b, tid=TID):
    return SimpleNamespace(name=name, key=None, start_ns=a, end_ns=b, tid=tid)


# two steps under fit.steps, validation after them; the kernels' names are
# the port's, so every existing reader finds something
SPANS = [_span("fit.steps", 0, 590), _span("train.step", 0, 250), _span("step.loss", 0, 150),
         _span("step.adam", 150, 250), _span("train.step", 300, 550),
         _span("step.loss", 300, 450), _span("step.adam", 450, 550),
         _span("fit.validate", 595, 900), _span("serve.dispatch", 0, 900, tid=TID + 1)]
EVENTS = [
    CEv("cudaLaunchKernel", 10, 5, 1), CEv("wgrad_kernel<1>", 100, 100, 1, device=True),
    CEv("cudaLaunchKernel", 160, 5, 2), CEv("adam_kernel", 260, 40, 2, device=True),
    CEv("cudaLaunchKernel", 310, 5, 3), CEv("conv_igemm_kernel<3>", 320, 100, 3, device=True),
    CEv("cudaLaunchKernel", 460, 5, 4), CEv("adam_kernel", 470, 90, 4, device=True),
    CEv("cudaMemcpyAsync", 620, 5, 5), CEv("Memcpy HtoD", 640, 60, 5, device=True),
    CEv("cudaLaunchKernel", 700, 5, 6), CEv("stft_logpsd_kernel", 720, 180, 6, device=True),
    CEv("cudaLaunchKernel", 930, 5, 7), CEv("wgrad_kernel<1>", 950, 50, 7, device=True),
]


def test_gaps_named_by_program_spans():
    """Gaps 200-260 (mid 230: step.adam, its launch ended), 300-320 (a
    launch call holds 310), 420-470 (step.loss), 560-640 (mid 600:
    fit.validate), 700-720 (fit.validate), 900-950 (no span)."""
    s = S.join(_prof(EVENTS), 1e-6, SPANS, TID)
    assert s.gaps == {"step.adam": pytest.approx(60e-9), "cudaLaunchKernel": pytest.approx(20e-9),
                      "step.loss": pytest.approx(50e-9), "fit.validate": pytest.approx(100e-9),
                      "host: not recorded": pytest.approx(50e-9)}
    assert s.idle_total_s() == pytest.approx(280e-9)
    assert s.busy_s == pytest.approx(620e-9)
    # without spans the same gaps carry the trace's own names
    assert summarize(_prof(EVENTS), 1e-6).gaps == {
        "cudaLaunchKernel": pytest.approx(20e-9), "host: not recorded": pytest.approx(260e-9)}


def test_idle_launches_and_device_time_by_span():
    """Idle overlapping each name's spans; launches inside them, nested
    spans included, copies not; device time charged to the innermost span
    holding the launch, by correlation id; the other thread's span left
    out."""
    s = S.join(_prof(EVENTS), 1e-6, SPANS, TID)
    assert s.idle_s["fit.steps"] == pytest.approx(160e-9)      # 60 + 20 + 50 + 30
    assert s.idle_s["fit.validate"] == pytest.approx(65e-9)    # 595-640, 700-720
    assert s.launches == {"fit.steps": 4, "train.step": 4, "step.loss": 2, "step.adam": 2,
                          "fit.validate": 1}
    assert s.device_s == {"step.loss": pytest.approx(200e-9), "step.adam": pytest.approx(130e-9),
                          "fit.validate": pytest.approx(240e-9)}
    assert s.durations["train.step"] == [pytest.approx(250e-9)] * 2
    assert "serve.dispatch" not in s.durations


def test_span_metrics():
    s = S.join(_prof(EVENTS), 1e-6, SPANS, TID)
    got = S.metrics(s, 1e-6)
    assert got == {"step_host_ms.train": pytest.approx(250e-6),
                   "validate_ms.train": pytest.approx(305e-6),
                   "launches_per_step.train": 2.0,
                   "adam_share.train": pytest.approx(100 * 130 / 620),
                   "idle_steps.train": pytest.approx(16.0),
                   "idle_outside_steps.train": pytest.approx(12.0)}
    assert got["idle_steps.train"] + got["idle_outside_steps.train"] == pytest.approx(
        100 * s.idle_total_s() / 1e-6)
    serve = S.join(_prof(EVENTS), 1e-6, SPANS, TID + 1)
    assert S.metrics(serve, 1e-6) == {"dispatch_span_ms.serve": pytest.approx(900e-6)}
    assert S.metrics(S.join(_prof(EVENTS), 1e-6, [], TID), 1e-6) == {}


@pytest.mark.parametrize("cell", ["flagship-serve", "deep3-train", "flagship-train",
                                  "deep3-serve"])
def test_existing_readers_read_the_same_with_spans(cell):
    """Every per-layer metric of the cell reads the same value from the
    trace alone and from the trace with the spans joined."""
    bench = Bench(ROOT)
    run = tiny_run(cell, bench=bench)
    run.window_s, run.window_peak_bytes = 1e-6, 3 << 30
    run.counters = {"epochs": 2, "train_tiles": 10, "val_tiles": 4, "steps": 6, "batch": 2,
                    "shots": 3, "channels": 2}
    run.spans = {"dispatch": [1e-3, 2e-3], "epoch": [0.1, 0.2]}
    got = {}
    for summary in (summarize(_prof(EVENTS), 1e-6), S.join(_prof(EVENTS), 1e-6, SPANS, TID)):
        run.summary = summary
        for m in bench.per_layer_for(cell):
            got.setdefault(m["name"], []).append(bench.reader(m["name"])(run))
    assert all(v[0] is not None for v in got.values())
    assert {k: v[0] for k, v in got.items()} == {k: v[1] for k, v in got.items()}


@pytest.mark.parametrize("cell", ["flagship-train", "flagship-serve"])
def test_span_run_measures_the_ports_spans(cell):
    """``span_run.measure`` on a CPU-sized cell: the window's end-to-end
    values and the port's spans (no device trace on the CPU: nothing is
    joined)."""
    from benchmark.span_run import measure

    line = measure(tiny_run(cell, seconds=0.2, trace=True))
    assert line["e2e"] and line["spans"] > 0 and "span_metrics" in line
    top = "fit" if cell.endswith("train") else "serve.dispatch"
    assert line["span_stats"][top][0] >= 1
    assert line["span_metrics"] == {} and line["existing"]
