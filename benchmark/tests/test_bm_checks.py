"""What decides ``correct``, at a small size on the CPU: a sound run comes
out correct; the control (the reference one precision below the
configuration's, in the program's place) and every fault that a cell's
kind can have, planted under the timed path with the harness's look for a
chip skipped, come out not correct.  The same on the card, where there is
one (``gpu``)."""

from __future__ import annotations

import pytest
import torch

from benchmark.core import runner
from benchmark.faults import FAULTS
from benchmark.tests.tiny import tiny_run

CELLS = ["flagship-serve", "deep3-serve", "flagship-train", "deep3-train"]


def _verdict(run, numbers):
    return runner.correct(run, runner.judge(run, numbers))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    run = tiny_run(cell)
    assert _verdict(run, runner.execute(run))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    run = tiny_run(cell)
    runner.execute(run)
    control = run.bench.kind(run.mix["kind"]).check(run, control=True)
    assert not _verdict(run, control), control


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS["serve" if "serve" in c else "train"]])
def test_each_fault_is_not_correct(cell, fault):
    kind = "serve" if "serve" in cell else "train"
    with FAULTS[kind][fault]():
        run = tiny_run(cell)
        numbers = runner.execute(run)
    assert not _verdict(run, numbers), numbers


def test_the_guard_counts_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "specenh_torch_like", types.ModuleType("x"))
    assert "specenh" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "specenh.config", types.ModuleType("y"))
    assert runner.forbidden_modules() == ["specenh"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["flagship-serve", "flagship-train"])
def test_on_the_card_sound_is_correct_and_the_control_is_not(card, cell):
    run = tiny_run(cell)
    run.device = card
    assert _verdict(run, runner.execute(run))
    control = run.bench.kind(run.mix["kind"]).check(run, control=True)
    assert not _verdict(run, control)
