"""Nothing the benchmark runs imports JAX, Flax or the JAX package: a
serving and a training cell's set-up, window and check at a small size on
the CPU, in a process where importing ``jax``, ``jaxlib``, ``flax`` or
``specenh`` (whole top-level names: ``specenh_torch`` is not ``specenh``)
raises.  And without a card the command exits non-zero with a message and
prints no metric."""

from __future__ import annotations

import subprocess
import sys

from benchmark.tests.tiny import ROOT

BLOCKED = '''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "specenh"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
from benchmark.core import runner
from benchmark.tests.tiny import tiny_run
for cell in ("flagship-serve", "deep3-train"):
    run = tiny_run(cell)
    runner.execute(run)
    assert run.attempted > 0, cell
assert runner.forbidden_modules() == [], runner.forbidden_modules()
import specenh_torch
print("clean", sorted(m for m in sys.modules if m.startswith("specenh")))
'''


def test_a_cell_runs_with_jax_and_the_jax_package_blocked():
    res = subprocess.run([sys.executable, "-c", BLOCKED.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "clean" in res.stdout
    assert "'specenh'" not in res.stdout


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flagship-serve",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr
