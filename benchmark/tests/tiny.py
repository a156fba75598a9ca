"""A cell at a size a CPU test holds: the flagship's widths, 0.2 s shots
(three tiles a channel), two channels, a batch of two."""

from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from benchmark.core.manifest import Bench
from benchmark.core.runner import Run

ROOT = Path(__file__).resolve().parents[2]


def tiny_run(workload: str, seed: int = 1234567, seconds: float = 0.3, trace: bool = False,
             bench: Bench | None = None) -> Run:
    bench = bench or Bench(ROOT)
    cell = bench.workload(workload)
    cfg = copy.deepcopy(bench.config(cell["config"]))
    cfg["spec"]["cut_shot"] = 0.2
    cfg["patch"]["tiles_per_spec"] = 3
    cfg["train"]["batch_size"] = 2
    mix = copy.deepcopy(bench.traffic(cell["traffic"]))
    if mix["kind"] == "serve":
        mix.update(channels=2, pool_shots=2)
        mix["check"] = {"sampled_shots": 1, "sample_from_first": 3}
    else:
        mix.update(shots=2, channels=2)
    return Run(bench=bench, workload=cell, config=cfg, mix=mix, seed=seed, seconds=seconds,
               trace=trace, device=torch.device("cpu"), t_start=time.perf_counter())
