"""One run of one cell: set-up, the measured window (optionally traced),
the check against the plain reference, and the result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic kind (``kinds/<kind>.py``) does the work in four steps
that this module calls in order: ``setup(run)`` (the cell's libraries,
weights and inputs from the seed, warm-up), ``window(run)`` (the measured
seconds; returns the end-to-end values), ``release(run)`` (frees the
program's state) and ``check(run)`` (the numbers that decide ``correct``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from benchmark.core.manifest import Bench

FORBIDDEN = ("jax", "jaxlib", "flax", "specenh")


@dataclass
class Run:
    """What one run knows: its cell, its inputs' seed, what the kind made
    and measured, and what the metric readers read."""

    bench: Bench
    workload: Dict
    config: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    state: Dict[str, Any] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    e2e: Dict[str, float] = field(default_factory=dict)
    build_s: Dict[str, float] = field(default_factory=dict)
    setup_s: float = math.nan
    window_s: float = math.nan
    peak_bytes: int = 0
    window_peak_bytes: int = 0
    summary: Any = None
    attempted: int = 0
    failed: int = 0
    trace_read_s: float = 0.0
    marks: Dict[str, float] = field(default_factory=dict)

    def mark(self, name: str) -> None:
        """Seconds from the process's start to the end of a set-up phase."""
        self.marks[name] = round(time.perf_counter() - self.t_start, 3)

    def span(self, name: str):
        """A host span in the profiled window: nothing when not tracing, or
        when the mix has the profiler record no host operators (a span
        costs the host time)."""
        if not (self.trace and self.mix.get("trace_host_ops", True)):
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"benchmark.{name}")


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``specenh_torch`` is not ``specenh``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(run: Run) -> Dict[str, float]:
    """Set-up, window, release, check; returns the compared numbers."""
    import torch

    from benchmark.core.trace import summarize, traced

    kind = run.bench.kind(run.mix["kind"])
    cuda = run.device.type == "cuda"
    run.mark("imports")
    kind.setup(run)
    _sync(run.device)
    run.setup_s = time.perf_counter() - run.t_start
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    with traced(run.trace, run.mix.get("trace_host_ops", True)) as prof:
        with run.span("window"):
            run.e2e = kind.window(run)
        _sync(run.device)
    if prof is not None:
        t0 = time.perf_counter()
        run.summary = summarize(prof, run.window_s)
        run.trace_read_s = time.perf_counter() - t0
    if cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated(run.device)
        run.peak_bytes = max(run.peak_bytes, run.window_peak_bytes)
    kind.release(run)
    if cuda:
        torch.cuda.empty_cache()
    return kind.check(run)


def judge(run: Run, numbers: Dict[str, float]) -> Dict[str, Dict[str, Optional[float]]]:
    """Each number with a limit in the cell's limits file, beside it."""
    limits = run.bench.limits(run.workload["name"])["numbers"]
    return {k: {"value": numbers.get(k), "limit": v["limit"]} for k, v in limits.items()}


def correct(run: Run, checks: Dict[str, Dict[str, Optional[float]]]) -> bool:
    ok = bool(checks) and run.attempted > 0 and run.failed == 0
    for c in checks.values():
        v = c["value"]
        ok = ok and v is not None and math.isfinite(v) and v <= c["limit"]
    return ok


def metrics(run: Run) -> Dict[str, Dict[str, Any]]:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced)."""
    out = {}
    if not run.trace:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in run.bench.end_to_end_for(run.workload["name"]):
            if m["name"] not in values:
                raise RuntimeError(f"the {run.mix['kind']} kind measured no {m['name']}")
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out
    for m in run.bench.per_layer_for(run.workload["name"]):
        v = run.bench.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def power_limit() -> Optional[str]:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else None


def result_line(run: Run, checks) -> Dict[str, Any]:
    import torch

    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": run.workload["chips"], "memory_peak_bytes": int(run.peak_bytes)}
    line: Dict[str, Any] = {"correct": correct(run, checks), "attempted": run.attempted,
                            "failed": run.failed, "metrics": metrics(run), "device": device}
    if run.trace:
        s = run.summary
        device["busy_s"] = s.busy_s if s is not None else 0.0
        device["window_s"] = run.window_s
        if s is not None:
            line["breakdown"] = s.breakdown()
    line["notes"] = {"seed": run.seed, "build_s": run.build_s, "setup_marks": run.marks,
                     "trace_read_s": run.trace_read_s,
                     "card": power_limit() if run.device.type == "cuda" else None}
    line["checks"] = checks
    return line


def span_stats(run: Run) -> Dict[str, List[float]]:
    """Each host span's count, min, quartiles and max (seconds)."""
    import statistics

    out = {}
    for k, v in run.spans.items():
        if len(v) >= 2:
            q = statistics.quantiles(v, n=4)
            out[k] = [len(v), round(min(v), 6), *(round(x, 6) for x in q), round(max(v), 6)]
    return out


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    root = Path(__file__).resolve().parents[2]
    bench = Bench(root)
    cell = bench.workload(args.workload)
    cache_env(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell['name']} needs {cell['chips']} CUDA device(s), found {n}; "
              "it measures the card and never falls back to the CPU", file=sys.stderr)
        return 2
    run = Run(bench=bench, workload=cell, config=bench.config(cell["config"]),
              mix=bench.traffic(cell["traffic"]), seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=torch.device("cuda", 0), t_start=t_start)
    numbers = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; the port's benchmark loads neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 3
    checks = judge(run, numbers)
    line = result_line(run, checks)
    print(f"# {cell['name']} seed {run.seed}: setup {run.setup_s:.3f} s, window "
          f"{run.window_s:.3f} s, build {run.build_s}, spans {span_stats(run)}, "
          f"all numbers {numbers}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
