"""One traced run of one cell with the port's program spans recorded and
joined to the device trace (``core/spans.py``): the idle gaps named by
the program's spans, and by span name the idle, launches and device time.

    python benchmark/span_run.py --workload <name> --seed <n> --seconds <s> [--profile 0|1]

It runs the cell as ``run.py --trace 1`` does (set-up, then the window
under torch.profiler with the mix's ``trace_host_ops``), with the port's
span recorder on over the window, and skips the check against the
reference.  The last line of standard output is one JSON object: the
end-to-end values of the traced window, the gaps, the per-span sums, the
span metrics, and each per-layer metric of the cell read from the trace
alone and from the trace with the spans joined.  ``--profile 0`` records
the spans with the profiler off (the spans' own cost on the end-to-end
values).  Each span name's count, total and self seconds go to standard
error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import spans as S  # noqa: E402
from benchmark.core.manifest import Bench  # noqa: E402
from benchmark.core.runner import Run, _sync, cache_env, power_limit  # noqa: E402
from benchmark.core.trace import summarize, traced  # noqa: E402


def measure(run: Run, profile: bool = True) -> Dict[str, Any]:
    """Set-up, then the window with the spans recorded (and traced with
    ``profile``); returns the line's fields."""
    import torch
    from specenh_torch.utils.logging import recording

    kind = run.bench.kind(run.mix["kind"])
    kind.setup(run)
    _sync(run.device)
    run.setup_s = time.perf_counter() - run.t_start
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    tid = threading.get_native_id()
    with recording() as rec:
        with traced(profile, run.mix.get("trace_host_ops", True)) as prof:
            with run.span("window"):
                run.e2e = kind.window(run)
            _sync(run.device)
    if cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    spans = rec.spans()
    line: Dict[str, Any] = {"workload": run.workload["name"], "seed": run.seed,
                            "profile": profile, "setup_s": run.setup_s,
                            "window_s": run.window_s, "e2e": run.e2e,
                            "spans": len(spans), "span_stats": {
                                n: [d["count"], d["total_s"], d["self_s"]]
                                for n, d in rec.stats().items()}}
    if prof is not None:
        t0 = time.perf_counter()
        plain = summarize(prof, run.window_s)
        joined = S.join(prof, run.window_s, spans, tid)
        line["trace_read_s"] = time.perf_counter() - t0
        line["existing"] = existing_metrics(run, plain, joined)
        line["span_metrics"] = S.metrics(joined, run.window_s)
        if joined is not None:
            line.update(busy_s=joined.busy_s, idle_gaps=joined.breakdown(top=16)["idle_gaps"],
                        idle_total_s=joined.idle_total_s(), by_span={
                            n: {"count": len(d), "mean_ms": joined.mean_ms(n),
                                "idle_s": joined.idle_s[n],
                                "launches": joined.launches.get(n, 0),
                                "device_s": joined.device_s.get(n, 0.0)}
                            for n, d in joined.durations.items()})
    kind.release(run)
    return line


def existing_metrics(run: Run, plain, joined) -> Dict[str, List[Any]]:
    """Each per-layer metric of the cell, read from the trace alone and
    from the trace with the spans joined."""
    out = {}
    for m in run.bench.per_layer_for(run.workload["name"]):
        got = []
        for summary in (plain, joined):
            run.summary = summary
            got.append(run.bench.reader(m["name"])(run))
        out[m["name"]] = got
    run.summary = plain
    return out


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    cell = bench.workload(args.workload)
    cache_env(ROOT)
    import torch  # after cache_env: the build caches under the checkout

    if not torch.cuda.is_available():
        print("span_run: no CUDA device; it measures the card", file=sys.stderr)
        return 2
    run = Run(bench=bench, workload=cell, config=bench.config(cell["config"]),
              mix=bench.traffic(cell["traffic"]), seed=args.seed, seconds=args.seconds,
              trace=True, device=torch.device("cuda", 0), t_start=T_START)
    line = measure(run, bool(args.profile))
    line["card"] = power_limit()
    for n, (count, total, own) in line["span_stats"].items():
        print(f"span {n}: count {count}, total {total} s, self {own} s", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
