"""The readings that the limits of ``correct`` are set from, for one cell:
over many seeds in one process, the program's numbers (a full set-up, a
window and the check, as a run makes them), the control's (the reference
one precision below the configuration's, in the program's place) and,
with ``--faults``, each fault of ``faults.py`` planted under the timed
path.  The benchmark's own runs run none of this.

    python benchmark/calibrate.py --workload <name> --seeds 1,2,3 --seconds 10 \
        [--control] [--faults] [--out readings.jsonl]

Each seed prints one JSON line (and appends it to ``--out``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import runner  # noqa: E402
from benchmark.core.manifest import Bench  # noqa: E402


def one(bench, cell, seed, seconds, t_start):
    import torch

    run = runner.Run(bench=bench, workload=cell, config=bench.config(cell["config"]),
                     mix=bench.traffic(cell["traffic"]), seed=seed, seconds=seconds,
                     trace=False, device=torch.device("cuda", 0), t_start=t_start)
    return run, runner.execute(run)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    bench = Bench(ROOT)
    cell = bench.workload(a.workload)
    runner.cache_env(ROOT)
    import torch

    from benchmark.faults import FAULTS

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    kind_name = bench.traffic(cell["traffic"])["kind"]
    t_start = T_START
    for seed in (int(s) for s in a.seeds.split(",")):
        run, numbers = one(bench, cell, seed, a.seconds, t_start)
        rec = {"workload": cell["name"], "seed": seed, "program": numbers, "e2e": run.e2e,
               "setup_s": run.setup_s, "window_s": run.window_s, "attempted": run.attempted,
               "build_s": run.build_s, "peak_bytes": run.peak_bytes}
        rec["leaves"] = run.state.get("leaves")
        if a.control:
            rec["control"] = bench.kind(kind_name).check(run, control=True)
            rec["control_leaves"] = run.state.get("leaves")
        del run
        if a.faults:
            for name, fault in FAULTS[kind_name].items():
                with fault():
                    frun, rec[f"fault_{name}"] = one(bench, cell, seed, min(a.seconds, 2.0),
                                                     time.perf_counter())
                rec[f"fault_{name}_leaves"] = frun.state.get("leaves")
                del frun
        torch.cuda.empty_cache()
        line = json.dumps(rec)
        print(line, flush=True)
        if a.out:
            Path(a.out).parent.mkdir(parents=True, exist_ok=True)
            with open(a.out, "a") as fh:
                fh.write(line + "\n")
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
