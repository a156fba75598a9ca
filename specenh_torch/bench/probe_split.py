"""Where the K11 probes' time goes, beside their PyTorch calls:

    python specenh_torch/bench/probe_split.py --tree DIR [--out FILE]

imports ``specenh_torch`` from ``DIR`` (its probes built there, into
``DIR/build``), checks each probe against its twin bit for bit, and times
each probe's wrapper and the one PyTorch call that computes the same
function (``LIBRARY``) on seeded input on the card, in turns (six turns
over all the functions, forward and backward; each figure the median of
its turns, so that the host's drift between calls weighs on each alike):

- ``a_ms``: the CUDA-event median of single calls, as ``chip_smoke.py``'s
  ``time_entries`` takes it (``harness.time_cuda``; 50 calls a turn where
  it takes 10).  The card is idle when each window opens, so the window
  holds the host's path to the launch as well as the device's work;
- ``b_ms``: the device time of a call, the CUDA kernels' time from
  torch.profiler over 10 calls (``turns.device_ms``);
- ``c_ms``: CUDA events around 200 calls back to back, over 200: the rate
  at which calls follow one another, the larger of the host's time a
  call and the device's;
- ``host_ms``: the host clock over the same 200 calls, over 200: the
  host's time to issue a call.

Beside each probe's wrapper it times its C entry point alone on an output
allocated once (``entry_call``), which parts the wrapper's Python (the
checks, the allocation) from the stream lookup, the ctypes call and the
launch.

It prints a line per function, the card's name and power limit, and one
JSON object as its last line.  It uses only what the port has had since
the probes were ported, so that it can time an older tree beside a newer
one in one run (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

BURST = 200  # calls back to back for (c)
ITERS = 50   # single calls a turn for (a)
TURNS = 6    # turns over the functions

# the PyTorch call that computes each probe's function
LIBRARY = {
    "sublane_offset1_slice": lambda x: torch.slice_copy(x, 0, 1, 257),  # x[1:257]
    "in_kernel_transpose": lambda x: torch.transpose_copy(x, 0, 1),
    "stride2_lane_slice": lambda x: torch.slice_copy(x, 1, 0, x.shape[1], 2),
}


def burst_ms(fn, n: int = BURST) -> tuple:
    """(device ms a call, host ms a call) over ``n`` calls back to back."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host


def split(fns: dict, turns: int = TURNS) -> dict:
    """{name: {"a_ms", "b_ms", "c_ms", "host_ms", "a_turns"}} for the
    functions ``fns`` ({name: fn}): ``turns`` turns over them, forward and
    backward by turns, each taking (a) (``harness.time_cuda`` over
    ``ITERS`` single calls), (c) and the host's time; each figure the
    median of its turns ("a_turns" lists (a)'s); (b) once, after the
    turns."""
    from specenh_torch.bench.harness import time_cuda
    from specenh_torch.bench.turns import device_ms

    names = list(fns)
    runs = {name: [] for name in names}
    for t in range(turns):
        for name in names if t % 2 == 0 else names[::-1]:
            c, host = burst_ms(fns[name])
            runs[name].append((time_cuda(fns[name], iters=ITERS), c, host))
    out = {}
    for name in names:
        a, c, host = (statistics.median(v) for v in zip(*runs[name]))
        out[name] = dict(a_ms=a, b_ms=device_ms(fns[name]), c_ms=c, host_ms=host,
                         a_turns=[r[0] for r in runs[name]])
    return out


def probe_functions(device, seed: int = 0) -> dict:
    """{"<probe>", "<probe> entry" and "<probe> library": fn} on each
    probe's input from
    ``seed``, after checking each probe and its library call against the
    twin bit for bit."""
    from specenh_torch import probe_walls as PW

    fns = {}
    for name, (fn, plain, shape) in PW.PROBES.items():
        x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)
        got = fn(x)
        torch.cuda.synchronize()
        if not torch.equal(got, plain(x)) or not torch.equal(LIBRARY[name](x), plain(x)):
            raise RuntimeError(f"{name}: the probe or its library call differs from the twin")
        fns[name] = lambda f=fn, x=x: f(x)
        fns[f"{name} entry"] = entry_call(PW, name, x)
        fns[f"{name} library"] = lambda f=LIBRARY[name], x=x: f(x)
    return fns


def entry_call(PW, name: str, x):
    """The probe's C entry point alone (``CudaKernel.__call__``: the stream
    lookup, the ctypes call, the launch) on an output allocated once: the
    wrapper's time less its checks and its allocation."""
    rows, cols = x.shape
    kern, shape, sizes = {
        "sublane_offset1_slice": (PW.ROW_SLICE, (PW.FB, cols), (cols,)),
        "in_kernel_transpose": (PW.TRANSPOSE, (cols, rows), (rows,)),
        "stride2_lane_slice": (PW.STRIDE2, (rows, cols // 2), (rows, cols // 2)),
    }[name]
    out = torch.empty(shape, device=x.device)
    args = (x.data_ptr(), out.data_ptr(), *sizes)
    return lambda: kern(*args)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="root of the port's source tree")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    from specenh_torch import _build

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _build.build("probes")
    gpu = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    res = split(probe_functions(torch.device("cuda:0")))
    for name, r in res.items():
        print(f"{name}: (a) {r['a_ms']:.4f} ms (turns {min(r['a_turns']):.4f}-"
              f"{max(r['a_turns']):.4f}), (b) {r['b_ms']:.4f} device ms, "
              f"(c) {r['c_ms']:.4f} ms a call in a burst of {BURST}, host {r['host_ms']:.4f} ms")
    print(gpu)
    out = {"tree": args.tree, "gpu": gpu, "torch": torch.__version__, "probes": res}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
