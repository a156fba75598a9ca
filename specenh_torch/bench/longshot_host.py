"""Where the host's time goes in one call of the time-sharded long shot:

    python -m specenh_torch.bench.longshot_host [--iters 48] [--profiled 10] [--out FILE]

On the card, on an NCCL world of one ``("time",)`` mesh, JAX's headline
shot (``SpecParams(cut_shot=4.0)`` cut by ``usable_samples_tiled``:
1 998 848 samples, 61 tiles) as one (T,) trace (``example_shot`` seed 0),
through ``parallel.timeshard.make_sharded_enhance_shot`` with the flagship
AE in bf16 (glorot weights from seed 0); beside it the unsharded service
(``make_enhance_shot_fn``) on the same trace plus ``classical_pipeline``.
For each it prints, and writes to ``--out``, one JSON object:

- ``ms``: the median of CUDA events around a call (``--iters`` calls after
  a warm-up), the time ``longshot4s_ms`` would read;
- ``host_ms`` and ``wall_ms``: medians of the host clock from a call's
  start to its return, and to the card's end of its work (synchronized
  before and after each call): where the two are close the host bounds
  the call;
- under torch.profiler (``--profiled`` calls), per call: the card's busy
  ms; the host ms inside each stage (``stft``: ``_spectrogram_local`` or
  the service's front and AE; ``labels``: ``_enhance_local`` or
  ``classical_pipeline``; ``ae``: the stage kernels), each inclusive of
  the collectives it makes; the collectives' count and host ms
  (``GroupExchange``'s primitives with their copies to and from the
  wire); the count of CUDA runtime calls by name (kernel launches,
  copies, synchronizations); and the operators with the most host time
  of their own.

The profiler's own cost inflates every host figure under it: read them
as shares of the profiled call, and ``host_ms`` for the call itself.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

SPANS = ("stft", "labels", "ae")
PRIMITIVES = ("reduce", "all_gather", "gather", "broadcast")


def _spanned(name: str, f):
    """``f`` inside a torch.profiler span named ``name``."""
    from torch.profiler import record_function

    def g(*a, **k):
        with record_function(name):
            return f(*a, **k)

    return g


def _is_span(name: str) -> bool:
    return name in SPANS or name.startswith("collective.")


def host_wall(call, iters: int) -> tuple:
    """Median host ms from a call's start to its return, and to the end of
    its work on the card."""
    import torch

    host, wall = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def profiled_split(call, n: int) -> dict:
    """``call()`` n times under torch.profiler: per call, the card's busy
    ms, each span's and the collectives' host ms, the CUDA runtime calls
    by name and the operators with the most self host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    spans, runtime, gpu = {}, {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # the spans' own device-side annotations are no work of the card's
            if e.time_range.end > e.time_range.start and not _is_span(e.name):
                gpu.append((e.time_range.start, e.time_range.end))
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        if _is_span(e.name):
            cnt, tot = spans.get(e.name, (0, 0.0))
            spans[e.name] = (cnt + 1, tot + ms)
        elif e.name.startswith("cu"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    busy, end = 0.0, -1.0
    for a, b in sorted(gpu):
        if b > end:
            busy += b - max(a, end)
            end = b
    coll = [v for k, v in spans.items() if k.startswith("collective.")]
    ops = sorted((a for a in prof.key_averages() if a.key.startswith(("aten::", "c10d::"))),
                 key=lambda a: -a.self_cpu_time_total)[:8]
    return {
        "calls": n,
        "busy_ms": busy / 1e3 / n if gpu else None,
        "span_ms": {k: spans[k][1] / n for k in SPANS if k in spans},
        "collectives": sum(c for c, _ in coll) / n,
        "collective_ms": sum(t for _, t in coll) / n,
        "collective_by_kind": {k.split(".", 1)[1]: v[0] / n for k, v in sorted(spans.items())
                               if k.startswith("collective.")},
        "runtime_calls": dict(sorted(((k, v / n) for k, v in runtime.items()),
                                     key=lambda kv: -kv[1])[:8]),
        "top_self_cpu_ms": {a.key: a.self_cpu_time_total / 1e3 / n for a in ops},
        "op_calls": sum(a.count for a in prof.key_averages()
                        if a.key.startswith("aten::")) / n,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--profiled", type=int, default=10)
    ap.add_argument("--out", help="also write the JSON objects here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from specenh_torch import _build
    from specenh_torch.bench.harness import example_shot, make_enhance_shot_fn, time_cuda
    from specenh_torch.config import ModelConfig, SpecParams
    from specenh_torch.models.autoencoder import make_model
    from specenh_torch.ops import ae_kernel as AK
    from specenh_torch.ops import enhance as EN
    from specenh_torch.parallel import collectives as CO
    from specenh_torch.parallel import timeshard as TS
    from specenh_torch.parallel.mesh import make_mesh

    _build.build_all(("stft", "ae"))
    dev = torch.device("cuda:0")
    gpu = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    sp = SpecParams(cut_shot=4.0)
    t = TS.usable_samples_tiled(sp.n_samples, 1, sp)
    whole = torch.from_numpy(example_shot(sp, 1, 0)).to(dev)  # the service takes 4 s
    x = whole[0, :t]
    model = make_model(ModelConfig(), generator=torch.Generator().manual_seed(0),
                       device=dev).eval()
    mesh = make_mesh(1, ("time",), device=dev)
    fn = TS.make_sharded_enhance_shot(ModelConfig(), sp, mesh, n_samples=t)
    wts = fn.prepare(model)
    svc = make_enhance_shot_fn(ModelConfig(), sp, device=dev)
    swts = svc.prepare(model)
    calls = {"timeshard": lambda: fn(wts, x), "unsharded": lambda: unsharded()}
    stages = {"stft": svc, "labels": EN.classical_pipeline}

    def unsharded():
        specs, enh = stages["stft"](swts, whole)
        return enh, stages["labels"](specs)

    out = {"gpu": gpu, "torch": torch.__version__, "samples": t}
    for name, call in calls.items():  # timed without the spans
        out[name] = {"ms": time_cuda(call, warmup=3, iters=args.iters)}
        out[name]["host_ms"], out[name]["wall_ms"] = host_wall(call, args.iters)
    # the spans the split reads; the shot's closures look these names up at call time
    TS._spectrogram_local = _spanned("stft", TS._spectrogram_local)
    TS._enhance_local = _spanned("labels", TS._enhance_local)
    AK.ae_kernel_enhance_specs = _spanned("ae", AK.ae_kernel_enhance_specs)
    for prim in PRIMITIVES:
        setattr(CO.GroupExchange, prim,
                _spanned(f"collective.{prim}", getattr(CO.GroupExchange, prim)))
    stages = {k: _spanned(k, f) for k, f in stages.items()}
    for name, call in calls.items():
        out[name].update(profiled_split(call, args.profiled))
        print(json.dumps({name: out[name], "gpu": gpu}), flush=True)
    mesh.close()
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
