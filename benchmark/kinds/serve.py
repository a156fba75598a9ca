"""Serving traffic: shots through the resident service
``specenh_torch.serve.EnhanceService.dispatch`` (K1, then the AE stage
kernels), in a closed loop with ``in_flight`` shots outstanding: the next
shot is dispatched before the host waits on the one ahead.  The outputs
stay on the device.

End-to-end: ``specs_per_s`` (the spectrograms of every shot completed in
the window over the window) and ``shot_p95_ms`` (the 95th percentile over
all of the window's shots of the host time from a shot's dispatch to its
completion event being observed).

``correct``: the outputs of a sample of the window's shots, drawn from
the seed, and of its last shot, against the reference service (the
recipe's STFT in float64, the autoencoder in float32 with TF32 off) on
the same traces and weights: both outputs, the spectrograms (K1) and the
enhanced spectrograms (the AE stages).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.core import inputs, port
from benchmark.core.numbers import reference_off_tf32, serve_numbers
from benchmark.reference import ae as ref_ae
from benchmark.reference import lowp
from benchmark.reference import stft as ref_stft


def setup(run) -> None:
    from specenh_torch.models.autoencoder import make_model
    from specenh_torch.serve import EnhanceService

    mix, cfg = run.mix, run.config
    port.build(run, ("stft", "ae"))
    run.mark("built")
    port_cfg, model_cfg = port.configs(cfg)
    weights = inputs.glorot_weights(cfg["model"], run.seed, run.device)
    model = make_model(model_cfg, generator=torch.Generator().manual_seed(0),
                       device=run.device)
    model.load_state_dict(weights)
    svc = EnhanceService(port_cfg, model_cfg, params=model, n_channels=mix["channels"],
                         device=run.device, dtype=port.DTYPES[cfg["precision"]["ae"]])
    pool = inputs.shots(mix["pool_shots"], mix["channels"], cfg["spec"], mix["shot"],
                        run.seed, run.device)
    run.mark("inputs")
    for i in range(mix["in_flight"] + 1):
        svc.dispatch(pool[i % len(pool)])
    rng = np.random.default_rng([run.seed, 11])
    sample = rng.choice(mix["check"]["sample_from_first"], mix["check"]["sampled_shots"],
                        replace=False)
    run.state.update(svc=svc, pool=pool, weights=weights, sample=set(sample.tolist()))


class _Done:
    def synchronize(self) -> None:
        pass


def _marker(device):
    if device.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


def window(run) -> Dict[str, float]:
    svc, pool, sample = run.state["svc"], run.state["pool"], run.state["sample"]
    depth, c = run.mix["in_flight"], run.mix["channels"]
    pending: collections.deque = collections.deque()
    latency: List[float] = []
    enqueue: List[float] = []
    kept = {}
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        ts = time.perf_counter()
        with run.span("dispatch"):
            out = svc.dispatch(pool[i % len(pool)])
            done = _marker(run.device)
        enqueue.append(time.perf_counter() - ts)
        pending.append((ts, done))
        if i in sample:
            kept[i] = (i % len(pool), out)
        last = (i, i % len(pool), out)
        i += 1
        if len(pending) >= depth:
            with run.span("wait"):
                t_sent, ev = pending.popleft()
                ev.synchronize()
            latency.append(time.perf_counter() - t_sent)
        if time.perf_counter() >= deadline:
            break
    with run.span("drain"):
        while pending:
            t_sent, ev = pending.popleft()
            ev.synchronize()
            latency.append(time.perf_counter() - t_sent)
    run.window_s = time.perf_counter() - t0
    kept[last[0]] = last[1:]
    run.state["kept"] = kept
    run.attempted, run.failed = i, i - len(latency)
    run.counters = {"shots": len(latency), "channels": c}
    run.spans = {"dispatch": enqueue, "latency": latency}
    return {"specs_per_s": c * len(latency) / run.window_s,
            "shot_p95_ms": float(np.percentile(latency, 95)) * 1e3}


def release(run) -> None:
    run.state.pop("svc", None)


def _reference(run, traces, control: bool):
    """The reference service on ``traces``: (specs, enhanced); with
    ``control`` one precision below the configuration's (the STFT in
    bfloat16, the autoencoder in fp8)."""
    cfg = run.config
    spec = ref_stft.spectrogram(traces, cfg["spec"], lower=torch.bfloat16 if control else None)
    tiles = inputs.tiles(spec, cfg["patch"])
    depth = len(cfg["model"]["filters"])
    quant = lowp.fp8 if control else (lambda x: x)
    out = torch.empty_like(tiles)
    with torch.no_grad():
        for a in range(0, tiles.shape[0], 150):
            z = ref_ae.logits(run.state["weights"], tiles[a : a + 150], depth, quant)
            out[a : a + 150] = torch.sigmoid(z)
    c, k = spec.shape[0], cfg["patch"]["tiles_per_spec"]
    f, tt = out.shape[1:]
    enhanced = out.reshape(c, k, f, tt).permute(0, 2, 1, 3).reshape(c, f, k * tt)
    return spec, enhanced


def check(run, control: bool = False) -> Dict[str, float]:
    """The numbers of the sampled shots (the worst over them): the
    program's outputs, or with ``control`` the low-precision reference's,
    against the reference."""
    pool, worst = run.state["pool"], {}
    with reference_off_tf32():
        for idx, (specs, enhanced) in run.state["kept"].values():
            ref = _reference(run, pool[idx], control=False)
            got = _reference(run, pool[idx], control=True) if control else (specs, enhanced)
            for k, v in serve_numbers(got, ref).items():
                worst[k] = max(worst.get(k, -np.inf), v)
    return worst
