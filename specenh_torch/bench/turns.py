"""Time the stage kernels of one source tree, to compare two trees of the
port on the same card in turns (parent, change, change, parent):

    python specenh_torch/bench/turns.py --tree DIR [--out FILE] [--epochs]

imports ``specenh_torch`` from ``DIR`` (built there, into ``DIR/build``)
and prints one JSON object: the card's name and power limit, and for
each entry point the CUDA-event median milliseconds of a call ("ms",
which includes the wrapper's host path where that is longer than the
device's work) and the device time of the kernels it launches ("dev",
torch.profiler over 10 calls), at the main paths' shapes with glorot
weights from seed 0 and uniform inputs from seed 1:
the serving S4 (``ae_tile_out``) on a 20-channel shot's 600 tiles, and on
one 128-tile training batch conv 0 (``ae_train_in``, ``_pre``; and
``ae_train_in_shot`` on the first 128 tiles of a synthetic shot's
spectrograms, ``example_shot`` seed 0), the loss (``ae_train_loss``,
``_pre``) and a step's stages without the optimizer (``loss_grad_sums``),
for the flagship and deep3 in bf16; and a hash of the serving S1's and
S4's outputs ("sha"), which two trees that compute the same bits share.
It calls only entry points that the port has had since its training
stages ran on the tensor cores, so that it can time an older tree.

``--epochs`` also times epochs of the kernel engines (K5 and K7, bf16):
on the training data that ``DIR/chip_smoke.py`` builds (20 shots, 7200
training tiles, and that tree's labels), one warm-up epoch then five,
each on the host clock around a synchronized ``fit``; "epoch" holds their
median and the five times.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys


def device_ms(fn) -> float:
    """Device milliseconds of one call of ``fn``: the time of every CUDA
    kernel it launches, from torch.profiler over 10 calls after one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()) / 10 / 1e3


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(t.cpu().contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def epoch_seconds(dev) -> dict:
    """s/epoch of K5 and K7 on the data the tree's ``chip_smoke.py`` builds:
    {"flagship"/"deep3": {"median": s, "runs": [s, ...]}}."""
    import statistics
    import time

    import torch

    import chip_smoke
    from specenh_torch import SpecParams, TrainConfig
    from specenh_torch import train as TR

    built = chip_smoke.make_data(dev, SpecParams())
    data = built[0] if isinstance(built, tuple) else built
    tc = TrainConfig()
    out = {}
    for name, cfg in (("flagship", chip_smoke.FLAGSHIP), ("deep3", chip_smoke.DEEP3)):
        st = TR.create_state(cfg, tc, generator=torch.Generator().manual_seed(0), device=dev)
        fn = TR.kernel_epoch_for(cfg, tc)
        st, _ = TR.fit(st, data.x_train, data.y_train, cfg=tc, epochs=1, epoch_fn=fn)
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = TR.fit(st, data.x_train, data.y_train, cfg=tc, epochs=1, epoch_fn=fn)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        out[name] = {"median": statistics.median(runs), "runs": runs}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="root of the port's source tree")
    ap.add_argument("--out", help="also write the JSON object here")
    ap.add_argument("--epochs", action="store_true",
                    help="also time epochs of K5 and K7 on the tree's chip_smoke.py data")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch

    from specenh_torch import ModelConfig, SpecParams, _build
    from specenh_torch.bench.harness import example_shot, time_cuda
    from specenh_torch.config import MODEL_PRESETS
    from specenh_torch.data.tiles import patch
    from specenh_torch.models.autoencoder import make_model
    from specenh_torch.ops import ae_kernel as AK
    from specenh_torch.ops import ae_train_kernel as TK
    from specenh_torch.ops.stft_fused import spectrogram_fused

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    _build.build_all(("stft", "ae", "ae_train"))
    dev = torch.device("cuda:0")
    gpu = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    g = torch.Generator().manual_seed(1)
    x = torch.rand(128, 256, 128, generator=g).to(dev)
    y = torch.rand(128, 256, 128, generator=g).to(dev)
    mask = torch.ones(128, device=dev)
    sp = SpecParams()
    shot = torch.from_numpy(example_shot(sp, 20, 0)).to(dev)
    specs = spectrogram_fused(shot, sp)
    xs = patch(specs)[:128].contiguous()
    out = {"tree": args.tree, "gpu": gpu, "ms": {}, "dev": {}, "sha": {}}
    for name, cfg in (("flagship", ModelConfig()), ("deep3", MODEL_PRESETS["deep3"])):
        model = make_model(cfg, generator=torch.Generator().manual_seed(0), device=dev)
        tw = TK.build_train_weights(model, torch.bfloat16)
        c1 = tw.fwd.w[tw.fwd.out].shape[0]
        e = torch.rand(600, c1, 256, 128, generator=g).to(dev, torch.bfloat16)
        x16, y16 = x.to(torch.bfloat16), y.to(torch.bfloat16)
        fns = {
            "ae_tile_out": lambda: AK.ae_tile_out(tw.fwd, e, 30),
            "ae_train_in": lambda: TK.ae_train_in(tw, x),
            "ae_train_in_pre": lambda: TK.ae_train_in(tw, x16, pre=True),
            "ae_train_in_shot": lambda: TK.ae_train_in(tw, xs),
            "ae_train_loss": lambda: TK.ae_train_loss(tw, e[:128], y, mask),
            "ae_train_loss_pre": lambda: TK.ae_train_loss(tw, e[:128], y16, mask, pre=True),
            "step_stages": lambda: TK.loss_grad_sums(tw, x, y, mask),
        }
        out["ms"][name] = {k: min(time_cuda(f), time_cuda(f)) for k, f in fns.items()}
        out["dev"][name] = {k: device_ms(f) for k, f in fns.items()}
        out["sha"][name] = {k: digest(t) for k, t in (
            ("ae_tile_in", AK.ae_tile_in(tw.fwd, specs, 30)),
            ("ae_tile_out", AK.ae_tile_out(tw.fwd, e, 30)))}
    if args.epochs:
        out["epoch"] = epoch_seconds(dev)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
