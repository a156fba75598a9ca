"""Command-line interface of the port (the counterpart of ``specenh.cli``):
the reference's scripts as subcommands.

    python -m specenh_torch.cli sweep --dataset DATA.hdf5 --out-dir OUT \\
        [--grid kernel|2layer|3layer] [--engine envelope|kernel] [--device cuda]
    python -m specenh_torch.cli train-raw --data-dir RAW --out-dir OUT \\
        [--binary] [--engine f32|bf16|kernel] [--model scan_k3] [--device cuda]

``sweep``       <- VAE/hyperparam_scan.py's kernel array, VAE/manual_scan.py
                   and manual_scan_3layers.py
``train-raw``   -- raw shots -> trained model on the device, no store
                   (``e2e.train_from_raw``: K1, the label pipeline, the
                   training kernels with ``--engine kernel``)
``denoise``     <- denoising_by_svd.ipynb (SVD denoise one channel of a store)
``crosspower``  <- interferometer/crosspowerspec.py
``synth-shots`` -- synthetic raw campaign generator (ECE pickles)
``convert-bin`` -- pickle shots -> SPEC binaries (``--binary`` input)

Each has the JAX package's flags, defaults, artifacts and final JSON line.
One flag is the port's own: ``--device`` (default ``cuda``; the CPU tests
pass ``--device cpu``) on ``sweep``, ``train-raw``, ``denoise`` and
``crosspower``.  Flags of paths not ported yet (more than one device, the
streamed sweep) exit naming their ROADMAP item.  The JAX CLI's
``build-data``, ``merge-shards``, ``train``, ``serve``, ``bench``,
``movie`` and ``import-keras`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from specenh_torch.config import MODEL_PRESETS, Config, ModelConfig, SweepConfig, TrainConfig

__all__ = ["build_parser", "cmd_convert_bin", "cmd_crosspower", "cmd_denoise", "cmd_sweep",
           "cmd_synth_shots", "cmd_train_raw", "main"]


def _cfg_from_args(args) -> Config:
    cfg = Config()
    if getattr(args, "cut_shot", None):
        import dataclasses

        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, cut_shot=args.cut_shot))
    return cfg


def _device(name: str):
    """The torch device of ``--device``; a CUDA device where there is none
    exits (there is no CPU fallback)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    return dev


def cmd_convert_bin(args):
    """pickle shots -> SPEC binary (the native streaming input)."""
    import glob as _glob

    from specenh_torch.io.binfmt import convert_ece_pickle

    os.makedirs(args.out_dir, exist_ok=True)
    channels = list(range(1, args.channels + 1))
    n = 0
    for pkl in sorted(_glob.glob(os.path.join(args.data_dir, "*.pkl"))):
        base = os.path.splitext(os.path.basename(pkl))[0] + ".bin"
        convert_ece_pickle(pkl, os.path.join(args.out_dir, base), channels)
        n += 1
    print(json.dumps({"converted": n}))


def cmd_synth_shots(args):
    """Generate synthetic raw ECE pickle shots (chirp + tone + noise) so the
    whole stack can run without DIII-D data access."""
    from specenh_torch.data.dataset import synthetic_shot_batch
    from specenh_torch.io.shots import ece_key

    os.makedirs(args.out, exist_ok=True)
    batch = synthetic_shot_batch(
        n_shots=args.shots, n_channels=args.channels, n_samples=args.samples, seed=args.seed
    )
    for s in range(args.shots):
        shot = 100000 + args.seed * 1000 + s
        data = {ece_key(c + 1): batch[s, c] for c in range(args.channels)}
        path = os.path.join(args.out, f"ece_{shot}.pkl")
        with open(path, "wb") as fh:
            pickle.dump(data, fh)
        print(path)


def cmd_train_raw(args):
    """Raw shots -> trained model on the device, no HDF5 round-trip
    (``e2e.train_from_raw``)."""
    import glob as _glob

    import torch

    from specenh_torch.e2e import train_from_raw
    from specenh_torch.io.native import read_shot
    from specenh_torch.io.shots import read_ece_channels
    from specenh_torch.ops import ae_kernel
    from specenh_torch.train import kernel_epoch_for, save_model

    if args.devices > 1:
        raise SystemExit("--devices > 1: multi-GPU training is not ported yet "
                         "(ROADMAP Queue 1 item 9, Multi-GPU)")
    cfg = _cfg_from_args(args)
    model_cfg = MODEL_PRESETS[args.model]
    if args.engine == "kernel" and not (ae_kernel.supports(model_cfg)
                                   or ae_kernel.supports3(model_cfg)):
        raise SystemExit(
            f"--engine kernel does not support the '{args.model}' "
            "geometry; use f32/bf16"
        )
    device = _device(args.device)
    traces = []
    if args.binary:
        for p in sorted(_glob.glob(os.path.join(args.data_dir, "*.bin"))):
            traces.append(read_shot(p, args.channels, cfg.spec.n_samples))
    else:
        for p in sorted(_glob.glob(os.path.join(args.data_dir, "*.pkl"))):
            traces.append(
                read_ece_channels(p, list(range(1, args.channels + 1)), cfg.spec.n_samples)
            )
    traces = np.concatenate(traces, axis=0)
    train_cfg = TrainConfig(
        epochs=args.epochs, seed=args.seed, split_by=args.split_by,
        batch_size=args.batch_size, learning_rate=args.lr,
        patience=args.patience,
    )
    state, hist = train_from_raw(
        traces, cfg, model_cfg, train_cfg,
        # shot-major stacking above: each file contributed args.channels
        # traces, so the leak-free split groups them back into shots
        channels_per_shot=args.channels,
        dtype=torch.bfloat16 if args.engine == "bf16" else None,
        epoch_fn=kernel_epoch_for(model_cfg, train_cfg) if args.engine == "kernel" else None,
        verbose=not args.quiet,
        device=device,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    save_model(state, os.path.join(args.out_dir, "model"), model_cfg)
    print(json.dumps({"val_loss": hist["val_loss"][-1], "channels": int(traces.shape[0])}))


def cmd_denoise(args):
    """SVD-denoise one channel of a store (denoising_by_svd.ipynb cells
    2-3): ``svd_denoised.npy`` and ``svd_compare.png``."""
    import torch

    from specenh_torch.io.store import SpectrogramStore
    from specenh_torch.ops.svd import denoise_signal
    from specenh_torch.viz.plots import plot_svd_compare

    device = _device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    with SpectrogramStore(args.dataset, "r") as store:
        shot = store.shots()[0] if args.shot is None else f"ece_{args.shot}"
        d = store.read_channel(shot, args.channel)
    sv = denoise_signal(torch.as_tensor(d["spec"], dtype=torch.float32, device=device))
    sv = sv.cpu().numpy()
    np.save(os.path.join(args.out_dir, "svd_denoised.npy"), sv)
    plot_svd_compare(
        d["spec"], d["pipeline_out"], sv, shot, args.channel,
        os.path.join(args.out_dir, "svd_compare.png"),
    )
    print(json.dumps({"shot": shot, "channel": args.channel}))


def cmd_crosspower(args):
    """Cross-power spectrogram of two chord signals
    (interferometer/crosspowerspec.py workflow).  Signals from .npy files
    or the site HDF5 layout (--base-dir/--fid-file/--shot)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch
    from matplotlib import gridspec

    from specenh_torch.ops.crosspower import ae_co2

    device = _device(args.device)
    if args.signal1 and args.signal2:
        sig1 = np.load(args.signal1)
        sig2 = np.load(args.signal2)
        t = (
            np.load(args.time)
            if args.time
            else np.arange(len(sig1)) / args.fs
        )
    else:
        from specenh_torch.io.shots import load_time_series_tensor, lookup_fid

        fid = lookup_fid(args.fid_file, int(args.shot))
        # reference quirk kept (crosspowerspec.py:33-34): signal1 comes
        # from the v1v3 pair and signal2 from the v2r0 pair — the cross
        # power is v1 x r0, exactly as the reference computes it
        sig1, _, _ = load_time_series_tensor(args.base_dir, fid, "v1", "v3")
        _, sig2, shots = load_time_series_tensor(args.base_dir, fid, "v2", "r0")
        i = int(np.abs(shots - int(args.shot)).argmin())
        sig1, sig2 = sig1[i], sig2[i]
        import h5py

        with h5py.File(os.path.join(args.base_dir, "tsignal.h5"), "r") as fh:
            t = fh["time"][()]

    ampsp, freq, time_ms = ae_co2(
        torch.as_tensor(sig1, dtype=torch.float32, device=device),
        torch.as_tensor(sig2, dtype=torch.float32, device=device), t,
        nperseg=args.nperseg,
    )
    ampsp = ampsp.cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, "ampsp.npy"), ampsp)
    fig = plt.figure(figsize=(8, 4), dpi=100)
    gs = gridspec.GridSpec(2, 1)
    ax = plt.subplot(gs[:])
    ax.imshow(np.log(ampsp).T, origin="lower", cmap="hot", aspect="auto",
              extent=[time_ms.min(), time_ms.max(), freq.min(), freq.max()])
    plt.ylabel("Frequency [kHz]")
    plt.xlabel("Time [ms]")
    out = os.path.join(args.out_dir, "crosspower.png")
    fig.savefig(out)
    plt.close(fig)
    print(json.dumps({"ampsp": list(ampsp.shape), "plot": out}))


def cmd_sweep(args):
    import torch

    from specenh_torch.data.dataset import assemble_from_store
    from specenh_torch.io.store import SpectrogramStore
    from specenh_torch.sweep import (config_pred_times, expand_grid_2layer,
                                     expand_grid_3layer, save_loss_comparisons,
                                     sweep_fit, sweep_fit_serial)
    from specenh_torch.train import create_state, save_model
    from specenh_torch.train_stream import estimate_resident_bytes, plan_stream_split

    def _kers(s):
        return tuple((int(v), int(v)) for v in s.split(","))

    def _ints(s):
        return tuple(int(v) for v in s.split(","))

    # grid-axis overrides (the constants the reference user edits:
    # hyperparam_scan.py:123, manual_scan.py:120-124,
    # manual_scan_3layers.py:119-123); a flag the selected grid does not
    # read is an error, not a silent no-op
    applicable = {
        "kernel": {"kernel_vals"},
        "2layer": {"ker1", "ker2", "ker3", "conv1", "conv2"},
        "3layer": {"ker", "conv1", "conv2", "conv3"},
    }[args.grid]
    all_axes = {"kernel_vals", "ker", "ker1", "ker2", "ker3",
                "conv1", "conv2", "conv3"}
    stray = sorted(ax for ax in all_axes - applicable if getattr(args, ax, None))
    if stray:
        flags = ", ".join("--" + s.replace("_", "-") for s in stray)
        raise SystemExit(
            f"{flags}: not an axis of --grid {args.grid} (its axes: "
            + ", ".join("--" + s.replace("_", "-") for s in sorted(applicable))
            + ")"
        )
    if args.devices > 1:
        raise SystemExit("--devices > 1: multi-GPU sweeps are not ported yet "
                         "(ROADMAP Queue 1 item 9, Multi-GPU)")
    if args.chunk_tiles or args.chunk_dtype or args.tile_cache:
        raise SystemExit("--chunk-tiles/--chunk-dtype/--tile-cache: the streamed sweep "
                         "is not ported yet (ROADMAP Queue 1 item 7, Out-of-core training)")
    if args.stream == "always":
        raise SystemExit("--stream always: the streamed sweep is not ported yet "
                         "(ROADMAP Queue 1 item 7, Out-of-core training)")
    over = {}
    if args.kernel_vals:
        over["kernel_vals"] = _kers(args.kernel_vals)
    if args.grid == "3layer":
        if args.ker:
            over["ker_vals_3layer"] = _kers(args.ker)
        for ax in ("conv1", "conv2", "conv3"):
            if getattr(args, ax):
                over[f"{ax}_vals_3layer"] = _ints(getattr(args, ax))
    elif args.grid == "2layer":
        for ax in ("ker1", "ker2", "ker3"):
            if getattr(args, ax):
                over[f"{ax}_vals"] = _kers(getattr(args, ax))
        for ax in ("conv1", "conv2"):
            if getattr(args, ax):
                over[f"{ax}_vals"] = _ints(getattr(args, ax))
    sw = SweepConfig(epochs=args.epochs, **over)
    if args.grid == "kernel":
        configs = [ModelConfig(filters=(32, 32), kernels=(k, k), out_kernel=k)
                   for k in sw.kernel_vals]
        grid_shape, names = (len(configs),), ["kernel"]
    elif args.grid == "3layer":
        configs, grid_shape = expand_grid_3layer(sw)
        names = ["ker", "conv1", "conv2", "conv3"]
    else:
        configs, grid_shape = expand_grid_2layer(sw)
        names = ["ker1", "ker2", "ker3", "conv1", "conv2"]

    train_cfg = TrainConfig(
        epochs=args.epochs, seed=args.seed, split_by=args.split_by,
        batch_size=args.batch_size, learning_rate=args.lr, patience=args.patience,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    dtype = torch.bfloat16 if args.bf16 else None
    store = SpectrogramStore(args.dataset, "r")
    try:
        # resident or streamed, from the store's metadata (as the JAX CLI)
        plan = plan_stream_split(store, num_samples=args.num_shots, cfg=train_cfg,
                                 seed=args.seed)
        n_total = sum(plan.n_tiles(s) for s in ("train", "tune", "test"))
        budget = float(os.environ.get("SPECENH_HBM_BUDGET_GB", "12")) * 2**30
        if args.stream == "auto" and estimate_resident_bytes(n_total) > budget:
            raise SystemExit(
                f"this sweep's {n_total} tiles exceed the resident budget "
                f"({budget / 2**30:g} GB, SPECENH_HBM_BUDGET_GB): the streamed sweep is "
                "not ported yet (ROADMAP Queue 1 item 7, Out-of-core training)")
        splits = assemble_from_store(store, num_samples=args.num_shots, cfg=train_cfg,
                                     seed=args.seed).reshaped()
    finally:
        store.close()
    ckpt_dir = os.path.join(args.out_dir, "checkpoints") if args.checkpoints else None
    fit_fn = sweep_fit_serial if args.engine == "kernel" else sweep_fit
    res = fit_fn(configs, splits.x_train, splits.y_train, splits.x_tune, splits.y_tune,
                 train_cfg, epochs=args.epochs, dtype=dtype, checkpoint_dir=ckpt_dir,
                 resume=args.resume, verbose=not args.quiet, device=args.device)
    np.save(os.path.join(args.out_dir, "val_losses.npy"), res.val_losses.reshape(grid_shape))

    # per-config inference time on the serving path (manual_scan.py:226-248)
    # on one channel's 30 tiles
    pred_times = np.zeros_like(res.val_losses)
    if not args.no_time_configs:
        pred_times = config_pred_times(res, splits.x_tune[:30], device=args.device)
    save_loss_comparisons(os.path.join(args.out_dir, "loss_comparisons.npz"),
                          res.val_losses, pred_times, grid_shape, names)
    best_cfg = res.configs[res.best_index]
    state = create_state(best_cfg, train_cfg, device=args.device)
    state.model.load_state_dict(res.best_params)
    save_model(state, os.path.join(args.out_dir, "best_model"), best_cfg)
    from specenh_torch.viz.plots import plot_val_loss

    plot_val_loss(res.val_history[:, res.best_index],
                  os.path.join(args.out_dir, "best_val_loss.png"))
    print(json.dumps({
        "best_index": res.best_index,
        "best_val_loss": float(res.val_losses[res.best_index]),
        "n_configs": len(configs),
    }))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="specenh_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    cb = sub.add_parser("convert-bin", help="pickle shots -> SPEC binaries")
    cb.add_argument("--data-dir", required=True)
    cb.add_argument("--out-dir", required=True)
    cb.add_argument("--channels", type=int, default=20)
    cb.set_defaults(fn=cmd_convert_bin)

    s = sub.add_parser("synth-shots", help="generate synthetic raw shots")
    s.add_argument("--out", required=True)
    s.add_argument("--shots", type=int, default=3)
    s.add_argument("--channels", type=int, default=20)
    s.add_argument("--samples", type=int, default=1_000_000)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_synth_shots)

    tr = sub.add_parser("train-raw", help="raw shots -> model on the device (no HDF5)")
    tr.add_argument("--data-dir", required=True)
    tr.add_argument("--out-dir", required=True)
    tr.add_argument("--model", choices=sorted(MODEL_PRESETS), default="scan_k3")
    tr.add_argument("--channels", type=int, default=20)
    tr.add_argument("--epochs", type=int, default=15)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--cut-shot", type=float, default=None)
    tr.add_argument("--split-by", choices=["tile", "shot"], default="tile",
                    help="'tile' = reference-exact leaky split; 'shot' = leak-free")
    tr.add_argument("--batch-size", type=int, default=128)
    tr.add_argument("--lr", type=float, default=1e-3)
    tr.add_argument("--patience", type=int, default=None,
                    help="early-stop after N stale val epochs (default off)")
    tr.add_argument("--binary", action="store_true")
    tr.add_argument("--engine", choices=["f32", "bf16", "kernel"], default="f32",
                    help="training engine: f32 (autograd, the default), bf16 "
                         "(autograd, bfloat16 activations), kernel (the CUDA "
                         "training kernels, bf16)")
    tr.add_argument("--devices", type=int, default=0,
                    help="more than 1: not ported yet (ROADMAP Queue 1 item 9)")
    tr.add_argument("--device", default="cuda",
                    help="the torch device training runs on (default cuda)")
    tr.add_argument("--quiet", action="store_true")
    tr.set_defaults(fn=cmd_train_raw)

    w = sub.add_parser("sweep", help="hyperparameter sweep")
    w.add_argument("--dataset", required=True)
    w.add_argument("--out-dir", required=True)
    w.add_argument("--grid", choices=["kernel", "2layer", "3layer"], default="kernel")
    w.add_argument("--kernel-vals", default=None, metavar="K,K,...",
                   help="kernel-grid square kernel sizes "
                        "(hyperparam_scan.py:123; default 3,5,7)")
    w.add_argument("--ker", default=None, metavar="K,...",
                   help="3layer grid kernel sizes "
                        "(manual_scan_3layers.py:119; default 5)")
    w.add_argument("--ker1", default=None, metavar="K,...",
                   help="2layer grid axis (manual_scan.py:120; default 5)")
    w.add_argument("--ker2", default=None, metavar="K,...")
    w.add_argument("--ker3", default=None, metavar="K,...")
    w.add_argument("--conv1", default=None, metavar="C,...",
                   help="filter-count axis (2layer default 64; 3layer 16)")
    w.add_argument("--conv2", default=None, metavar="C,...",
                   help="filter-count axis (default 32)")
    w.add_argument("--conv3", default=None, metavar="C,...",
                   help="3layer filter-count axis "
                        "(manual_scan_3layers.py:122; default 64)")
    w.add_argument("--epochs", type=int, default=15)
    w.add_argument("--num-shots", type=int, default=20)
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--split-by", choices=["tile", "shot"], default="tile",
                   help="'tile' = reference-exact leaky split; 'shot' = leak-free")
    w.add_argument("--batch-size", type=int, default=128)
    w.add_argument("--lr", type=float, default=1e-3)
    w.add_argument("--patience", type=int, default=None,
                   help="early-stop a config (serial engine) / the grid "
                        "(envelope: when every config is stale) after N "
                        "epochs without val improvement (default off)")
    w.add_argument("--devices", type=int, default=0,
                   help="more than 1: not ported yet (ROADMAP Queue 1 item 9)")
    w.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (parameters and Adam float32)")
    w.add_argument("--engine", choices=["envelope", "kernel"], default="envelope",
                   help="envelope: every config at once in the masked "
                        "largest geometry (grouped convs on autograd); "
                        "kernel: one fit per config at its own geometry, on "
                        "the CUDA training kernels where they cover it")
    w.add_argument("--stream", choices=["auto", "always", "never"], default="auto",
                   help="streamed sweeps are not ported yet (ROADMAP Queue 1 "
                        "item 7): 'always', or 'auto' over the resident budget "
                        "(SPECENH_HBM_BUDGET_GB, default 12), exits")
    w.add_argument("--chunk-tiles", type=int, default=None,
                   help="streamed sweeps only (not ported yet)")
    w.add_argument("--chunk-dtype", choices=["f32", "bf16"], default=None,
                   help="streamed sweeps only (not ported yet)")
    w.add_argument("--tile-cache", default=None, metavar="BASE",
                   help="streamed sweeps only (not ported yet)")
    w.add_argument("--no-time-configs", action="store_true",
                   help="skip the per-config pred_times measurement")
    w.add_argument("--checkpoints", action="store_true",
                   help="checkpoint the sweep every epoch")
    w.add_argument("--resume", action="store_true",
                   help="continue the grid from the latest epoch checkpoint")
    w.add_argument("--device", default="cuda",
                   help="the torch device the sweep runs on (default cuda)")
    w.add_argument("--quiet", action="store_true")
    w.set_defaults(fn=cmd_sweep)

    d = sub.add_parser("denoise", help="SVD denoise one channel")
    d.add_argument("--dataset", required=True)
    d.add_argument("--out-dir", required=True)
    d.add_argument("--shot", default=None)
    d.add_argument("--channel", type=int, default=1)
    d.add_argument("--device", default="cuda",
                   help="the torch device the SVD runs on (default cuda)")
    d.set_defaults(fn=cmd_denoise)

    cp = sub.add_parser("crosspower", help="two-chord cross-power spectrogram")
    cp.add_argument("--signal1", default=None, help=".npy chord signal 1")
    cp.add_argument("--signal2", default=None, help=".npy chord signal 2")
    cp.add_argument("--time", default=None, help=".npy time base (seconds)")
    cp.add_argument("--fs", type=float, default=1.667e6)
    cp.add_argument("--base-dir", default=None, help="site HDF5 layout root")
    cp.add_argument("--fid-file", default=None)
    cp.add_argument("--shot", default=None)
    cp.add_argument("--nperseg", type=int, default=1024)
    cp.add_argument("--out-dir", required=True)
    cp.add_argument("--device", default="cuda",
                    help="the torch device the transform runs on (default cuda)")
    cp.set_defaults(fn=cmd_crosspower)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except FileNotFoundError as e:
        raise SystemExit(f"specenh_torch {args.cmd}: file not found: {e}") from e
    except OSError as e:
        # h5py raises OSError for missing or corrupt dataset files
        raise SystemExit(f"specenh_torch {args.cmd}: {e}") from e


if __name__ == "__main__":
    main()
