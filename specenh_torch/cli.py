"""Command-line interface of the port (the counterpart of ``specenh.cli``):
the reference's sweep scripts as the ``sweep`` subcommand.

    python -m specenh_torch.cli sweep --dataset DATA.hdf5 --out-dir OUT \\
        [--grid kernel|2layer|3layer] [--engine envelope|kernel] [--device cuda]

``sweep`` <- VAE/hyperparam_scan.py's kernel array, VAE/manual_scan.py and
manual_scan_3layers.py, with the JAX package's flags, defaults and
artifacts: ``val_losses.npy`` in the grid's shape, ``loss_comparisons.npz``,
``best_model/``, ``best_val_loss.png`` and a final JSON line.  One flag is
the port's own: ``--device`` (default ``cuda``; the CPU tests pass
``--device cpu``).  Flags of paths not ported yet (more than one device,
the streamed sweep) exit naming their ROADMAP item.  The other
subcommands of the JAX CLI are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from specenh_torch.config import ModelConfig, SweepConfig, TrainConfig

__all__ = ["build_parser", "cmd_sweep", "main"]


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
