"""Command-line interface of the port (the counterpart of ``specenh.cli``):
the reference's scripts as subcommands.

    python -m specenh_torch.cli build-data --data-dir RAW --out DATA.hdf5 [--binary]
    python -m specenh_torch.cli train --dataset DATA.hdf5 --out-dir OUT \\
        [--model scan_k3] [--engine f32|bf16|kernel] [--device cuda] [--devices N]
    python -m specenh_torch.cli serve --watch-dir IN --out ENH.hdf5 \\
        [--model-dir OUT/model] [--once] [--writers 2] [--device cuda] [--devices N]
    python -m specenh_torch.cli sweep --dataset DATA.hdf5 --out-dir OUT \\
        [--grid kernel|2layer|3layer] [--engine envelope|kernel] [--device cuda] \\
        [--devices N]
    python -m specenh_torch.cli train-raw --data-dir RAW --out-dir OUT \\
        [--binary] [--engine f32|bf16|kernel] [--model scan_k3] [--device cuda] \\
        [--devices N]

``build-data``   <- spec_denoising/pipeline_data.py (raw shots -> HDF5 store)
``merge-shards`` -- fold a writer pool's shard files into one store
``train``        <- VAE/hyperparam_scan.py (one config)
``sweep``        <- VAE/hyperparam_scan.py's kernel array, VAE/manual_scan.py
                    and manual_scan_3layers.py
``train-raw``    -- raw shots -> trained model on the device, no store
                    (``e2e.train_from_raw``: K1, the label pipeline, the
                    training kernels with ``--engine kernel``)
``serve``        -- the watch-directory enhancement service (``serve.py``)
``import-keras`` -- a reference Keras model -> the port's model directory
``denoise``      <- denoising_by_svd.ipynb (SVD denoise one channel of a store)
``crosspower``   <- interferometer/crosspowerspec.py
``movie``        <- graphs.ipynb cells 18-19 (frame dump + mp4)
``synth-shots``  -- synthetic raw campaign generator (ECE pickles)
``convert-bin``  -- pickle shots -> SPEC binaries (``--binary`` input)

Each has the JAX package's flags, defaults, artifacts and final JSON line.
One flag is the port's own: ``--device`` (default ``cuda``; the CPU tests
pass ``--device cpu``) on every command that computes.  ``--devices N``
runs a command on N processes, one a GPU (NCCL; gloo processes on the
CPU with ``--device cpu``): on its own the command starts them, under
``torchrun`` each joins the launched group; rank 0 writes the artifacts.
``train`` trains data-parallel (resident, or ``--stream``: each rank
uploads its block of every streamed batch), ``train-raw`` computes each
rank's block of the channels and trains data-parallel, ``sweep`` trains
each config data-parallel (``--engine kernel``, or streamed) or shards
the envelope's configs, and ``serve`` shards each shot's channels (rank 0
reads, persists and prints the totals).  The JAX CLI's ``bench`` is not
ported yet.  A model directory is the port's own
(``train.save_model``: ``params.pt`` and ``model_config.json``), not the
JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np

from specenh_torch.config import MODEL_PRESETS, Config, ModelConfig, SweepConfig, TrainConfig

__all__ = ["build_parser", "cmd_build_data", "cmd_convert_bin", "cmd_crosspower", "cmd_denoise",
           "cmd_import_keras", "cmd_merge_shards", "cmd_movie", "cmd_serve", "cmd_sweep",
           "cmd_synth_shots", "cmd_train", "cmd_train_raw", "main"]


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


def cmd_build_data(args):
    """Raw shots -> spectrograms and pipeline labels in an HDF5 store
    (``pipeline.build_dataset``, or ``build_dataset_streaming`` over SPEC
    binaries with ``--binary``)."""
    import glob as _glob

    cfg = _cfg_from_args(args)
    if not args.binary and args.writers != 1:
        # a flag the selected path never reads is an error, not a no-op
        raise SystemExit(
            "--writers applies to the streaming (--binary) campaign; the "
            "pickle path is the reference-parity synchronous loop"
        )
    device = _device(args.device)
    if args.binary:
        from specenh_torch.pipeline import build_dataset_streaming

        files = sorted(_glob.glob(os.path.join(args.data_dir, "*.bin")))
        summary = build_dataset_streaming(
            cfg, files, n_channels=args.channels, store_path=args.out,
            writers=args.writers, verbose=not args.quiet, device=device,
        )
    else:
        from specenh_torch.pipeline import build_dataset

        files = (
            sorted(_glob.glob(os.path.join(args.data_dir, "*.pkl")))
            if args.data_dir else None
        )
        summary = build_dataset(
            cfg,
            shot_files=files,
            channels=list(range(1, args.channels + 1)),
            store_path=args.out,
            verbose=not args.quiet,
            device=device,
        )
    print(json.dumps(summary))


def cmd_merge_shards(args):
    """Fold a writer-pool store's sidecar shards into one HDF5 file."""
    from specenh_torch.io.store import consolidate_shards

    n = consolidate_shards(
        args.store, out_path=args.out, remove=not args.keep_shards
    )
    print(json.dumps({"channels_merged": n, "out": args.out or args.store}))


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


def _dist_timeout():
    """Seconds a collective of ``train``/``serve --devices`` may wait
    (SPECENH_DIST_TIMEOUT_S; default: torch's)."""
    v = os.environ.get("SPECENH_DIST_TIMEOUT_S")
    return float(v) if v else None


def _launch_workers(argv, n: int) -> None:
    """Start ``n`` processes of this command, ranks 0..n-1 of one group
    (torchrun's environment, a free port on 127.0.0.1), and wait for them;
    the first that fails stops the others and exits."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    procs = []
    try:
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                       LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), PYTHONPATH=path)
            procs.append(subprocess.Popen([sys.executable, "-m", "specenh_torch.cli", *argv],
                                          env=env))
        while True:
            codes = [p.poll() for p in procs]
            for r, rc in enumerate(codes):
                if rc not in (None, 0):
                    raise SystemExit(f"{argv[0]} --devices {n}: rank {r} exited with "
                                     f"code {rc}")
            if all(rc == 0 for rc in codes):
                return
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def cmd_train(args):
    """One config on a store (hyperparam_scan.py's recipe): the resident
    single-device ``fit``, or with ``--stream`` (``always``, or ``auto``
    when the tile tensors exceed SPECENH_HBM_BUDGET_GB) the streamed
    ``fit_streaming``, on the f32 or bf16 autograd engine or the CUDA
    training kernels; then the reference's artifacts (``model/``,
    ``ex_specs.png``, ``val_loss.png/.txt``, ``metrics.jsonl``,
    ``plot_chn_{10,11,12}.png``, ``t_pred.txt`` timed on the serving
    path).  A streamed run's artifacts read a bounded test sample, and
    with ``--tile-cache`` the test and bench tiles come from float32 tile
    caches (the JAX package reads them in the chunk dtype).

    ``--devices N`` (N > 1) trains data-parallel on N ranks (the kernels
    through ``dp_kernel_epoch_for``): resident with ``parallel.dp_fit``,
    or streamed with ``fit_streaming(mesh=)`` where the tiles exceed even
    the N cards' budget (or ``--stream always``); the ranks are started
    here, one a GPU (gloo processes with ``--device cpu``), or, under
    ``torchrun``, are the launched group this process joins; rank 0 writes
    the artifacts.  More GPUs than are visible exit."""
    import contextlib

    import torch

    from specenh_torch import train as _train
    from specenh_torch.bench.harness import make_production_predict_fn
    from specenh_torch.config import PatchSpec
    from specenh_torch.data.dataset import assemble_from_store
    from specenh_torch.data.tiles import n_tiles_for, patch, unpatch
    from specenh_torch.io.store import SpectrogramStore
    from specenh_torch.ops import ae_kernel
    from specenh_torch.train_stream import (_iter_chunks, estimate_resident_bytes,
                                            fit_streaming, plan_stream_split)

    model_cfg = MODEL_PRESETS[args.model]
    engine = args.engine or ("bf16" if args.bf16 else "f32")
    if engine == "kernel" and not (ae_kernel.supports(model_cfg)
                                   or ae_kernel.supports3(model_cfg)):
        raise SystemExit(
            f"--engine kernel does not support the '{args.model}' "
            "geometry; use f32/bf16"
        )
    device = _device(args.device)
    devices = args.devices or 0
    # the launcher, or rank 0 of a launched group (ours or torchrun's), prints
    env = _launch_env(args, device) if devices > 1 else None
    lead = env is None or env[0] == 0
    train_cfg = TrainConfig(
        epochs=args.epochs, seed=args.seed, split_by=args.split_by,
        batch_size=args.batch_size, learning_rate=args.lr,
        patience=args.patience,
    )
    os.makedirs(args.out_dir, exist_ok=True)

    store = SpectrogramStore(args.dataset, "r")
    try:
        # metadata only: spec_shape reads no data
        _shot0 = store.shots()[0]
        k_tiles = n_tiles_for(
            store.spec_shape(_shot0, store.channels_of(_shot0)[0])[-1], PatchSpec()
        )
        # resident or streamed, from the store's metadata (as the JAX CLI)
        plan = plan_stream_split(
            store, num_samples=args.num_shots, cfg=train_cfg, seed=args.seed
        )
        n_total = sum(plan.n_tiles(s) for s in ("train", "tune", "test"))
        budget = float(os.environ.get("SPECENH_HBM_BUDGET_GB", "12")) * 2**30
        use_stream = args.stream == "always" or (
            args.stream == "auto" and estimate_resident_bytes(n_total) > budget
        )
        if use_stream and devices > 1:
            if args.stream == "auto" and estimate_resident_bytes(n_total) / devices <= budget:
                # sharded over the ranks the dataset IS resident (each card
                # holds its share of the tiles): the multi-GPU path asked for
                use_stream = False
                if not args.quiet and lead:
                    print(f"dataset fits sharded over {devices} devices; "
                          "using dp_fit instead of streaming")
            elif not args.quiet and lead:
                # too big even for the cards together: stream the chunks and
                # train each one data-parallel
                print(f"streaming chunks sharded over {devices} devices")
        if (args.chunk_tiles or args.chunk_dtype or args.tile_cache) and not use_stream:
            # a knob the selected path never reads is an error, not a no-op
            raise SystemExit(
                "--chunk-tiles/--chunk-dtype/--tile-cache apply to the streamed "
                "epoch only; this run is resident (dataset fits the HBM budget) "
                "— use --stream always to force streaming"
            )
        mesh = None
        if devices > 1:
            mesh = _join_mesh(args, device, env)
            if mesh is None:  # the launcher: its ranks have trained
                return
            device = mesh.device
        state = _train.create_state(
            model_cfg, train_cfg, device=device,
            dtype=torch.bfloat16 if engine == "bf16" else None,
        )
        epoch_fn = None
        if engine == "kernel":
            if mesh is not None:
                from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for

                epoch_fn = dp_kernel_epoch_for(model_cfg, train_cfg, mesh)
            else:
                epoch_fn = _train.kernel_epoch_for(model_cfg, train_cfg)
        fit_common = dict(
            metrics_path=os.path.join(args.out_dir, "metrics.jsonl"),
            checkpoint_dir=(os.path.join(args.out_dir, "checkpoints")
                            if args.checkpoints else None),
            resume=args.resume,
            verbose=not args.quiet,
        )
        trace_cm = contextlib.nullcontext()
        if args.trace_dir and lead:
            from specenh_torch.utils.logging import profile_trace

            trace_cm = profile_trace(args.trace_dir)
        if use_stream:
            if not args.quiet and lead:
                print(f"streaming {plan.n_tiles('train')} train tiles "
                      f"(resident estimate {estimate_resident_bytes(n_total)/2**30:.1f} GB "
                      f"> budget {budget/2**30:.1f} GB)" if args.stream == "auto"
                      else "streaming (forced)")
            with trace_cm:
                state, hist = fit_streaming(state, store, plan, train_cfg,
                                            chunk_tiles=args.chunk_tiles or 4096,
                                            epoch_fn=epoch_fn, mesh=mesh,
                                            cache=args.stream_cache,
                                            cache_dtype=args.chunk_dtype,
                                            tile_cache=args.tile_cache, **fit_common)
            if mesh is not None:
                torch.distributed.destroy_process_group()
                if not lead:
                    return
            # a bounded test sample for the display artifacts (the whole
            # test split may not fit); with --tile-cache from the test
            # split's float32 tile cache, whatever the chunk dtype
            x_test = None
            if plan.n_tiles("test"):
                if args.tile_cache:
                    from specenh_torch.data.tilecache import open_or_build

                    r_test = open_or_build(store, plan.test, args.tile_cache, "test",
                                           PatchSpec(), "f32", verbose=not args.quiet)
                    x_test = r_test.read_x(0, min(512, r_test.n))
                else:
                    chunk = next(_iter_chunks(store, plan.test, PatchSpec(), 512), None)
                    x_test = chunk[0] if chunk is not None else None
        elif mesh is not None:
            from specenh_torch.parallel.data_parallel import dp_fit

            splits = assemble_from_store(
                store, num_samples=args.num_shots, cfg=train_cfg, seed=args.seed
            ).reshaped()
            with trace_cm:
                state, hist = dp_fit(
                    state, splits.x_train, splits.y_train, mesh,
                    splits.x_tune, splits.y_tune,
                    epochs=args.epochs, batch_size=train_cfg.batch_size,
                    seed=args.seed, epoch_fn=epoch_fn,
                    patience=train_cfg.patience, **fit_common,
                )
            x_test = splits.x_test
            torch.distributed.destroy_process_group()
            if not lead:
                return
        else:
            splits = assemble_from_store(
                store, num_samples=args.num_shots, cfg=train_cfg, seed=args.seed
            ).reshaped()
            with trace_cm:
                state, hist = _train.fit(
                    state,
                    splits.x_train, splits.y_train, splits.x_tune, splits.y_tune,
                    train_cfg,
                    epoch_fn=epoch_fn,
                    **fit_common,
                )
            x_test = splits.x_test
        _train.save_model(state, os.path.join(args.out_dir, "model"), model_cfg)
        if not hist["val_loss"] or hist.get("new_epochs", 1) == 0:
            # resumed a finished run: nothing new to report
            print(json.dumps({"resumed": "already complete"}))
            return

        from specenh_torch.viz.plots import display, plot_val_loss, plt_spec_shot

        # predictions and the display artifact (hyperparam_scan.py:194-205);
        # skipped when the test split cannot restitch one spectrogram
        sample_shot = store.shots()[0]
        if x_test is not None and x_test.shape[0] >= k_tiles:
            preds = _train.predict(state, x_test)[..., 0].cpu()
            noisy = unpatch(torch.from_numpy(x_test[..., 0]), tiles_per_spec=k_tiles).numpy()
            final = unpatch(preds, tiles_per_spec=k_tiles).numpy()
            d = store.read_axes(sample_shot, 1)  # axes only: no spec data read
            display(noisy, final, os.path.join(args.out_dir, "ex_specs.png"), d["f"], d["t"],
                    seed=0)
        elif not args.quiet:
            print("test split too small for ex_specs.png; skipped")
        plot_val_loss(
            hist["val_loss"],
            os.path.join(args.out_dir, "val_loss.png"),
            os.path.join(args.out_dir, "val_loss.txt"),
        )

        # timed per-channel inference on a reference shot
        # (hyperparam_scan.py:214-244), on the serving path: the AE kernels
        # where a family covers the geometry, else the module
        prod_predict = make_production_predict_fn(model_cfg, device=device)
        prod_params = prod_predict.prepare(state.model)
        shot_key = (f"ece_{args.bench_shot}" if f"ece_{args.bench_shot}" in store.shots()
                    else sample_shot)
        t_predict = 0.0
        chns = store.channels_of(shot_key)
        # --tile-cache: the bench shot's tiles come from a float32
        # <base>.bench.tiles cache, built once, so a repeated run reads no
        # store data here (only the axes)
        bench = None
        if use_stream and args.tile_cache:
            from specenh_torch.data.grain_pipeline import RecordSlice
            from specenh_torch.data.tilecache import open_or_build

            ks = [n_tiles_for(store.spec_shape(shot_key, i)[-1], PatchSpec()) for i in chns]
            reader = open_or_build(store, [RecordSlice(shot_key, i, 0, k)
                                           for i, k in zip(chns, ks)],
                                   args.tile_cache, "bench", PatchSpec(), "f32",
                                   verbose=not args.quiet)
            offs = np.concatenate([[0], np.cumsum(ks)])
            bench = [(int(offs[j]), int(offs[j + 1])) for j in range(len(chns))]
        for j, i in enumerate(chns):
            if bench is not None:
                tiles = torch.from_numpy(reader.read_x(*bench[j]))
            else:
                d = store.read_channel(shot_key, i)
                tiles = patch(torch.from_numpy(d["spec"][None]))[..., None]
            start = time.time()
            p = prod_predict(prod_params, tiles)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_predict += time.time() - start
            if i in (10, 11, 12):
                # label tiles read lazily: only these 3 channels plot them
                pipe = (torch.from_numpy(reader.read_y(*bench[j])[..., 0]) if bench is not None
                        else patch(torch.from_numpy(d["pipeline_out"][None])))
                ax = store.read_axes(shot_key, i)
                plt_spec_shot(
                    unpatch(tiles[..., 0], tiles_per_spec=k_tiles)[0].numpy(),
                    unpatch(p[..., 0].cpu(), tiles_per_spec=k_tiles)[0].numpy(),
                    unpatch(pipe, tiles_per_spec=k_tiles)[0].numpy(),
                    shot_key, i, os.path.join(args.out_dir, f"plot_chn_{i}.png"),
                    ax["f"], ax["t"],
                )
        t_predict /= max(len(chns), 1)
        with open(os.path.join(args.out_dir, "t_pred.txt"), "w") as fh:
            fh.write(str(t_predict))
            fh.write(str(torch.cuda.device_count() if device.type == "cuda" else 1))
    finally:
        store.close()
    print(json.dumps({"val_loss": hist["val_loss"][-1], "t_pred": t_predict}))


def cmd_train_raw(args):
    """Raw shots -> trained model on the device, no HDF5 round-trip
    (``e2e.train_from_raw``).  ``--devices N`` (N > 1) runs it on N ranks,
    as ``train --devices``: each computes its block of the channels and
    trains data-parallel; rank 0 writes the model."""
    import glob as _glob

    import torch

    from specenh_torch.e2e import train_from_raw
    from specenh_torch.io.native import read_shot
    from specenh_torch.io.shots import read_ece_channels
    from specenh_torch.ops import ae_kernel
    from specenh_torch.train import kernel_epoch_for, save_model

    cfg = _cfg_from_args(args)
    model_cfg = MODEL_PRESETS[args.model]
    if args.engine == "kernel" and not (ae_kernel.supports(model_cfg)
                                   or ae_kernel.supports3(model_cfg)):
        raise SystemExit(
            f"--engine kernel does not support the '{args.model}' "
            "geometry; use f32/bf16"
        )
    device = _device(args.device)
    mesh = None
    if args.devices > 1:
        mesh = _join_mesh(args, device, _launch_env(args, device))
        if mesh is None:  # the launcher: its ranks have trained
            return
        device = mesh.device
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
    epoch_fn = None
    if args.engine == "kernel":
        if mesh is not None:
            from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for

            epoch_fn = dp_kernel_epoch_for(model_cfg, train_cfg, mesh)
        else:
            epoch_fn = kernel_epoch_for(model_cfg, train_cfg)
    lead = mesh is None or mesh.rank == 0
    state, hist = train_from_raw(
        traces, cfg, model_cfg, train_cfg,
        # shot-major stacking above: each file contributed args.channels
        # traces, so the leak-free split groups them back into shots
        channels_per_shot=args.channels,
        dtype=torch.bfloat16 if args.engine == "bf16" else None,
        epoch_fn=epoch_fn,
        mesh=mesh,
        verbose=not args.quiet and lead,
        device=device,
    )
    if mesh is not None:
        torch.distributed.destroy_process_group()
        if not lead:
            return
    os.makedirs(args.out_dir, exist_ok=True)
    save_model(state, os.path.join(args.out_dir, "model"), model_cfg)
    print(json.dumps({"val_loss": hist["val_loss"][-1], "channels": int(traces.shape[0])}))


def cmd_import_keras(args):
    """Convert a reference Keras SavedModel or ``.keras`` file (e.g. the
    reference's missing VAE/best_model artifact) into the port's model
    directory ``OUT_DIR/model`` (``params.pt``, ``model_config.json``),
    which ``serve --model-dir`` and ``train.load_model`` read.  TensorFlow
    is imported here only."""
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    try:
        from tensorflow import keras
    except ImportError as e:
        raise SystemExit(f"import-keras reads the Keras model with TensorFlow, which is not "
                         f"installed: {e}") from e

    from specenh_torch.models.keras_import import (model_config_from_keras_weights,
                                                   params_from_keras_weights)
    from specenh_torch.train import create_state, save_model

    km = keras.models.load_model(args.saved_model, compile=False)
    weights = km.get_weights()
    cfg = model_config_from_keras_weights(weights, input_shape=(256, 128, 1))
    state = create_state(cfg, TrainConfig(), device="cpu")
    state.model.load_state_dict(params_from_keras_weights(weights, cfg))
    save_model(state, os.path.join(args.out_dir, "model"), cfg)
    print(json.dumps({
        "filters": list(cfg.filters),
        "kernels": [list(k) for k in cfg.kernels],
        "out": os.path.join(args.out_dir, "model"),
    }))


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
    """A grid of configs on a store (hyperparam_scan.py's kernel array,
    manual_scan.py, manual_scan_3layers.py): the envelope (``sweep_fit``)
    or, with ``--engine kernel``, one fit per config (``sweep_fit_serial``,
    streamed with ``sweep_fit_serial_streamed``); then ``val_losses.npy``,
    ``loss_comparisons.npz`` with the configs' serving times,
    ``best_model/`` and ``best_val_loss.png``.  ``--devices N`` (N > 1)
    runs on N ranks, as ``train --devices``: the kernel engine and the
    streamed sweep train each config data-parallel (a "data" mesh), the
    envelope shards its configs (a "sweep" mesh); rank 0 writes the
    artifacts."""
    import torch

    from specenh_torch.data.dataset import assemble_from_store
    from specenh_torch.io.store import SpectrogramStore
    from specenh_torch.config import PatchSpec
    from specenh_torch.sweep import (config_pred_times, expand_grid_2layer,
                                     expand_grid_3layer, save_loss_comparisons,
                                     sweep_fit, sweep_fit_serial, sweep_fit_serial_streamed)
    from specenh_torch.train import create_state, save_model
    from specenh_torch.train_stream import (_iter_chunks, estimate_resident_bytes,
                                            plan_stream_split)

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
    device = _device(args.device)
    env = _launch_env(args, device) if args.devices > 1 else None
    os.makedirs(args.out_dir, exist_ok=True)
    dtype = torch.bfloat16 if args.bf16 else None
    ckpt_dir = os.path.join(args.out_dir, "checkpoints") if args.checkpoints else None
    store = SpectrogramStore(args.dataset, "r")
    try:
        # resident or streamed, from the store's metadata (as the JAX CLI);
        # only the serial engine streams (one fit_streaming per config),
        # the envelope needs the resident dataset
        plan = plan_stream_split(store, num_samples=args.num_shots, cfg=train_cfg,
                                 seed=args.seed)
        n_total = sum(plan.n_tiles(s) for s in ("train", "tune", "test"))
        budget = float(os.environ.get("SPECENH_HBM_BUDGET_GB", "12")) * 2**30
        use_stream = args.stream == "always" or (
            args.stream == "auto" and estimate_resident_bytes(n_total) > budget
        )
        if use_stream and args.engine != "kernel":
            raise SystemExit(
                "this sweep's dataset exceeds the resident budget (or --stream "
                "always was given): streamed sweeps run per-config on the "
                "serial engine — add --engine kernel (the vmapped envelope "
                "needs the resident dataset)"
            )
        if (args.chunk_tiles or args.chunk_dtype or args.tile_cache) and not use_stream:
            raise SystemExit(
                "--chunk-tiles/--chunk-dtype/--tile-cache apply to the "
                "streamed sweep only; this grid is resident — use --stream "
                "always to force streaming"
            )
        mesh, lead = None, True
        if args.devices > 1:
            # the serial engines train each config data-parallel, the
            # envelope shards the grid's configs
            mesh = _join_mesh(args, device, env,
                              "data" if args.engine == "kernel" else "sweep")
            if mesh is None:  # the launcher: its ranks have swept
                return
            device, lead = mesh.device, mesh.rank == 0
        common = dict(epochs=args.epochs, dtype=dtype, checkpoint_dir=ckpt_dir,
                      resume=args.resume, mesh=mesh, verbose=not args.quiet, device=device)
        if use_stream:
            if not args.quiet and lead:
                print(f"streaming sweep: {plan.n_tiles('train')} train tiles "
                      f"per config over {len(configs)} configs")
            res = sweep_fit_serial_streamed(
                configs, store, plan, train_cfg, chunk_tiles=args.chunk_tiles or 4096,
                cache_dtype=args.chunk_dtype, tile_cache=args.tile_cache, **common)
            # pred_times on one bounded tune chunk, never the whole split
            chunk = (next(_iter_chunks(store, plan.tune, PatchSpec(), 30), None)
                     if not args.no_time_configs else None)
            tile_batch = chunk[0][:30] if chunk is not None else None
        else:
            splits = assemble_from_store(store, num_samples=args.num_shots, cfg=train_cfg,
                                         seed=args.seed).reshaped()
            fit_fn = sweep_fit_serial if args.engine == "kernel" else sweep_fit
            res = fit_fn(configs, splits.x_train, splits.y_train, splits.x_tune,
                         splits.y_tune, train_cfg, **common)
            tile_batch = splits.x_tune[:30]
    finally:
        store.close()
    if mesh is not None:
        torch.distributed.destroy_process_group()
        if not lead:
            return
    np.save(os.path.join(args.out_dir, "val_losses.npy"), res.val_losses.reshape(grid_shape))

    # per-config inference time on the serving path (manual_scan.py:226-248)
    # on one channel's 30 tiles
    pred_times = np.zeros_like(res.val_losses)
    if not args.no_time_configs and tile_batch is not None:
        pred_times = config_pred_times(res, tile_batch, device=device)
    save_loss_comparisons(os.path.join(args.out_dir, "loss_comparisons.npz"),
                          res.val_losses, pred_times, grid_shape, names)
    best_cfg = res.configs[res.best_index]
    state = create_state(best_cfg, train_cfg, device=device)
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


def _launch_env(args, device):
    """``--devices N`` (N > 1): the launched group's (rank, world size,
    address, port) in a rank of it (ours or torchrun's), or None in the
    launcher, which exits first where fewer than N GPUs are visible."""
    from specenh_torch.parallel.mesh import check_visible
    from specenh_torch.parallel.multihost import _launcher_env

    env = _launcher_env()
    if env is None:
        try:
            check_visible(args.devices, device)
        except ValueError as e:
            raise SystemExit(f"--devices {args.devices}: {e}") from e
    return env


def _join_mesh(args, device, env, axis: str = "data"):
    """``--devices N`` (N > 1), ``env`` from ``_launch_env``: in a launched
    rank, join the group and return its mesh over ``axis``; in the
    launcher, start N ranks of this command, wait for them and return
    None."""
    from specenh_torch.parallel.mesh import default_backend, make_mesh
    from specenh_torch.parallel.multihost import initialize_distributed

    n = args.devices
    if env is None:
        _launch_workers(args.argv, n)
        return None
    try:
        initialize_distributed(backend=default_backend(device), timeout=_dist_timeout())
        return make_mesh(n, (axis,), device=device)
    except ValueError as e:
        raise SystemExit(f"--devices {n}: {e}") from e


def cmd_serve(args):
    """Watch a directory of SPEC .bin shots; enhance and persist each.
    ``--devices N`` (N > 1) shards each shot's channels over N ranks:
    rank 0 reads, dispatches, persists and prints the totals, the others
    follow its shots."""
    import sys as _sys

    from specenh_torch.serve import EnhanceService, serve_forever

    cfg = _cfg_from_args(args)
    device = _device(args.device)
    mesh = None
    if args.devices > 1:
        mesh = _join_mesh(args, device, _launch_env(args, device))
        if mesh is None:  # the launcher: its ranks have served
            return
        device = mesh.device
    params = None
    model_cfg = MODEL_PRESETS[args.model]
    if args.model_dir:
        from specenh_torch.train import load_model

        state, model_cfg = load_model(args.model_dir, device=device)
        params = state.model
    else:
        print(
            "WARNING: no --model-dir given — serving an UNTRAINED "
            f"randomly-initialised '{args.model}' model; outputs are not "
            "meaningful denoisings",
            file=_sys.stderr,
        )
    service = EnhanceService(cfg, model_cfg, params, n_channels=args.channels, device=device,
                             mesh=mesh)
    if not service.lead:
        service.follow()
        return
    totals = serve_forever(
        service, args.watch_dir, args.out,
        poll_s=args.poll, max_shots=args.max_shots, once=args.once,
        writers=args.writers, verbose=not args.quiet,
    )
    print(json.dumps(totals))


def cmd_movie(args):
    """Per-frame freq-x-channel JPGs of one shot and their mp4 (graphs.ipynb
    cells 18-19): the spectrograms, the pipeline's labels and the model's
    predictions (``--model``, a model directory; else the labels)."""
    import torch

    from specenh_torch.config import PatchSpec
    from specenh_torch.data.tiles import n_tiles_for, patch_nchw, unpatch
    from specenh_torch.io.store import SpectrogramStore
    from specenh_torch.train import load_model, predict
    from specenh_torch.viz.movie import dump_frames, render_movie

    with SpectrogramStore(args.dataset, "r") as store:
        shot = store.shots()[0] if args.shot is None else f"ece_{args.shot}"
        chns = [c for c in range(1, args.channels + 1) if store.has_channel(shot, c)]
        if not chns:
            raise SystemExit(
                f"no channels 1..{args.channels} found in {shot} of {args.dataset}"
            )
        specs = []
        labels = []
        for c in chns:
            d = store.read_channel(shot, c)
            specs.append(d["spec"])
            labels.append(d["pipeline_out"])
        f_ax, t_ax = d["f"], d["t"]
    specs = np.stack(specs)
    labels = np.stack(labels)
    # truncate to whole tiles (3840 at the reference geometry) so the three
    # stacks share the prediction width whatever cut_shot built the store
    k_t = n_tiles_for(specs.shape[-1], PatchSpec())
    t_keep = k_t * PatchSpec().tile_time
    if args.model:
        state, _ = load_model(args.model, device=_device(args.device))
        preds = unpatch(predict(state, patch_nchw(specs))[..., 0].cpu(),
                        tiles_per_spec=k_t).numpy()
    else:
        preds = labels[:, :, :t_keep]
    # (C, F, T) -> (F, T, C) stacks as graphs.ipynb cell 16 dstacks them
    noisy = specs[:, :, :t_keep].transpose(1, 2, 0)
    proc = labels[:, :, :t_keep].transpose(1, 2, 0)
    pred = preds.transpose(1, 2, 0)
    n = dump_frames(
        noisy, proc, pred, t_ax, f_ax, shot.replace("ece_", ""), args.out_dir,
        start=args.start, stop=args.stop,
    )
    path = render_movie(args.out_dir, shot.replace("ece_", ""), fps=args.fps)
    print(json.dumps({"frames": n, "movie": path}))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="specenh_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build-data", help="raw shots -> spectrogram HDF5 dataset")
    b.add_argument("--data-dir", default=None)
    b.add_argument("--out", required=True)
    b.add_argument("--channels", type=int, default=20)
    b.add_argument("--cut-shot", type=float, default=None)
    b.add_argument("--binary", action="store_true",
                   help="stream SPEC .bin shots via the native prefetcher")
    b.add_argument("--writers", type=int, default=1,
                   help="parallel HDF5 writer threads/files on the streaming "
                        "(--binary) path; readers see one union store")
    b.add_argument("--device", default="cuda",
                   help="the torch device the STFT and labels run on (default cuda)")
    b.add_argument("--quiet", action="store_true")
    b.set_defaults(fn=cmd_build_data)

    ms = sub.add_parser(
        "merge-shards",
        help="fold a writer-pool store (base + .shardK) into one HDF5 file",
    )
    ms.add_argument("--store", required=True, help="base store path")
    ms.add_argument("--out", default=None,
                    help="write the merged copy here instead of "
                         "consolidating in place")
    ms.add_argument("--keep-shards", action="store_true",
                    help="leave absorbed sidecars on disk (in-place mode)")
    ms.set_defaults(fn=cmd_merge_shards)

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

    t = sub.add_parser("train", help="train one autoencoder config")
    t.add_argument("--dataset", required=True)
    t.add_argument("--out-dir", required=True)
    t.add_argument("--model", choices=sorted(MODEL_PRESETS), default="scan_k3")
    t.add_argument("--epochs", type=int, default=15)
    t.add_argument("--num-shots", type=int, default=20)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--split-by", choices=["tile", "shot"], default="tile",
                   help="'tile' = reference-exact leaky split "
                        "(hyperparam_scan.py:148-149); 'shot' = leak-free "
                        "shot-level split (dataset.ipynb cell 3)")
    t.add_argument("--batch-size", type=int, default=128,
                   help="training batch size (reference recipe: 128)")
    t.add_argument("--lr", type=float, default=1e-3,
                   help="Adam learning rate (reference/Keras default 1e-3)")
    t.add_argument("--chunk-tiles", type=int, default=None,
                   help="tiles per streamed chunk (default 4096 ~ 1.1 GB "
                        "of device residency); streamed path only")
    t.add_argument("--chunk-dtype", choices=["f32", "bf16"], default=None,
                   help="streamed chunk storage/upload dtype: bf16 halves "
                        "cache RAM and per-epoch host->device bytes, and is "
                        "VALUE-EXACT with --engine kernel (the kernel casts "
                        "its tile operands to bf16 anyway); ~1e-3 input "
                        "quantization on the f32/bf16 engines")
    t.add_argument("--tile-cache", default=None, metavar="BASE",
                   help="persist the canonical tile stream pre-tiled on "
                        "disk (<BASE>.<split>.tiles, fingerprinted against "
                        "the exact slice plan): later runs over the same "
                        "dataset memmap contiguous chunk slabs instead of "
                        "re-reading + re-tiling HDF5")
    t.add_argument("--stream-cache", choices=["auto", "always", "never"],
                   default="auto",
                   help="host-RAM chunk cache for the streamed epoch: "
                        "epochs after the first stream from memory instead "
                        "of re-reading the store (~31 GB/epoch at reference "
                        "scale).  auto = bounded by SPECENH_STREAM_CACHE_GB "
                        "(default 60%% of MemAvailable)")
    t.add_argument("--patience", type=int, default=None,
                   help="early-stop after N epochs without val_loss "
                        "improvement (the reference's commented-out "
                        "EarlyStopping(patience=15); default: off)")
    t.add_argument("--bench-shot", default="176053")
    t.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of training")
    t.add_argument("--stream", choices=["auto", "always", "never"], default="auto",
                   help="host-stream the epoch when the tile tensors exceed "
                        "the device budget (auto sizes from store metadata; "
                        "budget via SPECENH_HBM_BUDGET_GB, default 12)")
    t.add_argument("--devices", type=int, default=0,
                   help="more than 1: data-parallel training on that many ranks, "
                        "one a GPU (gloo processes with --device cpu); started "
                        "here, or joined under torchrun")
    t.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (parameters and Adam float32)")
    t.add_argument("--engine", choices=["f32", "bf16", "kernel"], default=None,
                   help="training engine: f32 (autograd, the default), bf16 "
                        "(autograd, bfloat16 activations), kernel (the CUDA "
                        "training kernels, bf16)")
    t.add_argument("--checkpoints", action="store_true")
    t.add_argument("--resume", action="store_true",
                   help="continue from the latest epoch checkpoint")
    t.add_argument("--device", default="cuda",
                   help="the torch device training runs on (default cuda)")
    t.add_argument("--quiet", action="store_true")
    t.set_defaults(fn=cmd_train)

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
                    help="more than 1: each rank computes its block of the channels "
                         "and trains data-parallel, one rank a GPU (gloo processes "
                         "with --device cpu); started here, or joined under torchrun")
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
                   help="more than 1: --engine kernel (and a streamed sweep) trains "
                        "each config data-parallel, the envelope shards the configs; "
                        "one rank a GPU (gloo processes with --device cpu); started "
                        "here, or joined under torchrun")
    w.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (parameters and Adam float32)")
    w.add_argument("--engine", choices=["envelope", "kernel"], default="envelope",
                   help="envelope: every config at once in the masked "
                        "largest geometry (grouped convs on autograd); "
                        "kernel: one fit per config at its own geometry, on "
                        "the CUDA training kernels where they cover it")
    w.add_argument("--stream", choices=["auto", "always", "never"],
                   default="auto",
                   help="host-stream each config's epochs when the tile "
                        "tensors exceed the device budget (serial --engine "
                        "kernel only; the 200-shot recipe's grid cannot "
                        "assemble resident).  Same budget env as train.")
    w.add_argument("--chunk-tiles", type=int, default=None,
                   help="tiles per streamed chunk (streamed sweeps only)")
    w.add_argument("--chunk-dtype", choices=["f32", "bf16"], default=None,
                   help="streamed chunk dtype (see train --chunk-dtype)")
    w.add_argument("--tile-cache", default=None, metavar="BASE",
                   help="pre-tiled on-disk tile cache: configs 2..N skip "
                        "the HDF5 pass entirely (see train --tile-cache)")
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

    sv = sub.add_parser("serve", help="watch-dir enhancement service")
    sv.add_argument("--watch-dir", required=True)
    sv.add_argument("--out", required=True)
    sv.add_argument("--model", choices=sorted(MODEL_PRESETS), default="scan_k3")
    sv.add_argument("--model-dir", default=None,
                    help="trained model dir (overrides --model preset)")
    sv.add_argument("--channels", type=int, default=20)
    sv.add_argument("--devices", type=int, default=0,
                    help="shard each shot's channels over N ranks, one a GPU (NCCL; gloo "
                         "with --device cpu): started here, or joined under torchrun")
    sv.add_argument("--cut-shot", type=float, default=None)
    sv.add_argument("--poll", type=float, default=1.0)
    sv.add_argument("--max-shots", type=int, default=None)
    sv.add_argument("--once", action="store_true",
                    help="drain the current backlog and exit")
    sv.add_argument("--writers", type=int, default=1,
                    help="parallel HDF5 writer threads/files (readers see one "
                         "union store)")
    sv.add_argument("--device", default="cuda",
                    help="the torch device the service runs on (default cuda)")
    sv.add_argument("--quiet", action="store_true")
    sv.set_defaults(fn=cmd_serve)

    ik = sub.add_parser("import-keras", help="reference Keras model -> the port's model dir")
    ik.add_argument("--saved-model", required=True)
    ik.add_argument("--out-dir", required=True)
    ik.set_defaults(fn=cmd_import_keras)

    m = sub.add_parser("movie", help="frame dump + mp4 render")
    m.add_argument("--dataset", required=True)
    m.add_argument("--out-dir", required=True)
    m.add_argument("--shot", default=None)
    m.add_argument("--model", default=None)
    m.add_argument("--channels", type=int, default=20)
    m.add_argument("--start", type=int, default=0)
    m.add_argument("--stop", type=int, default=None)
    m.add_argument("--fps", type=int, default=30)
    m.add_argument("--device", default="cuda",
                   help="the torch device --model predicts on (default cuda)")
    m.set_defaults(fn=cmd_movie)
    return p


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.argv = argv
    try:
        args.fn(args)
    except FileNotFoundError as e:
        raise SystemExit(f"specenh_torch {args.cmd}: file not found: {e}") from e
    except OSError as e:
        # h5py raises OSError for missing or corrupt dataset files
        raise SystemExit(f"specenh_torch {args.cmd}: {e}") from e


if __name__ == "__main__":
    main()
