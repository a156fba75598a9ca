"""Headline benchmark of the port (the counterpart of
``specenh.bench.headline``): spectrograms/s on one card for the full
enhancement service (raw 20-channel shot -> K1 STFT -> conv-AE kernels ->
restitched spectrograms), against the reference's CPU recipe (SciPy
spectrogram + Keras predict, VAE/hyperparam_scan.py:214-244), with the
training, SVD, depth-3 serving, long-shot and streamed-read figures.

    python -m specenh_torch.bench.headline [--recompute-baseline]
    python -m specenh_torch.cli bench [--trace-dir DIR]

Prints ONE JSON line with the JAX package's 17 keys, in its order; the
diagnostic ``#`` lines go to stderr.  Each quality gate that fails raises
``SystemExit`` and nothing is printed.

Every ``measure_*`` runs on ``cuda`` unless the caller passes
``device="cpu"`` (the tests do: the kernels' plain twins run there, timed
on the host's clock); without a card it raises.  The CPU baseline is read
from ``bench_baseline_cpu.json`` at the repo root, which this module never
writes: without a Keras-measured value there (or with
``--recompute-baseline``) the reference recipe is measured for this run,
through TensorFlow, and its absence is an error.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from specenh_torch.bench.harness import example_shot, make_enhance_shot_fn, time_cuda
from specenh_torch.bench.reference import (spectrogram_ref, svd_compute_signal_ref,
                                           svd_denoise_ref)
from specenh_torch.config import MODEL_PRESETS, ModelConfig, PatchSpec, SpecParams, TrainConfig
from specenh_torch.io.memstore import MemoryStore
from specenh_torch.models.autoencoder import make_model
from specenh_torch.ops.svd import _fp32_matmul, compute_signal, denoise_signal
from specenh_torch.parallel.mesh import make_mesh
from specenh_torch.parallel.timeshard import make_sharded_enhance_shot, usable_samples_tiled
from specenh_torch.train import _epoch_batches, create_state, kernel_epoch_for, train_epoch
from specenh_torch.train_stream import _chunk_plans, _read_chunk, plan_stream_split
from specenh_torch.utils.metrics import ssim

__all__ = ["BASELINE_CACHE", "measure_card", "measure_train", "measure_svd",
           "measure_deep3_serving", "measure_longshot", "measure_stream_host",
           "measure_cpu_baseline", "get_cpu_baseline", "lowrank_batch", "gate_matrix",
           "synth_records", "synth_store", "open_stream_store", "main"]

BASELINE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "bench_baseline_cpu.json",
)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the headline measures the card: no CUDA device (pass "
                           "device='cpu' to run the kernels' twins on the CPU)")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seconds(fn, *args, iters: int, warmup: int, device: torch.device) -> float:
    """Median seconds of one call ``fn(*args)``: CUDA events around each
    call on the card (``time_cuda``), the host's clock on the CPU."""
    if device.type == "cuda":
        return time_cuda(fn, *args, warmup=warmup, iters=iters) / 1e3
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _model(cfg: ModelConfig, device):
    """The untrained service's weights: glorot from ``manual_seed(0)``."""
    return make_model(cfg, generator=torch.Generator().manual_seed(0), device=device).eval()


def measure_card(n_channels: int = 20, trace_dir: str | None = None,
                 sp: SpecParams = SpecParams(), device="cuda") -> float:
    """Spectrograms (channels) per second on one card, steady state: the
    flagship bf16 service ``make_enhance_shot_fn(ModelConfig(), sp)`` on
    ``example_shot(sp, n_channels)``, the traces on the card, timed on its
    prepared weights (the resident service), 20 calls after 3.

    Gated twice (BASELINE.md's quality gates), each failure a
    ``SystemExit``: the service's spectrogram of channel 0 against the
    SciPy recipe, SSIM >= 0.99; every channel's enhanced output against
    the float32 service (TF32 off, the caller's settings restored), SSIM
    >= 0.999.  ``trace_dir`` writes a torch.profiler trace of the timed
    calls there."""
    dev = _device(device)
    cfg = ModelConfig()  # flagship: depth-2, filters (32,32), k=3
    host_traces = example_shot(sp, n_channels)
    traces = torch.from_numpy(host_traces).to(dev)
    model = _model(cfg, dev)
    fn = make_enhance_shot_fn(cfg, sp, device=dev)

    specs, enhanced = fn(model, traces)
    golden, _, _ = spectrogram_ref(host_traces[0], sp)
    quality = ssim(specs[0].cpu().numpy(), golden)
    if quality < 0.99:
        raise SystemExit(f"quality gate failed: spectrogram SSIM {quality:.4f} < 0.99")
    print(f"# spectrogram SSIM vs CPU reference: {quality:.6f}", file=sys.stderr)

    with _fp32_matmul():
        fn32 = make_enhance_shot_fn(cfg, sp, dtype=None, device=dev)  # float32 golden service
        _, enhanced32 = fn32(model, traces)
    enhanced, enhanced32 = enhanced.cpu().numpy(), enhanced32.cpu().numpy()
    svc_quality = min(ssim(enhanced[c], enhanced32[c]) for c in range(n_channels))
    if svc_quality < 0.999:
        raise SystemExit(
            f"quality gate failed: enhanced-output SSIM {svc_quality:.5f} < 0.999 "
            "(bf16 service vs float32 service)"
        )
    print(f"# enhanced-output SSIM vs f32 service: {svc_quality:.6f}", file=sys.stderr)

    handle = fn.prepare(model)
    if trace_dir:
        from specenh_torch.utils.logging import profile_trace

        with profile_trace(trace_dir):
            sec = _seconds(fn, handle, traces, iters=20, warmup=3, device=dev)
        print(f"# profiler trace written to {trace_dir}", file=sys.stderr)
    else:
        sec = _seconds(fn, handle, traces, iters=20, warmup=3, device=dev)
    return n_channels / sec


def _epoch_seconds(epoch, state, x, y, bi, bm, iters: int, warmup: int, dev) -> float:
    """Median host-clock seconds of one synchronized epoch."""
    times = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        state, _ = epoch(state, x, y, bi, bm)
        _sync(dev)
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def measure_train(n: int = 7200, bs: int = 128, device="cuda") -> dict:
    """Training throughput on the reference recipe (60 % of 20 shots x 20
    channels x 30 tiles = 7200 train tiles, batch 128, Adam + BCE;
    hyperparam_scan.py:177-184): s/epoch and tiles/s of the flagship on
    float32 autograd, bf16 autograd and the training kernels (K5), 4
    epochs after 2, and of deep3 on float32 autograd and K7, 3 after 1.
    The tiles are drawn on the device from a seeded generator, labels
    clip(0.8 x + 0.1, 0, 1): the numbers do not depend on the data."""
    dev = _device(device)
    tc = TrainConfig()
    f, t = ModelConfig().input_shape[:2]
    x = torch.rand((n, f, t), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    y = (x * 0.8 + 0.1).clamp(0.0, 1.0)
    bi, bm = _epoch_batches(n, bs, np.random.default_rng(0).permutation(n))
    bi, bm = torch.from_numpy(bi).to(dev), torch.from_numpy(bm).to(dev)
    flagship, d3 = ModelConfig(), MODEL_PRESETS["deep3"]
    out = {}
    for name, dtype in [("f32", None), ("bf16", torch.bfloat16)]:
        state = create_state(flagship, tc, device=dev, dtype=dtype)
        out[name] = sec = _epoch_seconds(train_epoch, state, x, y, bi, bm, 4, 2, dev)
        print(f"# train epoch ({name}): {sec:.4f} s, {n / sec:.0f} tiles/s", file=sys.stderr)
    state = create_state(flagship, tc, device=dev)
    out["kernel"] = sec = _epoch_seconds(kernel_epoch_for(flagship, tc), state, x, y, bi, bm,
                                         4, 2, dev)
    print(f"# train epoch (kernel): {sec:.4f} s, {n / sec:.0f} tiles/s", file=sys.stderr)
    best = min(out.values())
    rec = {
        "train_s_per_epoch": round(best, 4),
        "train_tiles_per_sec": round(n / best, 1),
        "train_s_per_epoch_f32": round(out["f32"], 4),
        "train_s_per_epoch_bf16": round(out["bf16"], 4),
        "train_s_per_epoch_kernel": round(out["kernel"], 4),
    }
    # depth-3 family (deep3 preset, manual_scan_3layers.py:203-214)
    sec = _epoch_seconds(train_epoch, create_state(d3, tc, device=dev), x, y, bi, bm, 3, 1, dev)
    rec["train3_s_per_epoch_f32"] = round(sec, 4)
    print(f"# deep3 train epoch (f32): {sec:.4f} s", file=sys.stderr)
    sec = _epoch_seconds(kernel_epoch_for(d3, tc), create_state(d3, tc, device=dev), x, y,
                         bi, bm, 3, 1, dev)
    rec["train3_s_per_epoch_kernel"] = round(sec, 4)
    print(f"# deep3 train epoch (kernel): {sec:.4f} s", file=sys.stderr)
    return rec


def lowrank_batch(device, n: int, seed: int) -> torch.Tensor:
    """The headline's SVD batch (the JAX headline's draw, made with numpy):
    6 smooth modes x 3 plus 0.3 noise, (n, 256, 3905) float32, so the
    singular spectrum is spectrogram-like and Gavish-Donoho has something
    to find."""
    f_, t_, rank = 256, 3905, 6
    rng = np.random.default_rng(seed)
    ph_u, ph_v = rng.uniform(0, 6.28, (2, n, rank))
    amps = rng.uniform(0.5, 1.0, (n, rank))
    f = torch.linspace(0.0, 1.0, f_, device=device)[None, :, None]
    t = torch.linspace(0.0, 1.0, t_, device=device)[None, None, :]
    x = 0.3 * torch.from_numpy(rng.standard_normal((n, f_, t_), dtype=np.float32)).to(device)
    amps, ph_u, ph_v = (torch.from_numpy(a).float().to(device)[..., None, None]
                        for a in (amps, ph_u, ph_v))
    for k in range(rank):
        x += 3.0 * amps[:, k] * torch.sin(3.1 * (k + 1) * f + ph_u[:, k]) \
            * torch.cos(2.3 * (k + 1) * t + ph_v[:, k])
    return x


def gate_matrix(seed: int) -> np.ndarray:
    """A well-conditioned (256, 3905) float64 matrix, sigma_k = 100 x
    0.93^k: every component ``compute_signal`` keeps is well determined,
    so the gate fails only on a real numerics fault (on noisy data float32
    and float64 SVDs rotate within the degenerate noise subspace)."""
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((256, 256)))
    q2, _ = np.linalg.qr(rng.standard_normal((3905, 256)))
    return (q1 * (100.0 * 0.93 ** np.arange(256))) @ q2.T


def measure_svd(n_channels: int = 20, device="cuda") -> dict:
    """The SVD denoise slice (denoising_by_svd.ipynb cell 2): spectrograms/s
    of ``denoise_signal`` and ``compute_signal`` batched over
    ``n_channels`` reference-shaped channels (``lowrank_batch``), 24 calls
    after 2, gated (SSIM >= 0.99, else ``SystemExit``): ``denoise_signal``
    of channel 0 against ``svd_denoise_ref``, ``compute_signal`` of the
    well-conditioned ``gate_matrix`` against ``svd_compute_signal_ref``."""
    dev = _device(device)
    x = lowrank_batch(dev, n_channels, 7)
    x0 = x[0].cpu().numpy()

    den = denoise_signal(x[:1])[0].cpu().numpy()
    q = ssim(den, svd_denoise_ref(x0))
    if q < 0.99:
        raise SystemExit(f"quality gate failed: SVD denoise SSIM {q:.4f} < 0.99")
    print(f"# SVD denoise SSIM vs numpy reference: {q:.6f}", file=sys.stderr)

    xg = gate_matrix(11)
    csig = compute_signal(torch.from_numpy(xg).float().to(dev)[None])[0].cpu().numpy()
    q2 = ssim(csig, svd_compute_signal_ref(xg))
    if q2 < 0.99:
        raise SystemExit(f"quality gate failed: SVD compute_signal SSIM {q2:.4f} < 0.99")
    print(f"# SVD compute_signal SSIM vs numpy reference: {q2:.6f}", file=sys.stderr)

    rec = {}
    sec = _seconds(denoise_signal, x, iters=24, warmup=2, device=dev)
    rec["svd_specs_per_sec"] = round(n_channels / sec, 1)
    print(f"# svd denoise: {sec * 1e3 / n_channels:.2f} ms/spec, "
          f"{n_channels / sec:.0f} specs/s", file=sys.stderr)
    sec = _seconds(compute_signal, x, iters=24, warmup=2, device=dev)
    rec["svd_compute_specs_per_sec"] = round(n_channels / sec, 1)
    print(f"# svd compute_signal: {sec * 1e3 / n_channels:.2f} ms/spec, "
          f"{n_channels / sec:.0f} specs/s", file=sys.stderr)
    return rec


def measure_deep3_serving(n_channels: int = 20, sp: SpecParams = SpecParams(),
                          device="cuda") -> dict:
    """ms a shot of the deep3 preset's bf16 service on the depth-3 kernels
    (K8-in, K6, K8-out), on its prepared weights, 24 calls after 2."""
    dev = _device(device)
    cfg = MODEL_PRESETS["deep3"]
    traces = torch.from_numpy(example_shot(sp, n_channels)).to(dev)
    fn = make_enhance_shot_fn(cfg, sp, device=dev)
    sec = _seconds(fn, fn.prepare(_model(cfg, dev)), traces, iters=24, warmup=2, device=dev)
    print(f"# deep3 serving (depth-3 kernels): {sec * 1e3:.2f} ms/shot", file=sys.stderr)
    return {"serve3_ms_per_shot": round(sec * 1e3, 2)}


def measure_longshot(sp: SpecParams = SpecParams(cut_shot=4.0), device="cuda") -> dict:
    """ms of the composed long-shot service (time-sharded STFT -> label
    pipeline -> conv-AE kernels -> restitch) on a 4 s shot (2x the
    reference's cut), on a world of one ``("time",)`` mesh (NCCL on the
    card, gloo on the CPU), 48 calls after 2.  The process group it makes
    is destroyed before it returns."""
    dev = _device(device)
    cfg = ModelConfig()
    mesh = make_mesh(1, ("time",), device=dev)
    try:
        # n_samples, not SpecParams(cut_shot=t_use / fs): int(cut_shot * fs)
        # can lose a sample and break the divisibility check
        t_use = usable_samples_tiled(sp.n_samples, 1, sp)
        trace = torch.from_numpy(
            np.random.default_rng(0).standard_normal(t_use).astype(np.float32)).to(mesh.device)
        fn = make_sharded_enhance_shot(cfg, sp, mesh, n_samples=t_use)
        sec = _seconds(fn, fn.prepare(_model(cfg, mesh.device)), trace, iters=48, warmup=2,
                       device=mesh.device)
    finally:
        mesh.close()
    print(f"# composed long-shot ({sp.cut_shot:g} s, kernel AE stage): {sec * 1e3:.2f} ms",
          file=sys.stderr)
    return {"longshot4s_ms": round(sec * 1e3, 2)}


def synth_records(n_shots: int, n_channels: int = 20, seed: int = 0):
    """``scripts/synth_store.py``'s records, drawn in its order: (shot,
    channel, spec, label), spec uniform (256, 3905) float32, label
    clip(0.8 spec + 0.1, 0, 1)."""
    rng = np.random.default_rng(seed)
    for s in range(n_shots):
        for c in range(1, n_channels + 1):
            spec = rng.random((256, 3905), np.float32)
            lab = np.clip(spec * 0.8 + 0.1, 0.0, 1.0).astype(np.float32)
            yield str(100000 + s), c, spec, lab


def synth_store(path: str, n_shots: int, n_channels: int = 20, seed: int = 0) -> None:
    """``synth_records`` written through ``io.store.SpectrogramStore`` (h5py):
    the file ``scripts/synth_store.synth_store`` writes, byte for byte in
    its datasets.  Written beside ``path`` and renamed onto it when done."""
    from specenh_torch.io.store import SpectrogramStore

    part = path + ".part"
    f_ax, t_ax = np.arange(256, dtype=np.float64), np.arange(3905, dtype=np.float64)
    with SpectrogramStore(part, "w") as store:
        for shot, c, spec, lab in synth_records(n_shots, n_channels, seed):
            store.write_channel(shot, c, spec, f_ax, t_ax, lab)
    os.replace(part, path)


@contextlib.contextmanager
def open_stream_store(n_shots: int, n_channels: int = 20):
    """The streamed-read benchmark's store of ``synth_records``: where h5py
    imports, an HDF5 file in the temp directory (written on first use and
    kept), opened read-only; else a ``MemoryStore`` of the same arrays (the
    HDF5 read is then cut).  Yields (store, what it is)."""
    try:
        import h5py  # noqa: F401  (only whether it imports)
    except ImportError:
        x = np.empty((n_shots * n_channels, 256, 3905), np.float32)
        y = np.empty_like(x)
        for i, (_, _, spec, lab) in enumerate(synth_records(n_shots, n_channels)):
            x[i], y[i] = spec, lab
        yield MemoryStore(x, y, n_channels), "in memory (no h5py: the HDF5 read is cut)"
        return
    from specenh_torch.io.store import SpectrogramStore

    path = os.path.join(tempfile.gettempdir(),
                        f"specenh_torch_bench_stream_{n_shots}x{n_channels}.hdf5")
    if not os.path.exists(path):
        synth_store(path, n_shots, n_channels)
    with SpectrogramStore(path, "r") as store:
        yield store, f"HDF5 {path}"


def measure_stream_host(n_shots: int = 6, chunk_tiles: int = 4096,
                        n_channels: int = 20) -> dict:
    """The host side of the streamed-campaign pipeline: the store read and
    tile assembly (``train_stream._chunk_plans`` and ``_read_chunk``) of
    one epoch of canonical chunks, tiles/s and GB/s, the median of 3
    passes after a warm one (the page cache warm).  The store is
    ``open_stream_store``'s, named on stderr."""
    with open_stream_store(n_shots, n_channels) as (store, what):
        plan = plan_stream_split(store, num_samples=n_shots)
        plans = _chunk_plans(plan.train, chunk_tiles)
        ps = PatchSpec()

        def one_pass():
            t0 = time.perf_counter()
            nb = nt = 0
            for p in plans:
                x, y = _read_chunk(store, p, ps)
                nb += x.nbytes + y.nbytes
                nt += len(x)
            return nb, nt, time.perf_counter() - t0

        one_pass()
        runs = [one_pass() for _ in range(3)]
        nbytes, n_tiles, dt = sorted(runs, key=lambda r: r[2])[1]
    gbps = nbytes / dt / 2**30
    print(f"# stream host pipeline, store {what}: {n_tiles / dt:.0f} tiles/s, "
          f"{gbps:.2f} GB/s ({n_tiles} tiles, {nbytes / 2**30:.2f} GB); "
          f"reference 200-shot epoch = {120_000 * 0.6 / (n_tiles / dt):.1f} s "
          "host-side without the cache, ~0 with it", file=sys.stderr)
    return {
        "stream_host_tiles_per_sec": round(n_tiles / dt, 1),
        "stream_host_gbps": round(gbps, 3),
    }


def measure_cpu_baseline(n_channels: int = 4) -> float:
    """The reference CPU recipe: ``scipy.signal.spectrogram`` + Keras
    predict on the patched tiles, per channel (hyperparam_scan.py:217-236),
    in spectrograms/s.  TensorFlow is required: without it this exits
    (an STFT-only figure is not the reference recipe)."""
    try:
        os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
        from tensorflow.keras import layers
        from tensorflow.keras.models import Model
    except ImportError as e:
        raise SystemExit(f"the CPU baseline needs the reference recipe's Keras model, and "
                         f"tensorflow does not import ({e}); {BASELINE_CACHE} holds no "
                         "Keras-measured value to use instead") from e
    sp = SpecParams()
    rng = np.random.default_rng(0)
    t = np.arange(sp.n_samples) / sp.fs
    traces = [
        (np.sin(2 * np.pi * (5e4 + 2e4 * t) * t + k)
         + 0.5 * rng.standard_normal(t.size)).astype(np.float32)
        for k in range(n_channels)
    ]

    inp = layers.Input(shape=(256, 128, 1))
    x = layers.Conv2D(32, (3, 3), activation="relu", padding="same")(inp)
    x = layers.MaxPooling2D((2, 2), padding="same")(x)
    x = layers.Conv2D(32, (3, 3), activation="relu", padding="same")(x)
    x = layers.MaxPooling2D((2, 2), padding="same")(x)
    x = layers.Conv2DTranspose(32, (3, 3), strides=2, activation="relu", padding="same")(x)
    x = layers.Conv2DTranspose(32, (3, 3), strides=2, activation="relu", padding="same")(x)
    x = layers.Conv2D(1, (3, 3), activation="sigmoid", padding="same")(x)
    model = Model(inp, x)

    def one_channel(sig):
        s, _, _ = spectrogram_ref(sig, sp)
        tiles = np.stack([s[:, i * 128 : (i + 1) * 128] for i in range(30)])[..., None]
        model.predict(tiles, verbose=0)

    one_channel(traces[0])  # warm-up (TF graph build)
    t0 = time.perf_counter()
    for sig in traces:
        one_channel(sig)
    return n_channels / (time.perf_counter() - t0)


def get_cpu_baseline(recompute: bool = False) -> float:
    """The cached Keras-measured baseline of ``BASELINE_CACHE``; measured
    for this run (never written) where it is missing or STFT-only, or with
    ``recompute``."""
    if not recompute and os.path.exists(BASELINE_CACHE):
        with open(BASELINE_CACHE) as fh:
            cached = json.load(fh)
        if cached.get("keras_included", False):
            return cached["spectrograms_per_sec_cpu"]
        print(f"# {BASELINE_CACHE} holds an STFT-only baseline: measuring the reference "
              "recipe for this run", file=sys.stderr)
    return measure_cpu_baseline()


def main(trace_dir: str | None = None):
    recompute = "--recompute-baseline" in sys.argv
    cpu = get_cpu_baseline(recompute)
    card = measure_card(trace_dir=trace_dir)
    rec = {
        "metric": "spectrograms/sec/card (STFT + conv-AE denoise, full 2s shot)",
        "value": round(card, 2),
        "unit": "spectrograms/s",
        "vs_baseline": round(card / cpu, 2),
    }
    rec.update(measure_train())
    rec.update(measure_svd())
    rec.update(measure_deep3_serving())
    rec.update(measure_longshot())
    rec.update(measure_stream_host())
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
