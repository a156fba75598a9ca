"""Dataset-build campaign: raw shots -> spectrograms + pipeline labels -> HDF5
(the counterpart of ``specenh.pipeline``).

``python spec_denoising/pipeline_data.py`` of the reference loops over
channels in numpy, SciPy and OpenCV; here each shot's channels go through
the device as one batch: the STFT (K1, ``stft_fused.spectrogram_fused``, on
the card) and the classical label pipeline (``ops.enhance``, eager torch),
while pickle reads and HDF5 writes stay on the host.  Corrupt shots are
quarantined (pipeline_data.py:118-122) and recorded in a resumable
manifest; a store quarantined as truncated retires its manifest with it.
The campaign runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Optional, Sequence

import torch

from specenh_torch.config import Config
from specenh_torch.io.shots import ShotReadError, read_ece_channels, shot_number_from_path
from specenh_torch.io.store import CampaignManifest, SpectrogramStore, retire_stale_manifest
from specenh_torch.ops import stft_fused
from specenh_torch.ops.enhance import classical_pipeline
from specenh_torch.ops.stft import spectrogram, spectrogram_freqs, spectrogram_times

__all__ = ["build_dataset", "build_dataset_streaming", "process_shot_fn"]


def process_shot_fn(cfg: Config, device="cuda") -> Callable:
    """``fn(traces) -> (specs, labels)``, the device half of the campaign:
    (C, >= n_samples) float32 traces (numpy or a tensor) -> (C, 256,
    n_frames) spectrograms and their labels, both on ``device``.  The STFT
    is K1 (``spectrogram_fused``) for the geometry it supports
    (``stft_fused.supported``), else the matmul front (``ops.stft``), as
    the service's "auto" front; then ``classical_pipeline``.  A CUDA
    ``device`` without a card raises: there is no CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("process_shot_fn: no CUDA device (pass device='cpu' "
                           "to build on the CPU)")
    front = stft_fused.spectrogram_fused if stft_fused.supported(cfg.spec) else spectrogram

    def fn(traces):
        x = torch.as_tensor(traces, dtype=torch.float32).to(device).contiguous()
        with torch.no_grad():
            specs = front(x, cfg.spec)
            return specs, classical_pipeline(specs, cfg.pipeline)

    return fn


def build_dataset(
    cfg: Config,
    shot_files: Optional[Sequence[str]] = None,
    channels: Optional[Sequence[int]] = None,
    store_path: Optional[str] = None,
    manifest_path: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Run the campaign over ECE pickles (channels 1..20 by default).
    Returns the counts {"done", "skipped", "failed"}.

    Resumable: shots present in the manifest are skipped — completed ones
    and quarantined failures alike (delete a failure's line from the
    manifest JSONL to force a retry) — and HDF5 writes are idempotent, so
    a crashed run continues where it stopped.
    """
    shot_files = (
        sorted(glob.glob(os.path.join(cfg.paths.data_dir, "*.pkl")))
        if shot_files is None
        else list(shot_files)
    )
    channels = list(channels) if channels is not None else list(range(1, 21))
    store_path = store_path or cfg.paths.dataset_file
    manifest_path = manifest_path or store_path + ".manifest.jsonl"

    fn = process_shot_fn(cfg, device)
    f_axis = spectrogram_freqs(cfg.spec)
    t_axis = spectrogram_times(cfg.spec)
    done = skipped = failed = 0

    with SpectrogramStore(store_path) as store:
        retire_stale_manifest(store, manifest_path)
        manifest = CampaignManifest(manifest_path)
        for fname in shot_files:
            shot = shot_number_from_path(fname)
            if manifest.is_done(shot) or shot in manifest.failed_shots:
                skipped += 1
                continue
            try:
                traces = read_ece_channels(fname, channels, cfg.spec.n_samples)
            except ShotReadError as e:
                manifest.mark_failed(shot, str(e))
                failed += 1
                if verbose:
                    print(f"quarantined {shot}: {e}")
                continue
            specs, labels = fn(traces)
            specs = specs.cpu().numpy()
            labels = labels.cpu().numpy()
            for i, chn in enumerate(channels):
                store.write_channel(shot, chn, specs[i], f_axis, t_axis, labels[i])
            store.flush()
            manifest.mark_done(shot)
            done += 1
            if verbose:
                print(f"shot {shot}: {len(channels)} channels written")
    manifest.close()
    return {"done": done, "skipped": skipped, "failed": failed}


def build_dataset_streaming(
    cfg: Config,
    bin_files: Sequence[str],
    n_channels: int,
    store_path: Optional[str] = None,
    manifest_path: Optional[str] = None,
    n_threads: int = 4,
    writers: int = 1,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Campaign over SPEC binary shots: the native prefetcher reads and
    decodes in C++ worker threads (``io.native``; a synchronous Python read
    without it), the device computes the current shot, and WRITER threads
    copy results to the host and persist them — the three stages overlap.

    ``writers > 1`` shards the HDF5 persist over that many files
    (``io.store.StoreWriterPool``): HDF5 serializes writers per file.
    Readers see one union store."""
    import threading

    from specenh_torch.io.native import NativePrefetcher
    from specenh_torch.io.store import StoreWriterPool

    store_path = store_path or cfg.paths.dataset_file
    manifest_path = manifest_path or store_path + ".manifest.jsonl"
    fn = process_shot_fn(cfg, device)
    f_axis = spectrogram_freqs(cfg.spec)
    t_axis = spectrogram_times(cfg.spec)

    bin_files = list(bin_files)
    pool = StoreWriterPool(store_path, writers)
    retire_stale_manifest(pool, manifest_path)
    manifest = CampaignManifest(manifest_path)
    pending = [
        p for p in bin_files
        if not manifest.is_done(shot_number_from_path(p))
        and shot_number_from_path(p) not in manifest.failed_shots
    ]
    skipped = len(bin_files) - len(pending)
    counts = {"done": 0, "failed": 0}
    io_lock = threading.Lock()  # manifest + counts + prints

    def persist(own_store, item):
        shot, (specs, labels) = item
        try:
            # the device -> host copy happens HERE, off the dispatch path
            specs = specs.cpu().numpy()
            labels = labels.cpu().numpy()
            for i in range(specs.shape[0]):
                own_store.write_channel(
                    shot, i + 1, specs[i], f_axis, t_axis, labels[i]
                )
            own_store.flush()
            with io_lock:
                manifest.mark_done(shot)
                counts["done"] += 1
                if verbose:
                    print(f"shot {shot}: {specs.shape[0]} channels written")
        except Exception as e:  # persist failure: quarantine, continue
            # a failure while RECORDING the failure escapes to the pool's
            # dead-writer drain (keeps the dispatch loop unblocked)
            with io_lock:
                manifest.mark_failed(shot, f"persist: {e}")
                counts["failed"] += 1
                if verbose:
                    print(f"persist failed for {shot}: {e}")

    pool.start(persist)
    with pool:
        try:
            with NativePrefetcher(
                pending, n_channels, cfg.spec.n_samples, n_threads=n_threads
            ) as pf:
                for idx, traces in pf:
                    if traces is None:
                        # the prefetcher reports the shot index even on
                        # failure: quarantine the file so resumes skip it
                        bad = shot_number_from_path(pending[idx])
                        with io_lock:
                            manifest.mark_failed(bad, "unreadable SPEC binary")
                            counts["failed"] += 1
                            if verbose:
                                print(f"shot {bad}: read failed, quarantined")
                        continue
                    shot = shot_number_from_path(pending[idx])
                    pool.submit(shot, (shot, fn(traces)))  # launches queued on the card
        finally:
            # writers must retire BEFORE the pool's h5py files close
            pool.join()
    manifest.close()
    pool.raise_if_failed()
    return {"done": counts["done"], "skipped": skipped, "failed": counts["failed"]}
