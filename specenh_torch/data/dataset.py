"""Dataset assembly on the host (the counterpart of
``specenh.data.dataset``): tiles from spectrograms, the reference's
60/25/15 split by tile, the train/tune/test arrays from the HDF5 store, and
the synthetic raw campaign.

``assemble_from_store`` reproduces VAE/hyperparam_scan.py:126-149: sample N
shots, read ``spec`` and ``pipeline_out`` for their channels, ``patch`` into
(30 * N * C, 256, 128) tiles, split at 60 % / 85 %.  The reference splits
BY TILE after patching (hyperparam_scan.py:148-149), which leaks tiles of
one shot across the splits; that quirk is the default (``split_by="tile"``),
``split_by="shot"`` splits the shot list 60/25/15 before tiling
(dataset.ipynb cell 3).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from specenh_torch.config import PatchSpec, TrainConfig
from specenh_torch.data.tiles import n_tiles_for
from specenh_torch.io.store import SpectrogramStore

__all__ = ["SplitArrays", "assemble_from_store", "split_tiles", "synthetic_shot_batch"]


@dataclass
class SplitArrays:
    x_train: np.ndarray
    x_tune: np.ndarray
    x_test: np.ndarray
    y_train: np.ndarray
    y_tune: np.ndarray
    y_test: np.ndarray

    def reshaped(self):
        """All six arrays with the trailing channel axis added."""
        return SplitArrays(*[a[..., None] for a in (
            self.x_train, self.x_tune, self.x_test,
            self.y_train, self.y_tune, self.y_test,
        )])


def _patch_host(specs: np.ndarray, ps: PatchSpec = PatchSpec()) -> np.ndarray:
    """``tiles.patch`` in numpy: (N, F, T) or (F, T) -> (N * k, F, tile_time)."""
    specs = np.asarray(specs, np.float32)
    if specs.ndim == 2:
        specs = specs[None]
    n, f, t = specs.shape
    k = n_tiles_for(t, ps)
    used = specs[:, :, : k * ps.tile_time]
    out = used.reshape(n, f, k, ps.tile_time).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(out).reshape(n * k, f, ps.tile_time)


def split_tiles(x: np.ndarray, y: np.ndarray,
                fracs: Tuple[float, float] = (0.6, 0.85)) -> SplitArrays:
    """Split at int(len*0.6) / int(len*0.85) (hyperparam_scan.py:148-149)."""
    a, b = int(len(x) * fracs[0]), int(len(x) * fracs[1])
    return SplitArrays(x[:a], x[a:b], x[b:], y[:a], y[a:b], y[b:])


def assemble_from_store(
    store: SpectrogramStore,
    num_samples: int = 20,
    channels: Optional[Sequence[int]] = None,
    ps: PatchSpec = PatchSpec(),
    cfg: TrainConfig = TrainConfig(),
    seed: Optional[int] = None,
) -> SplitArrays:
    """Sample shots (``random.sample(file.keys(), n)``,
    hyperparam_scan.py:133), stack channels, patch, split, on the host.
    ``channels=None`` uses every channel of the first sampled shot; more
    samples than shots take them all, in a sampled order."""
    rng = random.Random(seed)
    keys = store.shots()
    keys = rng.sample(keys, min(num_samples, len(keys)))
    if channels is None:
        channels = store.channels_of(keys[0])
    spec_list, label_list = [], []
    for key in keys:
        s, l = store.read_spec_and_labels(key, channels)
        spec_list.append(s)
        label_list.append(l)

    if cfg.split_by == "shot":
        # every channel of a shot lands on the same side
        a = int(len(keys) * cfg.split_fracs[0])
        b = int(len(keys) * cfg.split_fracs[1])
        if a == 0 or b == a:
            raise ValueError(
                f"{len(keys)} shots are too few for a shot-level "
                f"{cfg.split_fracs} split (train or tune would be empty); "
                "sample more shots or use split_by='tile'"
            )

        def tiled(lst):
            if not lst:
                f = spec_list[0].shape[-2]
                return np.zeros((0, f, ps.tile_time), np.float32)
            return _patch_host(np.concatenate(lst, axis=0), ps)

        return SplitArrays(
            tiled(spec_list[:a]), tiled(spec_list[a:b]), tiled(spec_list[b:]),
            tiled(label_list[:a]), tiled(label_list[a:b]), tiled(label_list[b:]),
        )
    specs = np.concatenate(spec_list, axis=0)
    labels = np.concatenate(label_list, axis=0)
    return split_tiles(_patch_host(specs, ps), _patch_host(labels, ps), cfg.split_fracs)


def synthetic_shot_batch(n_shots: int = 2, n_channels: int = 4,
                         n_samples: int = 1_000_000, fs: float = 500_000.0,
                         seed: int = 0) -> np.ndarray:
    """Synthetic raw campaign (chirp + tone + noise per channel), shape
    (n_shots, n_channels, n_samples); chirp rate and tone vary per shot.
    The same numpy stream as the JAX package's, so the same numbers."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / fs
    shots = []
    for s in range(n_shots):
        chans = [
            np.sin(2 * np.pi * (4e4 + (1e4 * s + 2e4) * t) * t + c)
            + 0.3 * np.sin(2 * np.pi * (1.0e5 + 5e3 * c) * t)
            + 0.5 * rng.standard_normal(n_samples)
            for c in range(n_channels)
        ]
        shots.append(np.stack(chans))
    return np.asarray(shots, np.float32)
