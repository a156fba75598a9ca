"""Dataset assembly on the host (the counterpart of
``specenh.data.dataset``): tiles from spectrograms, the reference's
60/25/15 split by tile, and the synthetic raw campaign.

The reference splits BY TILE after patching (VAE/hyperparam_scan.py:148-149),
which leaks tiles of one shot across the splits; ``split_tiles`` keeps that
quirk.  Reading the HDF5 store (``assemble_from_store``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from specenh_torch.config import PatchSpec
from specenh_torch.data.tiles import n_tiles_for

__all__ = ["SplitArrays", "split_tiles", "synthetic_shot_batch"]


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
