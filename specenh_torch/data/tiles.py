"""Spectrogram <-> tile conversion (the counterpart of ``specenh.data.tiles``).

Reference semantics (VAE/hyperparam_scan.py:30-56): each (256, 3905)
spectrogram becomes 30 tiles of (256, 128), tile x of spectrogram i at index
x + 30 * i; the trailing columns 3840..3904 are dropped.  ``unpatch`` is the
inverse on the kept columns.
"""

from __future__ import annotations

import torch

from specenh.config import PatchSpec

__all__ = ["n_tiles_for", "patch", "unpatch"]


def n_tiles_for(time_cols: int, ps: PatchSpec = PatchSpec()) -> int:
    """Tiles per spectrogram for a width: ``(T - tile) // step + 1``."""
    return (time_cols - ps.tile_time) // ps.step + 1


def patch(specs: torch.Tensor, ps: PatchSpec = PatchSpec()) -> torch.Tensor:
    """(N, F, T) or (F, T) -> (N * k, F, tile_time), k = n_tiles_for(T)."""
    if specs.ndim == 2:
        specs = specs[None]
    if ps.step != ps.tile_time:
        raise NotImplementedError("overlapping tiles not supported")
    n, f, t = specs.shape
    k = n_tiles_for(t, ps)
    tiles = specs[:, :, : k * ps.tile_time].reshape(n, f, k, ps.tile_time)
    return tiles.permute(0, 2, 1, 3).reshape(n * k, f, ps.tile_time)


def unpatch(tiles: torch.Tensor, ps: PatchSpec = PatchSpec(),
            tiles_per_spec: int | None = None) -> torch.Tensor:
    """(k * N, F, w) tiles -> (N, F, k * w) spectrograms; ``k`` defaults to
    the reference's 30."""
    k = ps.tiles_per_spec if tiles_per_spec is None else tiles_per_spec
    m, f, w = tiles.shape
    n = m // k
    grouped = tiles[: n * k].reshape(n, k, f, w)
    return grouped.permute(0, 2, 1, 3).reshape(n, f, k * w)
