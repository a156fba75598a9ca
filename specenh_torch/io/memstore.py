"""Spectrogram stores held in memory, with the read protocol of the
streamed trainer (``train_stream``: ``shots``, ``channels_of``,
``spec_shape``, ``read_column_slice``): where h5py is missing, as on the
card's machine, they stand in for ``io.store.SpectrogramStore``.

``MemoryStore`` holds (record, F, T) host arrays, one record a (shot,
channel), shot-major, the shots named as a store names them
(``ece_100000``, ``ece_100001``, ...).  ``TileStore`` reads its records
straight from (N, F, W) tile tensors where they lie (on the card too), a
record its tiles side by side, so processes that share the tiles through
CUDA IPC share one copy.
"""

from __future__ import annotations

import numpy as np

from specenh_torch.config import PatchSpec

__all__ = ["MemoryStore", "TileStore"]


class MemoryStore:
    """Records x[r], y[r] of (F, T) float32, record r = shot r // n_channels,
    channel r % n_channels + 1.  ``reads`` counts the column reads."""

    path = None  # no file: the tile cache's store identity is "None"

    def __init__(self, x: np.ndarray, y: np.ndarray, n_channels: int):
        if x.shape != y.shape or x.ndim != 3 or len(x) % n_channels:
            raise ValueError(f"records {x.shape} and labels {y.shape} are not whole shots "
                             f"of {n_channels} (F, T) channels")
        self.x, self.y = x, y
        self.n_channels = n_channels
        self._shots = [f"ece_{100000 + s}" for s in range(len(x) // n_channels)]
        self.reads = 0

    def shots(self):
        return list(self._shots)

    def channels_of(self, shot):
        return list(range(1, self.n_channels + 1))

    def iter_channels(self):
        return ((s, c) for s in self._shots for c in self.channels_of(s))

    def _record(self, shot, chn) -> int:
        return self._shots.index(shot) * self.n_channels + chn - 1

    def spec_shape(self, shot, chn):
        return self.x.shape[1:]

    def read_column_slice(self, shot, chn, lo, hi):
        self.reads += 1
        r = self._record(shot, chn)
        return self.x[r, :, lo:hi], self.y[r, :, lo:hi]


class TileStore(MemoryStore):
    """Records read from tile tensors: ``parts`` [(x, y), ...], each (N, F,
    W) with N a whole number of records of ``PatchSpec().tiles_per_spec``
    tiles, the records in order across the parts.  A read (whole tiles
    only) copies its columns to the host."""

    def __init__(self, parts, n_channels: int):
        self.k = PatchSpec().tiles_per_spec
        if any(len(x) % self.k for x, _ in parts):
            raise ValueError(f"TileStore: a part is not whole records of {self.k} tiles")
        self.parts = parts
        self.first = np.cumsum([0] + [len(x) // self.k for x, _ in parts])
        self.n_channels = n_channels
        self._shots = [f"ece_{100000 + s}" for s in range(self.first[-1] // n_channels)]
        self.reads = 0

    def spec_shape(self, shot, chn):
        x = self.parts[0][0]
        return (x.shape[1], self.k * x.shape[2])

    def read_column_slice(self, shot, chn, lo, hi):
        self.reads += 1
        r = self._record(shot, chn)
        i = int(np.searchsorted(self.first, r, side="right")) - 1
        w = self.parts[i][0].shape[2]
        if lo % w or hi % w:
            raise ValueError(f"TileStore: columns {lo}:{hi} cut a tile of {w}")
        t0 = (r - self.first[i]) * self.k
        return tuple(t[t0 + lo // w:t0 + hi // w].permute(1, 0, 2).reshape(t.shape[1], -1)
                     .cpu().numpy() for t in self.parts[i])
