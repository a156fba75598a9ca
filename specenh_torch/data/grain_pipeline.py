"""Record-streaming tile pipeline over a ``SpectrogramStore`` (the
counterpart of ``specenh.data.grain_pipeline``): the unit of the streamed
split plan (``RecordSlice``) and the readers that feed
``train_stream.fit_streaming``.  Records (one (shot, channel) spectrogram
each) are read on demand, only the tile columns a slice needs
(``read_column_slice``), and tiled on the host with the pure-reshape
``patch`` of the resident path into NHWC float32 arrays.

The definitions are host numpy, copies of the JAX package's, held equal to
them by ``tests/test_torch_guard.py``.  The iterators follow the
Grain/tf.data source protocol (a deterministic order from an explicit
seed, record-level ``shard_index``/``shard_count``) without depending on
either library.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from specenh_torch.config import PatchSpec
from specenh_torch.data.tiles import n_tiles_for
from specenh_torch.io.store import SpectrogramStore

__all__ = [
    "RecordSlice",
    "channel_records",
    "iter_record_slices",
    "iter_tile_batches",
    "tile_dataset",
]


@dataclass(frozen=True)
class RecordSlice:
    """A contiguous run of tiles [lo, hi) within one (shot, channel) record.

    The streamed split plan (``train_stream.plan_stream_split``) expresses
    the reference's tile-index split boundaries as slices, so a boundary
    that falls mid-channel simply contributes one slice to each side —
    reproducing the leaky tile split exactly without materialising tiles.
    """

    shot: str
    chn: int
    lo: int
    hi: int

    @property
    def n_tiles(self) -> int:
        return self.hi - self.lo


def channel_records(
    store: SpectrogramStore, shots: Optional[Sequence[str]] = None
) -> List[Tuple[str, int]]:
    """Every (shot_group, channel) record in the store (or in ``shots``),
    in store order — the unit of streaming, sharding, and quarantine."""
    if shots is None:
        return list(store.iter_channels())
    return [(s, c) for s in shots for c in store.channels_of(s)]


def _patch_np(a: np.ndarray, ps: PatchSpec) -> np.ndarray:
    """Host-side ``tiles.patch`` for one (F, k*W) record: (k, F, W, 1)
    float32.  Bit-identical to the jnp ``patch`` (same reshape/transpose;
    tested), but pure numpy — the jax dispatch + extra copies cost ~19 ms
    per record vs 0.5 ms here (measured, round 4), which dominated the
    streamed epoch's host pipeline."""
    f, t = a.shape
    k = t // ps.tile_time
    a = np.asarray(a, np.float32)
    return np.ascontiguousarray(
        a.reshape(f, k, ps.tile_time).transpose(1, 0, 2)
    )[..., None]


def _read_slice_tiles(
    store: SpectrogramStore, s: RecordSlice, ps: PatchSpec
) -> Tuple[np.ndarray, np.ndarray]:
    """Tiles [lo, hi) of one record as two (k, F, W, 1) float32 arrays.

    Reads only columns [lo*W, hi*W) from HDF5 (step == tile_time, so tile i
    is exactly columns [i*W, (i+1)*W)); tiling the sliced columns with
    ``patch`` is bit-identical to slicing ``patch`` of the full record.
    """
    # read_column_slice goes through the store's shard-union resolution —
    # a record living in a writer-pool sidecar (<path>.shardK) is found
    # the same way iter_channels/spec_shape found it when planning
    x, y = store.read_column_slice(
        s.shot, s.chn, s.lo * ps.tile_time, s.hi * ps.tile_time
    )
    return _patch_np(x, ps), _patch_np(y, ps)


def iter_record_slices(
    store: SpectrogramStore,
    slices: Sequence[RecordSlice],
    ps: PatchSpec = PatchSpec(),
    order: Optional[np.ndarray] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (x, y) NHWC float32 tile arrays for each slice, in ``order``
    (a permutation of slice indices; None = given order).  This is the
    epoch-level record shuffle of the hierarchical shuffle scheme — tile
    order WITHIN a chunk is the consumer's job (``train_stream``)."""
    idx = range(len(slices)) if order is None else order
    for i in idx:
        yield _read_slice_tiles(store, slices[int(i)], ps)


def tile_dataset(
    store: SpectrogramStore,
    shots: Optional[Sequence[str]] = None,
    ps: PatchSpec = PatchSpec(),
    seed: Optional[int] = None,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream whole records as (x, y) tile arrays.

    ``shard_index``/``shard_count`` shard at RECORD granularity with the
    strided convention (record r goes to shard r % shard_count) so every
    host of a multi-host input pipeline sees a disjoint, near-equal subset
    without coordination.  ``seed`` shuffles the record order (after
    sharding, so shards stay disjoint across seeds).
    """
    records = channel_records(store, shots)[shard_index::shard_count]
    if seed is not None:
        rng = np.random.default_rng(seed)
        records = [records[i] for i in rng.permutation(len(records))]
    for shot, chn in records:
        k = n_tiles_for(store.spec_shape(shot, chn)[-1], ps)
        yield _read_slice_tiles(store, RecordSlice(shot, chn, 0, k), ps)


def iter_tile_batches(
    store: SpectrogramStore,
    batch_size: int,
    shots: Optional[Sequence[str]] = None,
    ps: PatchSpec = PatchSpec(),
    seed: Optional[int] = None,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Flatten the record stream into fixed-size (x, y) tile batches (the
    final batch may be short).  Tiles are shuffled within the rolling
    buffer of streamed records (the shuffle-window trade: full-dataset
    shuffles need full residency, which is what streaming avoids)."""
    rng = np.random.default_rng(seed) if seed is not None else None
    bx: List[np.ndarray] = []
    by: List[np.ndarray] = []
    n = 0
    for x, y in tile_dataset(store, shots, ps, seed, shard_index, shard_count):
        bx.append(x)
        by.append(y)
        n += len(x)
        while n >= batch_size:
            xs, ys = np.concatenate(bx), np.concatenate(by)
            if rng is not None:
                p = rng.permutation(len(xs))
                xs, ys = xs[p], ys[p]
            yield xs[:batch_size], ys[:batch_size]
            bx, by = [xs[batch_size:]], [ys[batch_size:]]
            n = len(bx[0])
    if n:
        yield np.concatenate(bx), np.concatenate(by)
