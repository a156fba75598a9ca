"""Host-streamed training, its planning half (the counterpart of the split
planning in ``specenh.train_stream``).

The reference's largest recipe trains on 200 shots (VAE/manual_scan.py:
137-156): 120 000 tiles, ~15.7 GB per float32 tile tensor, ~31 GB for
(x, y).  Whether a campaign can train resident or must stream is decided
from the store's METADATA alone: ``plan_stream_split`` places the
reference's split boundaries on record slices without reading a tile, and
``estimate_resident_bytes`` is what the resident path would hold on the
device.  The streamed fit itself (``fit_streaming``, its chunk readers and
caches) is not ported yet.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

from specenh_torch.config import PatchSpec, TrainConfig
from specenh_torch.data.grain_pipeline import RecordSlice
from specenh_torch.data.tiles import n_tiles_for
from specenh_torch.io.store import SpectrogramStore

__all__ = ["StreamPlan", "plan_stream_split", "estimate_resident_bytes"]


class StreamPlan:
    """Per-split record slices of a streamed campaign."""

    def __init__(self, train: List[RecordSlice], tune: List[RecordSlice],
                 test: List[RecordSlice], tile_shape: Tuple[int, int]):
        self.train = train
        self.tune = tune
        self.test = test
        self.tile_shape = tile_shape  # (F, W)

    def n_tiles(self, split: str) -> int:
        return sum(s.n_tiles for s in getattr(self, split))


def plan_stream_split(
    store: SpectrogramStore,
    num_samples: int = 20,
    channels: Optional[Sequence[int]] = None,
    ps: PatchSpec = PatchSpec(),
    cfg: TrainConfig = TrainConfig(),
    seed: Optional[int] = None,
) -> StreamPlan:
    """``data.dataset.assemble_from_store`` as record slices: the same
    sampled shots (``random.Random(seed).sample``, hyperparam_scan.py:133)
    and the same split boundaries, read from the store's metadata only.

    ``split_by='tile'`` puts the reference's int(n*0.6) / int(n*0.85)
    boundaries on the global tile index (a boundary inside a channel gives
    a slice to each side: the reference's leaky split); ``split_by='shot'``
    splits the sampled shot list first (dataset.ipynb cell 3)."""
    rng = random.Random(seed)
    keys = rng.sample(store.shots(), min(num_samples, len(store.shots())))
    if channels is None:
        channels = store.channels_of(keys[0])

    def k_of(shot: str, chn: int) -> int:
        return n_tiles_for(store.spec_shape(shot, chn)[-1], ps)

    tile_shape = (store.spec_shape(keys[0], channels[0])[0], ps.tile_time)

    if cfg.split_by == "shot":
        a = int(len(keys) * cfg.split_fracs[0])
        b = int(len(keys) * cfg.split_fracs[1])
        if a == 0 or b == a:
            raise ValueError(
                f"{len(keys)} shots are too few for a shot-level "
                f"{cfg.split_fracs} split; sample more shots or use "
                "split_by='tile'"
            )

        def whole(shot_keys):
            return [RecordSlice(s, c, 0, k_of(s, c)) for s in shot_keys for c in channels]

        return StreamPlan(whole(keys[:a]), whole(keys[a:b]), whole(keys[b:]), tile_shape)

    records = [(s, c, k_of(s, c)) for s in keys for c in channels]
    n = sum(k for _, _, k in records)
    a, b = int(n * cfg.split_fracs[0]), int(n * cfg.split_fracs[1])
    splits: List[List[RecordSlice]] = [[], [], []]
    bounds = [(0, a), (a, b), (b, n)]
    g = 0
    for shot, chn, k in records:
        for si, (lo_b, hi_b) in enumerate(bounds):
            lo = max(lo_b, g) - g
            hi = min(hi_b, g + k) - g
            if hi > lo:
                splits[si].append(RecordSlice(shot, chn, lo, hi))
        g += k
    return StreamPlan(*splits, tile_shape=tile_shape)


def estimate_resident_bytes(n_tiles: int, ps: PatchSpec = PatchSpec()) -> int:
    """Device bytes of the resident fit's (x, y) float32 tile tensors."""
    return 2 * 4 * n_tiles * ps.tile_freq * ps.tile_time
