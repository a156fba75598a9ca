"""``RecordSlice``, the unit of the streamed split plan
(``train_stream.plan_stream_split``): a copy of the JAX package's
dataclass, held equal to it by ``tests/test_torch_guard.py``.  The record
readers that stream a store's tiles come with the streamed trainer.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RecordSlice"]


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
