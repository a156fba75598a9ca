"""Flat binary shot format ('SPEC' v1) — the campaign fast path (a copy of
``specenh.io.binfmt``, the same format).

Layout (little-endian):

    uint32 magic 'SPEC' | uint32 version=1 | uint32 n_channels |
    uint32 reserved | uint64 n_samples | float32 data[n_channels][n_samples]

Written once from the pickle shots (``convert_ece_pickle``); the native
reader/prefetcher (native/specenh_native.cc via specenh_torch.io.native) then
streams it with mmap + worker threads — replacing the reference's
pickle.load-per-channel-access hot loop (pipeline_data.py:29).
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

__all__ = ["write_shot_bin", "read_shot_bin", "convert_ece_pickle", "MAGIC"]

MAGIC = 0x43455053  # 'SPEC'
_HEADER = struct.Struct("<IIIIQ")


def write_shot_bin(path: str, traces: np.ndarray) -> None:
    """traces: (n_channels, n_samples) float32, channel-major."""
    traces = np.ascontiguousarray(traces, dtype=np.float32)
    if traces.ndim != 2:
        raise ValueError("traces must be (n_channels, n_samples)")
    with open(path, "wb") as fh:
        fh.write(_HEADER.pack(MAGIC, 1, traces.shape[0], 0, traces.shape[1]))
        fh.write(traces.tobytes())


def read_shot_bin(path: str) -> np.ndarray:
    """Pure-Python reader (fallback / verification vs the native one)."""
    with open(path, "rb") as fh:
        magic, version, n_ch, _, n_s = _HEADER.unpack(fh.read(_HEADER.size))
        if magic != MAGIC or version != 1:
            raise ValueError(f"{path}: not a SPEC v1 shot file")
        data = np.frombuffer(fh.read(n_ch * n_s * 4), dtype=np.float32)
    return data.reshape(n_ch, n_s).copy()


def convert_ece_pickle(
    pkl_path: str, bin_path: str, channels: Sequence[int]
) -> np.ndarray:
    """pickle shot -> SPEC binary (channels are 1-based reference numbering)."""
    from specenh_torch.io.shots import read_ece_channels

    traces = read_ece_channels(pkl_path, channels)
    write_shot_bin(bin_path, traces)
    return traces
