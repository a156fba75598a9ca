"""Operations and bytes of the STFT front, from the shot's and the STFT's
shapes alone.

Per frame of n samples: the linear detrend and the window (~7 n), a real
FFT (2.5 n log2 n), and the PSD, its log and the running min/max (~6 per
one-sided bin).  Bytes: the float32 traces read once, the float32
spectrogram (Nyquist dropped) and each channel's min and max written once.
"""

from __future__ import annotations

import math
from typing import Dict


def n_frames(spec: Dict) -> int:
    n = int(spec["cut_shot"] * spec["fs"])
    hop = spec["nperseg"] - spec["noverlap"]
    return (n - spec["nperseg"]) // hop + 1


def flops(spec: Dict, n_channels: int) -> float:
    n = spec["nperseg"]
    nf = n // 2 + 1
    return n_channels * n_frames(spec) * (7 * n + 2.5 * n * math.log2(n) + 6 * nf)


def nbytes(spec: Dict, n_channels: int) -> float:
    n_samples = int(spec["cut_shot"] * spec["fs"])
    kept = spec["nperseg"] // 2
    return 4.0 * n_channels * (n_samples + kept * n_frames(spec) + 2)
