"""Cross-power spectrogram of two interferometer chords (the counterpart of
``specenh.ops.crosspower``).

The reference calls ``ampsp, freq, time = ae_co2(sig1, sig2, t)``
(interferometer/crosspowerspec.py:39) from the site-local ``co2_deps``
module, which is not in the repository; its contract is reconstructed from
the call and the plot (crosspowerspec.py:42-50): ``ampsp`` is plotted as
``log(ampsp).T`` with time on x and frequency on y, so it is (time, freq)
and strictly positive; frequency in kHz, time in ms, ``t`` the raw time
base in seconds.

The transform is the framed matmul of ``ops.stft`` (the detrended, windowed
DFT basis), in float32 with TF32 off, then the cross power
``|X1 * conj(X2)|``, which keeps only the structure coherent between the
chords.  It runs on the signals' device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from specenh_torch.config import SpecParams
from specenh_torch.ops.stft import frame_signal, stft_basis
from specenh_torch.ops.svd import _fp32_matmul

__all__ = ["cross_power", "ae_co2"]


def cross_power(sig1: torch.Tensor, sig2: torch.Tensor, sp: SpecParams,
                dtype=torch.float32) -> torch.Tensor:
    """|X1 * conj(X2)| cross-power spectrogram.

    Returns shape (..., n_frames, n_freqs_onesided): (time, freq) order, to
    match the ``ampsp`` contract.  Uses sp's window, detrend and density
    scaling, so ``cross_power(x, x, sp)`` equals the PSD spectrogram
    transposed.
    """
    b_real, b_imag, weights = stft_basis(sp, sig1.device, dtype)
    f1 = frame_signal(sig1.to(dtype), sp.nperseg, sp.hop)
    f2 = frame_signal(sig2.to(dtype), sp.nperseg, sp.hop)
    with _fp32_matmul():
        r1, i1 = f1 @ b_real, f1 @ b_imag
        r2, i2 = f2 @ b_real, f2 @ b_imag
    # X1 * conj(X2) = (r1 r2 + i1 i2) + i (i1 r2 - r1 i2)
    re = r1 * r2 + i1 * i2
    im = i1 * r2 - r1 * i2
    return torch.sqrt(re * re + im * im) * weights


def ae_co2(
    sig1: torch.Tensor,
    sig2: torch.Tensor,
    t: np.ndarray,
    nperseg: int = 1024,
    noverlap: int | None = None,
) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Drop-in reconstruction of the missing ``co2_deps.ae_co2``.

    Returns ``(ampsp, freq, time)`` with ampsp (n_frames, n_freqs) on the
    signals' device, freq in kHz and time in ms (float64 numpy), the units
    crosspowerspec.py:42-50 plots.  A floor of float32's smallest normal
    keeps ``log(ampsp)`` finite, since the reference logs it at once.
    """
    t = np.asarray(t)
    dt = float(np.median(np.diff(t)))
    fs = 1.0 / dt
    if noverlap is None:
        noverlap = nperseg // 2
    sp = SpecParams(
        nperseg=nperseg,
        noverlap=noverlap,
        fs=fs,
        detrend="linear",
        scaling="density",
        cut_shot=len(t) * dt,
    )
    n = min(sig1.shape[-1], sig2.shape[-1], len(t))
    n_frames = (n - nperseg) // sp.hop + 1
    ampsp = cross_power(sig1[..., :n], sig2[..., :n], sp)
    ampsp = torch.clamp(ampsp, min=torch.finfo(torch.float32).tiny)
    freq = np.arange(sp.n_freqs_onesided) * fs / nperseg / 1e3  # kHz
    centers = (np.arange(n_frames) * sp.hop + nperseg / 2) * dt
    time = (t[0] + centers) * 1e3  # ms
    return ampsp, freq, time
