"""STFT spectrogram in plain PyTorch (the counterpart of ``specenh.ops.stft``).

Reference behaviour (spec_denoising/pipeline_data.py:28-36)::

    f, t, Sxx = scipy.signal.spectrogram(
        sig, nperseg=512, noverlap=256, fs=5e5, window='hamm',
        scaling='density', detrend='linear')
    Sxx = np.log(Sxx + 1e-11)
    Sxx = (Sxx - Sxx.min()) / (Sxx.max() - Sxx.min())
    Sxx = Sxx[:-1, :]                      # drop the Nyquist row

The transform is one float64 matmul of the framed signal with a basis built
once in float64 on the host: per-segment linear detrend (an orthogonal
projection) x periodic Hamming window x DFT, split into real and imaginary
parts; the PSD and its log stay float64 and are rounded to float32 once.
The basis helpers are copies of the JAX package's, so both packages use the
same float64 numbers.  The min-max normalization runs over all one-sided rows,
Nyquist included, and only then drops Nyquist: that is the reference quirk.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from specenh_torch.config import SpecParams

__all__ = [
    "hamming_periodic",
    "detrend_projection",
    "stft_basis",
    "psd_weights",
    "frame_signal",
    "stft_psd",
    "log_psd",
    "spectrogram",
    "spectrogram_freqs",
    "spectrogram_times",
]


def hamming_periodic(n: int) -> np.ndarray:
    """Periodic Hamming window, as scipy.signal.get_window('hamm', n)."""
    k = np.arange(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / n)


def detrend_projection(n: int, kind: str = "linear") -> np.ndarray:
    """Projection removing the per-segment trend (scipy.signal.detrend):
    ``linear`` is the orthogonal projection onto the complement of
    span{1, t}; ``constant`` removes the mean; ``none`` is the identity."""
    eye = np.eye(n, dtype=np.float64)
    if kind in ("none", "false", ""):
        return eye
    if kind == "constant":
        return eye - np.full((n, n), 1.0 / n)
    if kind == "linear":
        t = np.arange(n, dtype=np.float64)
        a = np.stack([t, np.ones(n)], axis=1)
        return eye - a @ np.linalg.solve(a.T @ a, a.T)
    raise ValueError(f"unknown detrend kind: {kind!r}")


def _window_np(name: str, n: int) -> np.ndarray:
    """Periodic (fftbins) window by name; matches scipy.signal.get_window."""
    if name in ("hamm", "hamming"):
        return hamming_periodic(n)
    if name in ("hann", "hanning"):
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    if name in ("boxcar", "rect", "rectangular"):
        return np.ones(n)
    import scipy.signal

    return np.asarray(scipy.signal.get_window(name, n))


@functools.lru_cache(maxsize=8)
def _basis_np(
    nperseg: int, detrend: str, fs: float, scaling: str, window: str = "hamm",
    onesided: bool = True,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """float64 (B_real, B_imag) of shape (nperseg, n_freqs) and the PSD
    scale: ``frames @ B`` is the detrended, windowed DFT of each frame."""
    w = _window_np(window, nperseg)
    p = detrend_projection(nperseg, detrend)
    n_freqs = nperseg // 2 + 1 if onesided else nperseg
    k = np.arange(n_freqs)[None, :]
    n = np.arange(nperseg)[:, None]
    angle = -2.0 * np.pi * k * n / nperseg
    pw = p @ np.diag(w)
    b_real = pw @ np.cos(angle)
    b_imag = pw @ np.sin(angle)
    if scaling == "density":
        scale = 1.0 / (fs * float(np.sum(w * w)))
    elif scaling == "spectrum":
        scale = 1.0 / float(np.sum(w)) ** 2
    else:
        raise ValueError(f"unknown scaling: {scaling!r}")
    return b_real, b_imag, scale


def psd_weights(sp: SpecParams) -> np.ndarray:
    """float64 one-sided PSD weights: the scale, doubled for every bin but
    DC and (for even nperseg) Nyquist, as SciPy does."""
    _, _, scale = _basis_np(sp.nperseg, sp.detrend, sp.fs, sp.scaling, sp.window)
    w = np.full(sp.n_freqs_onesided, 2.0 * scale)
    w[0] = scale
    if sp.nperseg % 2 == 0:
        w[-1] = scale
    return w


def stft_basis(sp: SpecParams, device=None, dtype=torch.float32):
    """(B_real, B_imag, one-sided weights) as tensors on ``device``."""
    b_real, b_imag, _ = _basis_np(sp.nperseg, sp.detrend, sp.fs, sp.scaling,
                                  sp.window)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return t(b_real), t(b_imag), t(psd_weights(sp))


def frame_signal(x: torch.Tensor, nperseg: int, hop: int) -> torch.Tensor:
    """(..., n) -> (..., n_frames, nperseg) overlapping frames (a view)."""
    return x.unfold(-1, nperseg, hop)


def _psd64(x: torch.Tensor, sp: SpecParams) -> torch.Tensor:
    """One-sided PSD in float64, (..., n_freqs_onesided, n_frames)."""
    frames = frame_signal(x[..., : sp.n_samples].double(), sp.nperseg, sp.hop)
    b_real, b_imag, weights = stft_basis(sp, x.device, torch.float64)
    zr = torch.matmul(frames, b_real)
    zi = torch.matmul(frames, b_imag)
    return ((zr * zr + zi * zi) * weights).transpose(-1, -2)


def stft_psd(x: torch.Tensor, sp: SpecParams) -> torch.Tensor:
    """One-sided PSD, (..., n_freqs_onesided, n_frames) float32, as
    scipy.signal.spectrogram(mode='psd') with ``sp``'s parameters: float64
    matmuls, rounded once, so the result does not depend on a BLAS's
    float32 blocking."""
    return _psd64(x, sp).float().contiguous()


def log_psd(x: torch.Tensor, sp: SpecParams) -> torch.Tensor:
    """log(PSD + eps), (..., n_freqs_onesided, n_frames) float32, from the
    float64 PSD and a float64 log, rounded once."""
    return torch.log(_psd64(x, sp) + sp.eps).float().contiguous()


def spectrogram(x: torch.Tensor, sp: SpecParams) -> torch.Tensor:
    """Reference log spectrogram in [0, 1]: (..., >= n_samples) traces ->
    (..., 256, 3905) at the reference geometry, min-max per leading index
    (per channel) over all one-sided rows, then the Nyquist row dropped."""
    sxx = log_psd(x, sp)
    mn = sxx.amin(dim=(-2, -1), keepdim=True)
    mx = sxx.amax(dim=(-2, -1), keepdim=True)
    return (sxx[..., : sp.n_freqs_kept, :] - mn) / (mx - mn)


def spectrogram_freqs(sp: SpecParams, drop_nyquist: bool = True) -> np.ndarray:
    """Frequency axis in Hz (pipeline_data.py:32,35)."""
    n = sp.n_freqs_kept if drop_nyquist else sp.n_freqs_onesided
    return np.arange(n) * sp.fs / sp.nperseg


def spectrogram_times(sp: SpecParams, n_samples: int | None = None) -> np.ndarray:
    """Segment-centre time axis in seconds, matching SciPy."""
    n = sp.n_samples if n_samples is None else n_samples
    return np.arange(sp.nperseg / 2, n - sp.nperseg / 2 + 1, sp.hop) / sp.fs
