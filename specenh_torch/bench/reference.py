"""Host-side references of the port, in numpy and SciPy: the reference
spectrogram recipe and SSIM (the counterparts of
``specenh.bench.reference_cpu.spectrogram_ref`` and
``specenh.utils.metrics.ssim``).
"""

from __future__ import annotations

import numpy as np
import scipy.signal

from specenh_torch.config import SpecParams

__all__ = ["spectrogram_ref", "ssim"]


def spectrogram_ref(sig: np.ndarray, sp: SpecParams) -> np.ndarray:
    """The reference ``specgr`` for one channel (pipeline_data.py:31-36):
    SciPy's spectrogram, log(+eps), min-max over all freqs, then the
    Nyquist row dropped: (256, n_frames)."""
    sig = np.asarray(sig)[: sp.n_samples]
    _, _, sxx = scipy.signal.spectrogram(
        sig, nperseg=sp.nperseg, noverlap=sp.noverlap, fs=sp.fs,
        window=sp.window, scaling=sp.scaling,
        detrend=sp.detrend if sp.detrend != "none" else False,
    )
    sxx = np.log(sxx + sp.eps)
    sxx = (sxx - sxx.min()) / (sxx.max() - sxx.min())
    return sxx[:-1, :]


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean over size x size windows of the last two axes ('valid' region
    only), via cumulative sums."""
    pad = np.cumsum(np.cumsum(x, axis=-2), axis=-1)
    pad = np.pad(pad, [(0, 0)] * (x.ndim - 2) + [(1, 0), (1, 0)])
    s = (pad[..., size:, size:] - pad[..., :-size, size:]
         - pad[..., size:, :-size] + pad[..., :-size, :-size])
    return s / (size * size)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM with a uniform window and sample (ddof=1) moments, as
    skimage's structural_similarity defaults."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _uniform_filter(a, win_size)
    mu_b = _uniform_filter(b, win_size)
    n = win_size * win_size
    cov_norm = n / (n - 1)
    var_a = cov_norm * (_uniform_filter(a * a, win_size) - mu_a * mu_a)
    var_b = cov_norm * (_uniform_filter(b * b, win_size) - mu_b * mu_b)
    cov = cov_norm * (_uniform_filter(a * b, win_size) - mu_a * mu_b)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))
