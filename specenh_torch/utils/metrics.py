"""Image-quality metrics, SSIM and PSNR, in host-side NumPy: copies of
``specenh.utils.metrics``, held equal to them by
``tests/test_torch_guard.py``.

The reference has no quantitative metrics (its validation is visual);
these score the port against the references (SSIM >= 0.99 and the like).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ssim", "psnr"]


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with a size x size window over the last two axes
    ('valid' region only), via cumulative sums."""
    pad = np.cumsum(np.cumsum(x, axis=-2), axis=-1)
    pad = np.pad(pad, [(0, 0)] * (x.ndim - 2) + [(1, 0), (1, 0)])
    s = (
        pad[..., size:, size:]
        - pad[..., :-size, size:]
        - pad[..., size:, :-size]
        + pad[..., :-size, :-size]
    )
    return s / (size * size)


def ssim(
    a: np.ndarray,
    b: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean structural similarity (Wang et al. 2004), uniform window —
    matches skimage.metrics.structural_similarity defaults
    (win_size=7, gaussian_weights=False) with the given data_range."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _uniform_filter(a, win_size)
    mu_b = _uniform_filter(b, win_size)
    # sample (ddof=1) moments, as skimage uses
    n = win_size * win_size
    cov_norm = n / (n - 1)
    e_aa = _uniform_filter(a * a, win_size)
    e_bb = _uniform_filter(b * b, win_size)
    e_ab = _uniform_filter(a * b, win_size)
    var_a = cov_norm * (e_aa - mu_a * mu_a)
    var_b = cov_norm * (e_bb - mu_b * mu_b)
    cov = cov_norm * (e_ab - mu_a * mu_b)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))
