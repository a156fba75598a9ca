"""Host-side references of the port, in numpy, SciPy and OpenCV: the
reference spectrogram recipe, the label pipeline's stages, the SVD
denoiser's float64 recipes (denoising_by_svd.ipynb cell 1), the reference
recipe's wall clock (``time_reference_pipeline``), and SSIM from
``utils.metrics`` (the counterparts of ``specenh.bench.reference_cpu``
and ``specenh.utils.metrics.ssim``).

The label stages call OpenCV where it imports, as the reference scripts
do; without it the uint8 stages run a bit-exact emulation (integer Q8.8
Gaussian taps from the port's ``ops.enhance``, rect min/max windows).
``HAS_CV2`` says which ran.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import scipy.signal

try:
    import cv2

    HAS_CV2 = True
except Exception:  # pragma: no cover
    HAS_CV2 = False

from specenh_torch.config import PipelineConfig, SpecParams
from specenh_torch.utils.metrics import ssim

__all__ = ["spectrogram_ref", "rescale_ref", "quantfilt_ref", "gaussblr_ref",
           "meansub_ref", "morph_ref", "pipeline_ref", "pipeline_stages_ref",
           "svd_denoise_ref", "svd_compute_signal_ref", "time_reference_pipeline", "ssim",
           "HAS_CV2"]


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


def rescale_ref(x: np.ndarray) -> np.ndarray:
    """pipeline_data.py:43-44."""
    return (x - x.min()) / (x.max() - x.min())


def quantfilt_ref(x: np.ndarray, thr: float = 0.9) -> np.ndarray:
    """pipeline_data.py:46-49."""
    q = np.quantile(x, thr, axis=0)
    return np.where(x < q, 0, x)


def gaussblr_ref(x: np.ndarray, ksize: Tuple[int, int] = (31, 3)) -> np.ndarray:
    """pipeline_data.py:52-55 (uint8 quantise -> cv2.GaussianBlur -> rescale)."""
    u8 = (rescale_ref(x) * 255).astype("uint8")
    if HAS_CV2:
        out = cv2.GaussianBlur(u8, ksize, 0)
    else:  # bit-exact emulation (verified vs cv2 5.0)
        from specenh_torch.ops.enhance import opencv_gauss_kernel_q88

        kx = opencv_gauss_kernel_q88(ksize[0]).astype(np.int64)
        ky = opencv_gauss_kernel_q88(ksize[1]).astype(np.int64)
        ph, pv = len(kx) // 2, len(ky) // 2
        p = np.pad(u8.astype(np.int64), ((pv, pv), (ph, ph)), mode="reflect")
        h, w = u8.shape
        rows = sum(c * p[:, i : i + w] for i, c in enumerate(kx))
        acc = sum(c * rows[j : j + h, :] for j, c in enumerate(ky))
        out = np.clip((acc + (1 << 15)) >> 16, 0, 255).astype(np.uint8)
    return rescale_ref(out)


def meansub_ref(x: np.ndarray) -> np.ndarray:
    """pipeline_data.py:58-61."""
    mn = np.mean(x, axis=1)[:, np.newaxis]
    return rescale_ref(np.absolute(x - mn))


def _rect_minmax(x: np.ndarray, se_wh: Tuple[int, int], is_max: bool) -> np.ndarray:
    """OpenCV rect-SE dilate/erode fallback: window offsets [-d//2, d-1-d//2]."""
    w, h = se_wh
    pad_val = 0 if is_max else 255
    p = np.pad(
        x, ((h // 2, h - 1 - h // 2), (w // 2, w - 1 - w // 2)),
        constant_values=pad_val,
    )
    hh, ww = x.shape
    stack = [
        p[dy : dy + hh, dx : dx + ww] for dy in range(h) for dx in range(w)
    ]
    fn = np.maximum if is_max else np.minimum
    out = stack[0]
    for s in stack[1:]:
        out = fn(out, s)
    return out


def morph_ref(x: np.ndarray, cfg: PipelineConfig = PipelineConfig()) -> np.ndarray:
    """pipeline_data.py:64-72 (uint8; CLOSE 4x4 rect, OPEN 3x1 rect; rescale)."""
    u8 = (rescale_ref(x) * 255).astype("uint8")
    if HAS_CV2:
        se1 = cv2.getStructuringElement(cv2.MORPH_RECT, cfg.close_se)
        se2 = cv2.getStructuringElement(cv2.MORPH_RECT, cfg.open_se)
        mask = cv2.morphologyEx(u8, cv2.MORPH_CLOSE, se1)
        mask = cv2.morphologyEx(mask, cv2.MORPH_OPEN, se2)
    else:
        mask = _rect_minmax(_rect_minmax(u8, cfg.close_se, True), cfg.close_se, False)
        mask = _rect_minmax(_rect_minmax(mask, cfg.open_se, False), cfg.open_se, True)
    return rescale_ref(mask)


def pipeline_ref(spec: np.ndarray, cfg: PipelineConfig = PipelineConfig()) -> np.ndarray:
    """The composed 5-stage label pipeline (pipeline_data.py:101-110)."""
    x = quantfilt_ref(spec, cfg.quant_threshold)
    x = gaussblr_ref(x, cfg.gauss_ksize)
    x = meansub_ref(x)
    x = morph_ref(x, cfg)
    return meansub_ref(x)


def pipeline_stages_ref(spec: np.ndarray, cfg: PipelineConfig = PipelineConfig()) -> Dict[str, np.ndarray]:
    out = {}
    out["quant"] = quantfilt_ref(spec, cfg.quant_threshold)
    out["gauss"] = gaussblr_ref(out["quant"], cfg.gauss_ksize)
    out["mean"] = meansub_ref(out["gauss"])
    out["morph"] = morph_ref(out["mean"], cfg)
    out["final"] = meansub_ref(out["morph"])
    return out


def _omega_ref(beta: float) -> float:
    """denoising_by_svd.ipynb cell 1 (omega cubic fit)."""
    coef = [0.56, -0.95, 1.82, 1.43]
    return sum(c * beta ** (3 - n) for n, c in enumerate(coef))


def svd_denoise_ref(
    matrix: np.ndarray, start=None, stop=None, use_optimal: bool = False
) -> np.ndarray:
    """denoising_by_svd.ipynb cell 1, ``denoiseSignal`` — including the
    clamp-and-default quirks (start=1 by default: drop only sigma_0)."""
    u, s, vh = np.linalg.svd(matrix, full_matrices=False)
    if use_optimal:
        beta = np.min(matrix.shape) / np.max(matrix.shape)
        t_star = _omega_ref(beta) * np.median(s)
        num_sing = int((s > t_star).sum())
        start, stop = 0, num_sing - 1
    else:
        start = 1 if start is None else start
        stop = len(s) if stop is None else stop
    start = max(start, 0)
    stop = min(stop, len(s))
    return u[:, start:stop] @ np.diag(s[start:stop]) @ vh[start:stop, :]


def svd_compute_signal_ref(matrix: np.ndarray) -> np.ndarray:
    """denoising_by_svd.ipynb cell 1, ``computeSignal`` — keeps components
    1 .. 2*num_sing - 1 via accumulated rank-1 outer products."""
    u, s, vh = np.linalg.svd(matrix, full_matrices=False)
    beta = np.min(matrix.shape) / np.max(matrix.shape)
    t_star = _omega_ref(beta) * np.median(s)
    num_sing = int((s > t_star).sum())
    out = np.zeros_like(matrix, dtype=float)
    for idx in range(1, min(2 * num_sing, len(s))):
        out += s[idx] * np.outer(u[:, idx], vh[idx, :])
    return out


def time_reference_pipeline(
    signals: np.ndarray, sp: SpecParams, cfg: PipelineConfig, repeats: int = 1
) -> Dict[str, float]:
    """Wall-clock the reference CPU recipe: raw trace -> spectrogram ->
    5-stage pipeline, per channel.  Returns seconds/channel stats."""
    times = []
    for _ in range(repeats):
        for sig in np.atleast_2d(signals):
            t0 = time.perf_counter()
            s = spectrogram_ref(sig, sp)
            pipeline_ref(s, cfg)
            times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "sec_per_channel_mean": float(arr.mean()),
        "sec_per_channel_min": float(arr.min()),
        "channels_per_sec": float(1.0 / arr.mean()),
        "n_timed": int(arr.size),
    }
