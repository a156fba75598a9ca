"""The classical label pipeline in plain PyTorch (the counterpart of
``specenh.ops.enhance``).

The reference's image-processing recipe (spec_denoising/pipeline_data.py:38-72,
composed at :100-110)::

    quantfilt -> gaussblr(31,3) -> meansub -> morph -> meansub

as plain functions on tensors over the trailing (freq, time) axes, batched
over any leading axes (channels, shots), on the input's device.  No kernel
of the JAX package lives here: every op is a short sequence of eager torch
ops, so nothing contracts to a fused multiply-add and each op rounds as
written.

Bit-faithfulness (the same as the JAX package's, and against OpenCV):

- The quantile follows NumPy's float64 ``_lerp`` (its ``t >= 0.5`` rewrite
  ``b - diff*(1-t)`` included): the order statistics come from a float32
  sort (exact) and the interpolation and the ``<`` comparison are float64.
- uint8 points are ``floor(rescale(x) * 255)`` in float32, ``rescale`` a
  true division.
- The Gaussian is OpenCV's bit-exact CV_8U path: Q8.8 taps (baked tables),
  time taps then frequency taps, reflect-101 border, Q16.16 accumulation
  (exact in float32: at most 255*256*256 < 2^24) and a half-up rounding.
- Morphology reduces a WxH rect over source offsets ``[-d//2, d-1-d//2]``
  per axis, the border ignored (-inf padding to dilate, +inf to erode).
- The bilateral filter is OpenCV's CV_8UC1 arithmetic, its fused
  multiply-add emulated exactly (Veltkamp split and two_sum).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from specenh_torch.config import PipelineConfig

__all__ = [
    "rescale",
    "normalize",
    "quantile_filter",
    "to_uint8",
    "gaussian_blur_u8",
    "gaussian_blur",
    "mean_subtract",
    "dilate",
    "erode",
    "morph_close",
    "morph_open",
    "morph",
    "bilateral",
    "bilateral_u8",
    "classical_pipeline",
    "pipeline_stages",
    "opencv_gauss_kernel_q88",
]


def rescale(x: torch.Tensor, axes: Tuple[int, ...] = (-2, -1)) -> torch.Tensor:
    """Global min-max to [0, 1] over ``axes`` (pipeline_data.py:43-44)."""
    mn = x.amin(dim=axes, keepdim=True)
    mx = x.amax(dim=axes, keepdim=True)
    return (x - mn) / (mx - mn)


def normalize(x: torch.Tensor, axes: Tuple[int, ...] = (-2, -1)) -> torch.Tensor:
    """Zero-mean / unit-std (population std; ``norm``, pipeline_data.py:38-41)."""
    mn = x.mean(dim=axes, keepdim=True)
    sd = x.std(dim=axes, keepdim=True, correction=0)
    return (x - mn) / sd


def quantile_filter(x: torch.Tensor, thr: float = 0.9) -> torch.Tensor:
    """Zero the values below the per-time-column ``thr``-quantile over the
    frequency axis (``quantfilt``, pipeline_data.py:46-49: np.quantile
    along axis 0, linear interpolation).

    The k-th and (k+1)-th order statistics come from a float32 sort along
    the frequency axis; the interpolation runs in float64 as NumPy's
    ``_lerp`` does, ``b - diff*(1-t)`` for ``t >= 0.5``, and the comparison
    is ``x < q`` in float64.  ``virtual``, ``k`` and ``gamma`` are the host
    float64 numbers NumPy computes.
    """
    f = x.shape[-2]
    virtual = (f - 1) * float(thr)
    k = min(int(np.floor(virtual)), f - 1)
    gamma = virtual - k
    v = torch.sort(x, dim=-2).values
    a = v.narrow(-2, k, 1).double()
    b = v.narrow(-2, min(k + 1, f - 1), 1).double()
    diff = b - a
    q = b - diff * (1.0 - gamma) if gamma >= 0.5 else a + diff * gamma
    return torch.where(x.double() < q, torch.zeros((), dtype=x.dtype, device=x.device), x)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """``(rescale(x) * 255).astype(uint8)`` (pipeline_data.py:53,65) with
    NumPy's truncation, held as float32 exact integers in [0, 255]."""
    return torch.floor(rescale(x) * 255.0)


def mean_subtract(x: torch.Tensor) -> torch.Tensor:
    """|x - per-freq-row time-mean|, then min-max rescale (``meansub``,
    pipeline_data.py:58-61).  The mean is a float64 sum over the time
    axis divided in float64 and rounded to float32 once, so it is the same
    number whatever the device and its reduction order."""
    mn = x.double().mean(dim=-1, keepdim=True).to(x.dtype)
    return rescale((x - mn).abs())


# ---------------------------------------------------------------------------
# OpenCV-exact Gaussian blur
# ---------------------------------------------------------------------------

# Q8.8 fixed-point taps of OpenCV's bit-exact CV_8U Gaussian for ksize=31,
# sigma=0 (auto sigma = 5.0), with OpenCV's error diffusion (hence not
# monotonic at taps +-13/14): the JAX package's baked table, probed from cv2.
_CV_KX31_Q88 = (
    0, 1, 0, 1, 2, 3, 4, 6, 7, 10, 13, 15, 17, 19, 20,
    20,
    20, 19, 17, 15, 13, 10, 7, 6, 4, 3, 2, 1, 0, 1, 0,
)
# ksize=3, sigma=0 -> OpenCV's fixed small kernel [0.25, 0.5, 0.25].
_CV_K3_Q88 = (64, 128, 64)

_Q88_TABLE = {31: _CV_KX31_Q88, 3: _CV_K3_Q88}


def opencv_auto_sigma(ksize: int) -> float:
    """OpenCV's sigma-from-ksize formula: 0.3*((k-1)/2 - 1) + 0.8."""
    return 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8


def opencv_gauss_kernel_q88(ksize: int) -> np.ndarray:
    """Q8.8 integer Gaussian taps of OpenCV's CV_8U bit-exact path: the
    baked tables for the reference's sizes; other sizes round the float
    kernel to Q8.8, the deficit on the centre tap (close to, not
    guaranteed bit-identical with, OpenCV's quantiser)."""
    if ksize in _Q88_TABLE:
        return np.asarray(_Q88_TABLE[ksize], dtype=np.float32)
    k = _gauss_kernel_f64(ksize)
    q = np.round(k * 256.0)
    q[ksize // 2] += 256.0 - q.sum()
    return q.astype(np.float32)


def _gauss_kernel_f64(ksize: int, sigma: float = 0.0) -> np.ndarray:
    small = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    }
    if sigma <= 0 and ksize in small:
        return np.asarray(small[ksize])
    if sigma <= 0:
        sigma = opencv_auto_sigma(ksize)
    c = (ksize - 1) * 0.5
    k = np.exp(-(((np.arange(ksize) - c) / sigma) ** 2) / 2.0)
    return k / k.sum()


def _as3d(x: torch.Tensor) -> torch.Tensor:
    """(..., F, T) -> (N, F, T), the leading axes flattened."""
    return x.reshape(-1, *x.shape[-2:])


def _reflect101_pad(x: torch.Tensor, pad_f: int, pad_t: int) -> torch.Tensor:
    """BORDER_REFLECT_101 (the edge pixel not repeated) on the last two axes."""
    p = F.pad(_as3d(x), (pad_t, pad_t, pad_f, pad_f), mode="reflect")
    return p.reshape(*x.shape[:-2], *p.shape[-2:])


def _sep_filter(x: torch.Tensor, kt: Sequence[float], kf: Sequence[float]) -> torch.Tensor:
    """Separable correlation over the last two axes, reflect-101 border:
    the time taps ``kt`` accumulated in tap order, then the frequency taps
    ``kf``, each tap a float32 multiply and add."""
    rt, rf = len(kt) // 2, len(kf) // 2
    p = _reflect101_pad(x, rf, rt)
    t_len, f_len = x.shape[-1], x.shape[-2]
    acc = None
    for i, c in enumerate(kt):
        s = p[..., :, i: i + t_len] * float(np.float32(c))
        acc = s if acc is None else acc + s
    out = None
    for j, c in enumerate(kf):
        s = acc[..., j: j + f_len, :] * float(np.float32(c))
        out = s if out is None else out + s
    return out


def gaussian_blur_u8(xu8: torch.Tensor, ksize: Tuple[int, int] = (31, 3)) -> torch.Tensor:
    """Bit-exact ``cv2.GaussianBlur(src, ksize, 0)`` on a uint8-valued
    float32 image; ``ksize`` in OpenCV's order (width = time taps, height
    = freq taps).  Rounds half up; exact integers 0..255 as float32."""
    kw, kh = ksize
    acc = _sep_filter(xu8, list(opencv_gauss_kernel_q88(kw)),
                      list(opencv_gauss_kernel_q88(kh)))  # Q16.16
    res = torch.floor((acc + 32768.0) * (1.0 / 65536.0))
    return res.clamp(0.0, 255.0)


def gaussian_blur(x: torch.Tensor, ksize: Tuple[int, int] = (31, 3),
                  emulate_uint8: bool = True) -> torch.Tensor:
    """``gaussblr`` (pipeline_data.py:52-55): uint8-quantised blur, then
    min-max rescale.  ``emulate_uint8=False``: the float separable Gaussian
    on ``x`` itself (not reference-exact)."""
    if emulate_uint8:
        return rescale(gaussian_blur_u8(to_uint8(x), ksize))
    return rescale(_sep_filter(x, list(_gauss_kernel_f64(ksize[0])),
                               list(_gauss_kernel_f64(ksize[1]))))


# ---------------------------------------------------------------------------
# grayscale morphology
# ---------------------------------------------------------------------------


def _morph_window(x: torch.Tensor, se: Tuple[int, int], is_max: bool) -> torch.Tensor:
    """Running max (or min) over an OpenCV WxH rect SE with its default
    anchor; ``se`` = (width = time, height = freq).  Source offsets
    [-d//2, d-1-d//2] per axis; out of bounds ignored by +-inf padding."""
    w, h = se
    pads = (w // 2, w - 1 - w // 2, h // 2, h - 1 - h // 2)
    x3 = _as3d(x)
    if is_max:
        out = F.max_pool2d(F.pad(x3, pads, value=-float("inf"))[:, None], (h, w), stride=1)
    else:
        out = -F.max_pool2d(F.pad(-x3, pads, value=-float("inf"))[:, None], (h, w), stride=1)
    return out.reshape(x.shape)


def dilate(x: torch.Tensor, se: Tuple[int, int]) -> torch.Tensor:
    return _morph_window(x, se, is_max=True)


def erode(x: torch.Tensor, se: Tuple[int, int]) -> torch.Tensor:
    return _morph_window(x, se, is_max=False)


def morph_close(x: torch.Tensor, se: Tuple[int, int]) -> torch.Tensor:
    return erode(dilate(x, se), se)


def morph_open(x: torch.Tensor, se: Tuple[int, int]) -> torch.Tensor:
    return dilate(erode(x, se), se)


def morph(x: torch.Tensor, close_se: Tuple[int, int] = (4, 4),
          open_se: Tuple[int, int] = (3, 1)) -> torch.Tensor:
    """``morph`` (pipeline_data.py:64-72): uint8-quantise, CLOSE with a 4x4
    rect SE, OPEN with a 3x1 rect SE, then min-max rescale."""
    mask = morph_open(morph_close(to_uint8(x), close_se), open_se)
    return rescale(mask)


# ---------------------------------------------------------------------------
# bilateral (dataset.ipynb cell 1; not in the label pipeline)
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split_f32(a):
    c = 4097.0 * a  # Veltkamp split, 2^12 + 1 for binary32
    hi = c - (c - a)
    return hi, a - hi


def _bilateral_taps(d: int, sigma_space: float):
    """cv2's (offset, space weight) taps: a disc of radius d//2, weights
    exp(r^2 * -0.5/ss^2) in float64 through cv2's sqrt-then-square round
    trip, cast to float32."""
    radius = d // 2
    gsc = -0.5 / (sigma_space * sigma_space)
    taps = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = np.sqrt(float(i * i + j * j))
            if r > radius:
                continue
            taps.append((i, j, np.float32(np.exp(r * r * gsc))))
    return radius, taps


def bilateral_u8(xu8: torch.Tensor, d: int = 15, sigma_color: float = 75.0,
                 sigma_space: float = 75.0) -> torch.Tensor:
    """Bit-exact ``cv2.bilateralFilter(src, d, sigma_color, sigma_space)``
    on a uint8-valued float32 image: a float32 range-weight table
    ``exp(i^2 * -0.5/sc^2)`` built in float64, float32 space weights on a
    disc of radius d//2, reflect-101 border, round-half-to-even of
    sum/wsum.  cv2 accumulates ``sum += val*w`` with a fused multiply-add;
    here the product's error is exact (w split, val has 8 bits) and a
    two_sum gives the single rounding.  ``wsum += w`` is a plain add."""
    radius, taps = _bilateral_taps(d, sigma_space)
    gcc = -0.5 / (sigma_color * sigma_color)
    color_lut = torch.as_tensor(
        np.exp((np.arange(256, dtype=np.float64) ** 2) * gcc).astype(np.float32),
        device=xu8.device)
    p = _reflect101_pad(xu8, radius, radius)
    f_len, t_len = xu8.shape[-2], xu8.shape[-1]
    idx0 = xu8.to(torch.int64)
    ssum = torch.zeros_like(xu8)
    wsum = torch.zeros_like(xu8)
    for (i, j, sw) in taps:
        val = p[..., radius + i: radius + i + f_len, radius + j: radius + j + t_len]
        w = float(sw) * color_lut[(val.to(torch.int64) - idx0).abs()]
        w_hi, w_lo = _split_f32(w)
        prod = val * w
        err = (val * w_hi - prod) + val * w_lo
        s, t = _two_sum(ssum, prod)
        ssum = s + (t + err)
        wsum = wsum + w
    return torch.round(ssum / wsum)


def bilateral(x: torch.Tensor, d: int = 15, sigma_color: float = 75.0,
              sigma_space: float = 75.0) -> torch.Tensor:
    """``bilateral`` (dataset.ipynb cell 1): uint8-quantise, bit-exact
    cv2.bilateralFilter(d=15, 75, 75), then min-max rescale."""
    return rescale(bilateral_u8(to_uint8(x), d, sigma_color, sigma_space))


# ---------------------------------------------------------------------------
# the composed pipeline
# ---------------------------------------------------------------------------


def pipeline_stages(spec: torch.Tensor, cfg: PipelineConfig = PipelineConfig()) -> dict:
    """Every stage's output of the label pipeline, by name ("quant",
    "gauss", "mean", "morph", "final"; denoising_spectrogram.ipynb cells 4-5)."""
    quant = quantile_filter(spec, cfg.quant_threshold)
    gauss = gaussian_blur(quant, cfg.gauss_ksize, cfg.emulate_uint8)
    mean = mean_subtract(gauss)
    morphed = morph(mean, cfg.close_se, cfg.open_se)
    return {"quant": quant, "gauss": gauss, "mean": mean, "morph": morphed,
            "final": mean_subtract(morphed)}


def classical_pipeline(spec: torch.Tensor, cfg: PipelineConfig = PipelineConfig()
                       ) -> torch.Tensor:
    """The reference's fixed 5-stage label pipeline (pipeline_data.py:100-110):
    quantfilt -> gaussblr(31,3) -> meansub -> morph -> meansub, on
    (..., freq, time) normalised log spectrograms in [0, 1]."""
    x = quantile_filter(spec, cfg.quant_threshold)
    x = gaussian_blur(x, cfg.gauss_ksize, cfg.emulate_uint8)
    x = mean_subtract(x)
    x = morph(x, cfg.close_se, cfg.open_se)
    return mean_subtract(x)
