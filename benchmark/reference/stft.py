"""The reference spectrogram recipe (spec_denoising/pipeline_data.py:28-36),
in plain PyTorch and float64::

    f, t, Sxx = scipy.signal.spectrogram(sig, nperseg=512, noverlap=256,
        fs=5e5, window='hamm', scaling='density', detrend='linear')
    Sxx = np.log(Sxx + 1e-11)
    Sxx = (Sxx - Sxx.min()) / (Sxx.max() - Sxx.min())
    Sxx = Sxx[:-1, :]

Frames of nperseg samples every hop, each detrended by its least-squares
line, windowed by the periodic Hamming window and transformed by a real
FFT; the one-sided density PSD (every bin but DC and Nyquist doubled), its
log, the min-max over all one-sided rows of the channel, then the Nyquist
row dropped.  ``dtype`` lowers the arithmetic for the control: the frames,
their transform and the PSD are rounded to it where they are formed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def hamming_periodic(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    k = torch.arange(n, dtype=dtype, device=device)
    return 0.54 - 0.46 * torch.cos(2.0 * math.pi * k / n)


def spectrogram(traces: torch.Tensor, spec: Dict,
                lower: Optional[torch.dtype] = None) -> torch.Tensor:
    """(C, >= n_samples) traces -> (C, nperseg // 2, n_frames) float32
    normalized log-PSD, computed in float64 (or rounded to ``lower`` at each
    stage)."""
    n, hop = spec["nperseg"], spec["nperseg"] - spec["noverlap"]
    n_samples = int(spec["cut_shot"] * spec["fs"])
    if spec["window"] not in ("hamm", "hamming") or spec["detrend"] != "linear" \
            or spec["scaling"] != "density":
        raise NotImplementedError(f"the reference STFT covers the recipe's settings: {spec}")

    def rnd(x):
        return x if lower is None else x.to(lower).to(torch.float64)

    x = rnd(traces[:, :n_samples].to(torch.float64))
    frames = x.unfold(-1, n, hop)                                   # (C, T, n)
    t = torch.arange(n, dtype=torch.float64, device=x.device)
    tc = t - t.mean()
    mean = frames.mean(-1, keepdim=True)
    slope = (frames * tc).sum(-1, keepdim=True) / (tc * tc).sum()
    w = hamming_periodic(n, device=x.device)
    seg = rnd((frames - mean - slope * tc) * w)
    spec_c = torch.fft.rfft(seg, dim=-1)                             # (C, T, n/2+1)
    re, im = rnd(spec_c.real), rnd(spec_c.imag)
    scale = 1.0 / (spec["fs"] * float((w * w).sum()))
    psd = (re * re + im * im) * scale
    psd[..., 1:-1] *= 2.0                                            # even nperseg
    sxx = rnd(torch.log(psd + spec["eps"])).transpose(1, 2)         # (C, F, T)
    mn = sxx.amin(dim=(1, 2), keepdim=True)
    mx = sxx.amax(dim=(1, 2), keepdim=True)
    return ((sxx - mn) / (mx - mn))[:, :-1].to(torch.float32)
