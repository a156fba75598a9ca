"""K1, the serving path's STFT: CUDA kernel wrapper and its plain twin (the
counterpart of ``specenh.ops.stft_fused``).

``stft_ft_log`` returns the raw log-PSD in the natural (F, T) layout with
the per-channel min/max over the reference's pre-drop normalization domain
(valid frames, all one-sided rows including Nyquist).  For a CUDA tensor it
launches ``csrc/stft.cu`` and reduces the kernel's per-block min/max
partials; for a CPU tensor it runs ``stft_ft_log_plain`` (framing, one
matmul with the basis, the same epilogue).  ``spectrogram_fused`` adds the
normalization and the Nyquist drop, a short torch epilogue as in the JAX
package, where it is XLA outside the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from specenh.config import SpecParams
from specenh_torch._build import CudaKernel
from specenh_torch.ops.stft import _basis_np, psd_weights, stft_psd

__all__ = ["supported", "stft_ft_log", "stft_ft_log_plain", "spectrogram_fused",
           "STFT_KERNEL"]

# frames x frequencies per block of csrc/stft.cu (BM, BN)
_BLOCK_T, _BLOCK_F = 64, 64

STFT_KERNEL = CudaKernel("stft", "stft_logpsd", [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
])


def supported(sp: SpecParams) -> bool:
    """The reference STFT geometry the serving path runs (as the JAX
    kernel's ``supported``): nperseg 512, hop 256."""
    return sp.nperseg == 512 and sp.hop == 256


@functools.lru_cache(maxsize=4)
def _kernel_operands(sp: SpecParams, device: torch.device):
    """float32 [Br | Bi] basis, each half padded to whole 64-column blocks,
    and the one-sided weights, on ``device``."""
    br, bi, _ = _basis_np(sp.nperseg, sp.detrend, sp.fs, sp.scaling, sp.window)
    nf = br.shape[1]
    fpad = -(-nf // _BLOCK_F) * _BLOCK_F
    pack = np.zeros((sp.nperseg, 2 * fpad), np.float64)
    pack[:, :nf] = br
    pack[:, fpad:fpad + nf] = bi
    return (torch.as_tensor(pack, dtype=torch.float32, device=device),
            torch.as_tensor(psd_weights(sp), dtype=torch.float32, device=device),
            fpad)


def _check_traces(traces: torch.Tensor, sp: SpecParams) -> None:
    if not supported(sp):
        raise NotImplementedError(f"the STFT kernel needs nperseg=512/hop=256: {sp}")
    if traces.dtype != torch.float32:
        raise TypeError(f"traces must be float32, got {traces.dtype}")
    if traces.ndim != 2 or traces.shape[1] < sp.n_samples:
        raise ValueError(
            f"traces must be (C, >= {sp.n_samples}), got {tuple(traces.shape)}"
        )


def stft_ft_log_plain(traces: torch.Tensor, sp: SpecParams
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of ``stft_ft_log``: framing, ``torch.matmul`` with the
    basis, log epilogue, per-channel min/max."""
    sxx = torch.log(stft_psd(traces, sp) + sp.eps)
    return sxx, sxx.amin(dim=(1, 2))[:, None], sxx.amax(dim=(1, 2))[:, None]


def stft_ft_log(traces: torch.Tensor, sp: SpecParams
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C, >= n_samples) float32 traces -> ((C, 257, n_frames) float32
    log-PSD, (C, 1) min, (C, 1) max); min/max over all 257 rows."""
    _check_traces(traces, sp)
    if not traces.is_cuda:
        return stft_ft_log_plain(traces, sp)
    if not traces.is_contiguous():
        raise ValueError("traces must be contiguous")
    basis, weights, fpad = _kernel_operands(sp, traces.device)
    c = traces.shape[0]
    nf, nt = sp.n_freqs_onesided, sp.n_frames
    out = torch.empty(c, nf, nt, dtype=torch.float32, device=traces.device)
    parts = torch.empty(c, -(-nt // _BLOCK_T), fpad // _BLOCK_F, 2,
                        dtype=torch.float32, device=traces.device)
    STFT_KERNEL(traces.data_ptr(), traces.stride(0), c, sp.hop, sp.nperseg,
                nt, nf, fpad, basis.data_ptr(), weights.data_ptr(),
                float(sp.eps), out.data_ptr(), parts.data_ptr())
    parts = parts.reshape(c, -1, 2)
    return out, parts[:, :, 0].amin(1, keepdim=True), parts[:, :, 1].amax(1, keepdim=True)


def spectrogram_fused(traces: torch.Tensor, sp: SpecParams) -> torch.Tensor:
    """Drop-in for ``ops.stft.spectrogram`` on (C, n) traces: log-PSD,
    per-channel min-max over all one-sided rows (the pre-drop quirk),
    Nyquist row dropped -> (C, 256, n_frames) float32."""
    out, mn, mx = stft_ft_log(traces, sp)
    v = out[:, : sp.n_freqs_kept]
    return (v - mn[:, :, None]) / (mx - mn)[:, :, None]
