"""K1, the serving path's STFT: CUDA kernel wrapper and its plain twin (the
counterpart of ``specenh.ops.stft_fused``).

``stft_ft_log`` returns the raw log-PSD in the natural (F, T) layout with
the per-channel min/max over the reference's pre-drop normalization domain
(valid frames, all one-sided rows including Nyquist).  For a CUDA tensor it
launches ``csrc/stft.cu`` (per frame: detrend by mean and slope, window, a
512-point real FFT as a 256-point complex FFT in shared memory, the log
epilogue) and reduces the kernel's per-block min/max partials; for a CPU
tensor it runs ``stft_ft_log_plain`` (``ops.stft.log_psd``: framing, one
float64 matmul with the detrend x window x DFT basis, the log in float64,
cast to float32 once: the same values whatever the blocking of a BLAS).
``spectrogram_fused`` adds the normalization and the Nyquist drop, a short
torch epilogue as in the JAX package, where it is XLA outside the kernel.

``stft_tf_log`` is the same kernel writing the (T, F) layout, the front of
``stft_mode="fused"``: the same arithmetic, so the same bits, transposed.  Its
consumers are ``ae_kernel.ae_tile_in_norm`` (which normalizes as it loads)
and ``normalized_specs`` (the service's specs output, one transposing
pass).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from specenh_torch.config import SpecParams
from specenh_torch._build import CudaKernel
from specenh_torch.ops.stft import _window_np, log_psd, psd_weights

__all__ = ["supported", "stft_ft_log", "stft_ft_log_plain", "stft_tf_log",
           "stft_tf_log_plain", "spectrogram_fused", "normalized_specs",
           "fft_table", "STFT_KERNEL", "STFT_TF_KERNEL"]

# frames per block of csrc/stft.cu (TB); the (T, F) output's row stride, in
# floats (whole 128-byte lines)
_BLOCK_T, _TF_LD = 16, 320
_DETREND = {"none": 0, "false": 0, "": 0, "constant": 1, "linear": 2}

_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_float, ctypes.c_void_p]
STFT_KERNEL = CudaKernel("stft", "stft_logpsd", [*_ARGS, ctypes.c_void_p])
# + the output's row stride
STFT_TF_KERNEL = CudaKernel("stft", "stft_logpsd_tf", [*_ARGS, ctypes.c_int64,
                                                       ctypes.c_void_p])


def supported(sp: SpecParams) -> bool:
    """The reference STFT geometry the serving path runs (as the JAX
    kernel's ``supported``): nperseg 512, hop 256."""
    return sp.nperseg == 512 and sp.hop == 256


def fft_table(sp: SpecParams) -> np.ndarray:
    """float64 table of the FFT kernel, in its order: the window (nperseg),
    W_{n/2}^k = exp(-2 pi i k / (n/2)) as cos and sin for k < n/2, and
    W_n^k for k <= n/2 (the real-to-complex split)."""
    n = sp.nperseg
    k2, k1 = np.arange(n // 2), np.arange(n // 2 + 1)
    a2, a1 = -2.0 * np.pi * k2 / (n // 2), -2.0 * np.pi * k1 / n
    return np.concatenate([_window_np(sp.window, n), np.cos(a2), np.sin(a2),
                           np.cos(a1), np.sin(a1)])


@functools.lru_cache(maxsize=4)
def _kernel_operands(sp: SpecParams, device: torch.device):
    """The kernel's float32 table (``fft_table``) and one-sided weights, on
    ``device``."""
    return (torch.as_tensor(fft_table(sp), dtype=torch.float32, device=device),
            torch.as_tensor(psd_weights(sp), dtype=torch.float32, device=device))


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
    """Plain twin of ``stft_ft_log``: ``ops.stft.log_psd`` (framing, a
    float64 matmul with the basis and a float64 log, rounded once) and the
    per-channel min/max."""
    sxx = log_psd(traces, sp)
    return sxx, sxx.amin(dim=(1, 2))[:, None], sxx.amax(dim=(1, 2))[:, None]


def stft_tf_log_plain(traces: torch.Tensor, sp: SpecParams
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of ``stft_tf_log``: ``stft_ft_log_plain`` transposed."""
    sxx, mn, mx = stft_ft_log_plain(traces, sp)
    return sxx.transpose(1, 2).contiguous(), mn, mx


def _launch(traces: torch.Tensor, sp: SpecParams, tf: bool):
    """K1 on the card in the (T, F) (``tf``) or the (F, T) layout ->
    (log-PSD, min, max)."""
    if not traces.is_contiguous():
        raise ValueError("traces must be contiguous")
    if sp.detrend not in _DETREND:
        raise NotImplementedError(f"the STFT kernel's detrend kinds are {sorted(_DETREND)}")
    table, weights = _kernel_operands(sp, traces.device)
    c = traces.shape[0]
    nf, nt = sp.n_freqs_onesided, sp.n_frames
    # (T, F): rows padded to whole 128-byte lines; the view drops the padding
    out = torch.empty((c, nt, _TF_LD) if tf else (c, nf, nt), dtype=torch.float32,
                      device=traces.device)
    parts = torch.empty(c, -(-nt // _BLOCK_T), 2, dtype=torch.float32,
                        device=traces.device)
    kernel, ld = (STFT_TF_KERNEL, (_TF_LD,)) if tf else (STFT_KERNEL, ())
    kernel(traces.data_ptr(), traces.stride(0), c, sp.hop, sp.nperseg, nt, nf,
           _DETREND[sp.detrend], table.data_ptr(), weights.data_ptr(), float(sp.eps),
           out.data_ptr(), *ld, parts.data_ptr())
    return (out[:, :, :nf] if tf else out, parts[:, :, 0].amin(1, keepdim=True),
            parts[:, :, 1].amax(1, keepdim=True))


def stft_ft_log(traces: torch.Tensor, sp: SpecParams
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C, >= n_samples) float32 traces -> ((C, 257, n_frames) float32
    log-PSD, (C, 1) min, (C, 1) max); min/max over all 257 rows."""
    _check_traces(traces, sp)
    if not traces.is_cuda:
        return stft_ft_log_plain(traces, sp)
    return _launch(traces, sp, tf=False)


def stft_tf_log(traces: torch.Tensor, sp: SpecParams
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C, >= n_samples) float32 traces -> ((C, n_frames, 257) float32
    log-PSD in the (T, F) layout, (C, 1) min, (C, 1) max): ``stft_ft_log``
    transposed, bit for bit.  On the card the rows are 320 floats apart
    (a view of a padded buffer); the CPU twin's are contiguous."""
    _check_traces(traces, sp)
    if not traces.is_cuda:
        return stft_tf_log_plain(traces, sp)
    return _launch(traces, sp, tf=True)


def spectrogram_fused(traces: torch.Tensor, sp: SpecParams) -> torch.Tensor:
    """Drop-in for ``ops.stft.spectrogram`` on (C, n) traces: log-PSD,
    per-channel min-max over all one-sided rows (the pre-drop quirk),
    Nyquist row dropped -> (C, 256, n_frames) float32."""
    out, mn, mx = stft_ft_log(traces, sp)
    v = out[:, : sp.n_freqs_kept]
    return (v - mn[:, :, None]) / (mx - mn)[:, :, None]


def normalized_specs(raw_tf: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                     n_frames: int) -> torch.Tensor:
    """(C, >= n_frames, >= 256) (T, F) log-PSD + (C, 1) min/max -> the
    service's (C, 256, n_frames) normalized float32 spectrogram (Nyquist
    dropped after the min-max), contiguous: the same values as
    ``spectrogram_fused``, through one transposing pass and one in place."""
    v = raw_tf[:, :n_frames, :256].transpose(1, 2)
    out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    torch.sub(v, mn[:, :, None], out=out)
    return out.div_((mx - mn)[:, :, None])
