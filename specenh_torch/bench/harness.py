"""The raw-shot -> enhanced-spectrograms service (the counterpart of
``specenh.bench.harness``).

``make_enhance_shot_fn`` builds the serving path: a multi-channel raw shot
goes through the STFT kernel (K1), then the conv-AE stage kernels (K2+K3+K4)
on 256x128 tiles, and comes back restitched.  ``enhance_shot_plain`` is the
same service composed of the plain twins (matmul STFT, the ``nn.Module``):
the float32 reference the service is gated against.
"""

from __future__ import annotations

import statistics
from typing import Callable, List

import numpy as np
import torch

from specenh.config import ModelConfig, PatchSpec, SpecParams
from specenh_torch.data.tiles import n_tiles_for
from specenh_torch.models.autoencoder import ConvAutoencoder
from specenh_torch.ops import ae_kernel, stft_fused
from specenh_torch.ops.stft import spectrogram

__all__ = ["make_enhance_shot_fn", "enhance_shot_plain", "example_shot",
           "time_cuda"]


def _k_tiles(sp: SpecParams, ps: PatchSpec) -> int:
    k = n_tiles_for(sp.n_frames, ps)
    if k < 1:
        raise ValueError(
            f"shot too short to tile: {sp.n_frames} frames < tile width {ps.tile_time}"
        )
    return k


def make_enhance_shot_fn(
    cfg: ModelConfig = ModelConfig(),
    sp: SpecParams = SpecParams(),
    ps: PatchSpec = PatchSpec(),
    dtype=torch.bfloat16,
    device="cuda",
) -> Callable:
    """Returns ``fn(model_or_weights, traces) -> (specs, enhanced)``:
    traces (C, >= n_samples) -> specs (C, 256, n_frames) float32, enhanced
    (C, 256, k*128) float32.

    The AE runs in ``dtype`` (bfloat16, or float32 for ``None``); the STFT
    is float32 either way.  ``fn.prepare(model)`` builds the kernels'
    weights once; a resident service passes that in place of the model.
    On ``device="cpu"`` every kernel wrapper runs its plain twin.
    """
    dtype = torch.float32 if dtype is None else dtype
    device = torch.device(device)
    if not stft_fused.supported(sp):
        raise NotImplementedError(f"the STFT kernel needs nperseg=512/hop=256: {sp}")
    if not ae_kernel.supports(cfg):
        raise NotImplementedError(f"no AE kernel covers this geometry: {cfg}")
    k_tiles = _k_tiles(sp, ps)

    def prepare(model_or_weights):
        if isinstance(model_or_weights, ae_kernel.AEKernelWeights):
            return model_or_weights
        return ae_kernel.build_kernel_weights(model_or_weights, dtype)

    def fn(model_or_weights, traces):
        wts = prepare(model_or_weights)
        traces = torch.as_tensor(traces, dtype=torch.float32, device=device)
        with torch.no_grad():
            specs = stft_fused.spectrogram_fused(traces.contiguous(), sp)
            return specs, ae_kernel.ae_kernel_enhance_specs(wts, specs, k_tiles)

    fn.prepare = prepare
    return fn


def enhance_shot_plain(model: ConvAutoencoder, traces: torch.Tensor,
                       sp: SpecParams = SpecParams(),
                       ps: PatchSpec = PatchSpec()):
    """The service from the plain twins, on ``traces``' device: the
    reference STFT (``torch.matmul``) and the ``nn.Module`` in its own
    dtype.  On a GPU keep TF32 off for this to be a float32 reference."""
    k_tiles = _k_tiles(sp, ps)
    with torch.no_grad():
        specs = spectrogram(traces, sp)
        return specs, ae_kernel.ae_kernel_enhance_specs_plain(model, specs, k_tiles)


def example_shot(sp: SpecParams = SpecParams(), n_channels: int = 20,
                 seed: int = 0) -> np.ndarray:
    """Synthetic 20-channel ECE-like shot (chirp + tone + noise), the same
    numbers as ``specenh.bench.harness.example_shot``."""
    rng = np.random.default_rng(seed)
    t = np.arange(sp.n_samples) / sp.fs
    out = np.stack(
        [
            np.sin(2 * np.pi * (5e4 + 2e4 * t) * t + k)
            + 0.3 * np.sin(2 * np.pi * 1.2e5 * t)
            + 0.5 * rng.standard_normal(t.size)
            for k in range(n_channels)
        ]
    )
    return out.astype(np.float32)


def time_cuda(fn: Callable, *args, warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds of ``fn(*args)`` on the current CUDA stream,
    from CUDA events around each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    pairs: List = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
