"""The benchmark's inputs, made from ``--seed`` on the run's device: the
model's weights, synthetic shots, training tiles and their labels.  The
same seed gives the same numbers; every seed gives the same sizes.

Weights: glorot-uniform with zero biases (the Keras defaults) in the
port's state_dict layout, drawn in one call from a ``torch.Generator``
on the device.  Shots: the form of the port's ``synthetic_shot_batch``,
chirp + tone + noise per channel, the chirp's rate varying by shot and
the tone by channel; the seed draws the noise, a phase per shot and
channel, and the order of the shots.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import ae as ref_ae
from benchmark.reference import stft as ref_stft

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & SEED_MASK)
    return g


def glorot_weights(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights in the port's state_dict names and layouts."""
    shapes = ref_ae.leaf_shapes(model)
    sizes = {k: math.prod(s) for k, (s, fi, _) in shapes.items() if fi}
    u = torch.empty(sum(sizes.values()), dtype=torch.float32, device=device)
    u.uniform_(-1.0, 1.0, generator=generator(seed, device, 1))
    out, at = {}, 0
    for k, (shape, fan_in, fan_out) in shapes.items():
        if not fan_in:
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        n = sizes[k]
        out[k] = (u[at : at + n] * (6.0 / (fan_in + fan_out)) ** 0.5).reshape(shape)
        at += n
    return out


def shot(index: int, n_channels: int, spec: Dict, p: Dict, g: torch.Generator,
         device) -> torch.Tensor:
    """(n_channels, n_samples) float32: the shot of chirp rate ``index``,
    its noise, phases and each channel's noise level drawn from ``g`` (the
    level log-uniform within ``noise_spread_db`` of ``noise_amp``: ECE
    channels differ in signal to noise, core against edge)."""
    n = int(spec["cut_shot"] * spec["fs"])
    phase = torch.rand(n_channels, 1, generator=g, device=device,
                       dtype=torch.float64) * (2 * math.pi)
    level = torch.rand(n_channels, 1, generator=g, device=device) * 2 - 1
    amp = p["noise_amp"] * 10 ** (level * p["noise_spread_db"] / 20)
    out = torch.randn(n_channels, n, generator=g, device=device).mul_(amp)
    t = torch.arange(n, dtype=torch.float64, device=device) / spec["fs"]
    c = torch.arange(n_channels, dtype=torch.float64, device=device)[:, None]
    rate = p["chirp_rate_hz_per_s"] + p["chirp_rate_step"] * index
    wave = (torch.sin(2 * math.pi * (p["chirp_hz"] + rate * t) * t + c + phase)
            + p["tone_amp"] * torch.sin(2 * math.pi * (p["tone_hz"] + p["tone_step_hz"] * c) * t))
    return out.add_(wave.to(torch.float32))


def shots(n_shots: int, n_channels: int, spec: Dict, p: Dict, seed: int,
          device) -> torch.Tensor:
    """(n_shots, n_channels, n_samples) float32: the shots of chirp rates
    0 .. n_shots - 1 in an order drawn from the seed."""
    g = generator(seed, device, 2)
    order = torch.randperm(n_shots, generator=g, device=device).tolist()
    return torch.stack([shot(i, n_channels, spec, p, g, device) for i in order])


def tiles(specs: torch.Tensor, patch: Dict) -> torch.Tensor:
    """(C, 256, T) spectrograms -> (C * k, 256, tile_time) tiles, each
    spectrogram's tiles side by side from column 0."""
    tt, k = patch["tile_time"], patch["tiles_per_spec"]
    c, f, _ = specs.shape
    x = specs[:, :, : k * tt].reshape(c, f, k, tt)
    return x.permute(0, 2, 1, 3).reshape(c * k, f, tt)


def training_tiles(n_shots: int, n_channels: int, spec: Dict, patch: Dict, p: Dict,
                   seed: int, device) -> torch.Tensor:
    """Normalized spectrogram tiles of ``n_shots`` synthetic shots, made
    shot by shot (the reference STFT, float64) and put in an order drawn
    from the seed: (n_shots * n_channels * k, 256, tile_time) float32."""
    per = n_channels * patch["tiles_per_spec"]
    out = torch.empty(n_shots * per, patch["tile_freq"], patch["tile_time"],
                      dtype=torch.float32, device=device)
    for s in range(n_shots):
        raw = shot(s, n_channels, spec, p, generator(seed, device, 100 + s), device)
        out[s * per : (s + 1) * per] = tiles(ref_stft.spectrogram(raw, spec), patch)
    perm = torch.randperm(out.shape[0], generator=generator(seed, device, 3), device=device)
    return out[perm]
