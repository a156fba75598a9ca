"""Convolutional denoising autoencoder family as a ``torch.nn.Module`` (the
counterpart of ``specenh.models.autoencoder``, Keras semantics).

encoder: [Conv(f_i, k_i, same) + relu -> MaxPool 2x2] for each level;
decoder: [ConvTranspose(f_i, k_i, stride 2, same) + relu], mirrored;
head:    Conv(1, out_kernel, same) + sigmoid.

Public layout is the JAX package's tiles, (B, 256, 128); inside the module
runs NCHW.  Weights are glorot-uniform with zero bias (Keras defaults), drawn
from an explicit ``torch.Generator``.

The stride-2 transposed convolution is where the frameworks differ.  Flax's
``nn.ConvTranspose`` (transpose_kernel=False) dilates the input, pads it by
(pad_a, pad_b) from ``jax.lax``'s SAME rule (pad_len = k + s - 2: (2, 1)
for k3, (3, 2) for k5, (4, 3) for k7) and correlates with the UNflipped
kernel.  torch's ``conv_transpose2d`` is the gradient of a correlation, so
its kernel is the Flax kernel flipped in space, and its symmetric
``padding`` cannot express the uneven pad: ``conv_transpose_same`` pads
k-1-pad_a on both sides, adds one output row and column, and crops to the
first 2n.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from specenh_torch.config import ModelConfig

__all__ = ["ConvAutoencoder", "make_model", "param_count", "convt_pad_before",
           "conv_transpose_same", "Conv2dSame", "ConvTranspose2dSame"]


def convt_pad_before(k: int, stride: int = 2) -> int:
    """pad_a of jax.lax's SAME transposed-conv padding for one dim."""
    if stride > k - 1:
        return k - 1
    return -(-(k + stride - 2) // 2)


def conv_transpose_same(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None, groups: int = 1) -> torch.Tensor:
    """Flax 'SAME' stride-2 transposed conv: (B, Cin, H, W) -> (B, Cout,
    2H, 2W).  ``weight`` is torch's (Cin, Cout / groups, kh, kw), i.e. the
    Flax kernel flipped in space."""
    kh, kw = weight.shape[-2:]
    pad = (kh - 1 - convt_pad_before(kh), kw - 1 - convt_pad_before(kw))
    h, w = x.shape[-2:]
    y = F.conv_transpose2d(x, weight, bias, stride=2, padding=pad,
                           output_padding=1, groups=groups)
    return y[..., : 2 * h, : 2 * w]


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with 'same' padding for odd kernels, computing in the
    input's dtype (its weight and bias cast to it, as Flax's
    ``promote_dtype``)."""

    def __init__(self, cin: int, cout: int, k: Tuple[int, int]):
        super().__init__(cin, cout, k, padding=(k[0] // 2, k[1] // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ConvTranspose2dSame(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with Flax/Keras 'SAME' stride-2 geometry,
    computing in the input's dtype."""

    def __init__(self, cin: int, cout: int, k: Tuple[int, int]):
        super().__init__(cin, cout, k, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose_same(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def _glorot_(weight: torch.Tensor, fan_in: int, fan_out: int,
             generator: torch.Generator) -> None:
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        weight.uniform_(-limit, limit, generator=generator)


class ConvAutoencoder(nn.Module):
    """Depth-N conv autoencoder; ``forward`` maps (B, H, W) tiles to
    (B, H, W) float32 sigmoid probabilities.

    ``dtype`` is the computation dtype, as Flax's module attribute: the
    input and each layer's weight and bias are cast to it (Flax's
    ``promote_dtype``) and the logits come back float32, while the
    parameters keep their own dtype (float32 as built; bfloat16 here
    trains with float32 master weights).  None computes in the
    parameters' dtype."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), *,
                 generator: torch.Generator, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        for k in (*cfg.kernels, cfg.out_kernel):
            if k[0] % 2 == 0 or k[1] % 2 == 0:
                raise ValueError(f"'same' convs need odd kernels: {cfg}")
        self.cfg = cfg
        f = cfg.filters
        cin = (cfg.input_shape[-1], *f[:-1])
        self.enc_convs = nn.ModuleList(
            Conv2dSame(cin[i], f[i], cfg.kernels[i]) for i in range(cfg.depth)
        )
        # decoder level i maps filters[i+1] (filters[-1] at the bottom) to
        # filters[i]; indexed like Flax's dec_deconv{i}
        self.dec_deconvs = nn.ModuleList(
            ConvTranspose2dSame(f[min(i + 1, cfg.depth - 1)], f[i],
                                cfg.kernels[i])
            for i in range(cfg.depth)
        )
        self.out_conv = Conv2dSame(f[0], 1, cfg.out_kernel)
        for conv in (*self.enc_convs, self.out_conv):
            cout, cin_, kh, kw = conv.weight.shape
            _glorot_(conv.weight, cin_ * kh * kw, cout * kh * kw, generator)
            nn.init.zeros_(conv.bias)
        for conv in self.dec_deconvs:
            cin_, cout, kh, kw = conv.weight.shape
            _glorot_(conv.weight, cin_ * kh * kw, cout * kh * kw, generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        """(B, H, W) or the JAX layout (B, H, W, 1) -> the same layout,
        float32: sigmoid probabilities, or the logits with ``logits=True``
        (as Flax's ``__call__(x, logits)``), computed in ``self.dtype``."""
        return self.forward_as(x, self.dtype, logits)

    def forward_as(self, x: torch.Tensor, dtype: torch.dtype | None,
                   logits: bool = False) -> torch.Tensor:
        """``forward`` computing in ``dtype`` (None: the parameters')
        whatever the module's own ``dtype``: the service's module route
        runs in the service dtype."""
        dt = self.out_conv.weight.dtype if dtype is None else dtype
        nhwc = x.ndim == 4
        x = (x[..., 0] if nhwc else x)[:, None].to(dt)  # every layer follows x
        for conv in self.enc_convs:
            x = F.max_pool2d(F.relu(conv(x)), 2)
        for i in reversed(range(self.cfg.depth)):
            x = F.relu(self.dec_deconvs[i](x))
        z = self.out_conv(x)[:, 0].float()
        z = z if logits else torch.sigmoid(z)
        return z[..., None] if nhwc else z


def make_model(cfg: ModelConfig = ModelConfig(), *,
               generator: torch.Generator, device=None,
               dtype: torch.dtype | None = None) -> ConvAutoencoder:
    """Glorot-initialised model from ``generator`` (drawn on the CPU, so a
    seed gives the same weights on every device), moved to ``device``,
    computing in ``dtype`` (None: float32) with float32 parameters, as
    the JAX package's ``make_model(cfg, dtype)``."""
    return ConvAutoencoder(cfg, generator=generator, dtype=dtype).to(device)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
