"""Rounding to a lower precision, for the controls: the reference computed
one step below the configuration's precision.

fp8 as it is used in practice: each tensor scaled by its own absolute
maximum onto the format's largest finite value before it is rounded
(e4m3 for activations and weights, e5m2 for gradients), then scaled back.
"""

from __future__ import annotations

import torch

_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_scaled(x: torch.Tensor, fmt) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    s = _MAX[fmt] / amax
    return ((x.float() * s).to(fmt).float() / s).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 rounding in the forward, the gradient passed straight through."""
    return x + (round_scaled(x.detach(), torch.float8_e4m3fn) - x).detach()


class _GradFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_scaled(g, torch.float8_e5m2)


def fp8_grad(x: torch.Tensor) -> torch.Tensor:
    """The identity in the forward; e5m2 rounding of the gradient in the backward."""
    return _GradFp8.apply(x)
