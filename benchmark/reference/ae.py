"""The conv autoencoder's forward, its masked loss and Keras's Adam step, in
plain ``torch.nn.functional`` ops and float32 (the model of
VAE/hyperparam_scan.py:152-184 as the port defines it: Keras 'same' convs,
relu, 2x2 max-pooling, stride-2 'same' transposed convs with Flax's
padding, a 1-channel sigmoid head; the port's state_dict names and
layouts).

``quant`` lowers the arithmetic for the control: every conv's input and
weight pass through it before the conv, and every gradient flowing back
into a conv's output through ``quant_grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def leaf_names(depth: int) -> List[str]:
    names = []
    for i in range(depth):
        names += [f"enc_convs.{i}.weight", f"enc_convs.{i}.bias"]
    for i in range(depth):
        names += [f"dec_deconvs.{i}.weight", f"dec_deconvs.{i}.bias"]
    return names + ["out_conv.weight", "out_conv.bias"]


def leaf_shapes(model: Dict) -> Dict[str, Tuple[Tuple[int, ...], int, int]]:
    """Each leaf's shape and, for weights, its glorot fans (0, 0 for biases):
    conv weights (cout, cin, kh, kw), transposed-conv weights (cin, cout,
    kh, kw), torch's layouts."""
    f, ks = list(model["filters"]), [tuple(k) for k in model["kernels"]]
    d, c = len(f), model["input_shape"][-1]
    out = {}
    cin = (c, *f[:-1])
    for i in range(d):
        kh, kw = ks[i]
        out[f"enc_convs.{i}.weight"] = ((f[i], cin[i], kh, kw), cin[i] * kh * kw, f[i] * kh * kw)
        out[f"enc_convs.{i}.bias"] = ((f[i],), 0, 0)
    for i in range(d):
        kh, kw = ks[i]
        ci = f[min(i + 1, d - 1)]
        out[f"dec_deconvs.{i}.weight"] = ((ci, f[i], kh, kw), ci * kh * kw, f[i] * kh * kw)
        out[f"dec_deconvs.{i}.bias"] = ((f[i],), 0, 0)
    kh, kw = model["out_kernel"]
    out["out_conv.weight"] = ((1, f[0], kh, kw), f[0] * kh * kw, kh * kw)
    out["out_conv.bias"] = ((1,), 0, 0)
    return {k: out[k] for k in leaf_names(d)}


def convt_pad_before(k: int, stride: int = 2) -> int:
    """pad_a of jax.lax's SAME transposed-conv padding for one dimension."""
    if stride > k - 1:
        return k - 1
    return -(-(k + stride - 2) // 2)


def conv_transpose_same(x, weight, bias):
    """Flax 'SAME' stride-2 transposed conv, (B, Cin, H, W) -> (B, Cout,
    2H, 2W), with torch's (Cin, Cout, kh, kw) kernel."""
    kh, kw = weight.shape[-2:]
    pad = (kh - 1 - convt_pad_before(kh), kw - 1 - convt_pad_before(kw))
    h, w = x.shape[-2:]
    y = F.conv_transpose2d(x, weight, bias, stride=2, padding=pad, output_padding=1)
    return y[..., : 2 * h, : 2 * w]


def _ident(x):
    return x


def logits(p: Params, x: torch.Tensor, depth: int, quant: Callable = _ident,
           quant_grad: Callable = _ident) -> torch.Tensor:
    """(B, H, W) float32 tiles -> (B, H, W) logits."""
    h = x[:, None]
    for i in range(depth):
        w = p[f"enc_convs.{i}.weight"]
        z = F.conv2d(quant(h), quant(w), p[f"enc_convs.{i}.bias"],
                     padding=(w.shape[-2] // 2, w.shape[-1] // 2))
        h = F.max_pool2d(F.relu(quant_grad(z)), 2)
    for i in reversed(range(depth)):
        z = conv_transpose_same(quant(h), quant(p[f"dec_deconvs.{i}.weight"]),
                                p[f"dec_deconvs.{i}.bias"])
        h = F.relu(quant_grad(z))
    w = p["out_conv.weight"]
    z = F.conv2d(quant(h), quant(w), p["out_conv.bias"],
                 padding=(w.shape[-2] // 2, w.shape[-1] // 2))
    return quant_grad(z)[:, 0]


def bce_from_logits(z: torch.Tensor, y: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy from logits over the rows ``mask`` keeps."""
    per = z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if mask is None:
        return per.mean()
    w = mask.reshape((-1,) + (1,) * (per.ndim - 1)).to(per.dtype)
    return (per * w).sum() / (w.sum() * per[0].numel())


def mean_bce(p: Params, x: torch.Tensor, y: torch.Tensor, depth: int,
             quant: Callable = _ident, block: int = 150) -> float:
    """The mean binary cross-entropy over all rows of (x, y), in blocks of
    rows so that it fits."""
    total = 0.0
    with torch.no_grad():
        for a in range(0, x.shape[0], block):
            z = logits(p, x[a : a + block], depth, quant)
            total += float(bce_from_logits(z, y[a : a + block]).double()) * z.shape[0]
    return total / x.shape[0]


class Adam:
    """Keras's Adam (lr 1e-3, betas 0.9/0.999, eps 1e-7 added to the
    bias-corrected root): p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, lr: float, beta1: float, beta2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.t = 0
        self.m: Params = {}
        self.v: Params = {}

    def step(self, p: Params, g: Params) -> Params:
        self.t += 1
        out = {}
        for k, gk in g.items():
            m = self.m.get(k, torch.zeros_like(gk)) * self.b1 + (1 - self.b1) * gk
            v = self.v.get(k, torch.zeros_like(gk)) * self.b2 + (1 - self.b2) * gk * gk
            self.m[k], self.v[k] = m, v
            denom = v.sqrt() / (1 - self.b2 ** self.t) ** 0.5 + self.eps
            out[k] = p[k] - self.lr / (1 - self.b1 ** self.t) * m / denom
        return out


def train_steps(p0: Params, batches, depth: int, hp: Dict, quant: Callable = _ident,
                quant_grad: Callable = _ident):
    """Keras-fit steps from ``p0`` over ``batches`` [(x, y, mask)]: returns
    (losses, the first step's gradients, the parameters after each step)."""
    opt = Adam(hp["learning_rate"], hp["beta1"], hp["beta2"], hp["adam_eps"])
    p = {k: v.detach().clone() for k, v in p0.items()}
    losses, grads0, after = [], None, []
    for x, y, mask in batches:
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = bce_from_logits(logits(leaves, x, depth, quant, quant_grad), y, mask)
        g = torch.autograd.grad(loss, list(leaves.values()))
        g = {k: gk.detach() for k, gk in zip(leaves, g)}
        grads0 = g if grads0 is None else grads0
        losses.append(float(loss.detach()))
        p = opt.step(p, g)
        after.append({k: v.clone() for k, v in p.items()})
    return losses, grads0, after
