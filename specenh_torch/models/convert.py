"""Flax parameters of ``specenh.models.autoencoder`` -> the port's state_dict.

So both packages can run the same weights.  Input is the Flax param tree
with numpy-convertible leaves (``{"params": {"enc_conv0": {"kernel",
"bias"}, ...}}``); nothing here imports jax.

* ``nn.Conv`` kernels are (kh, kw, in, out); torch wants (out, in, kh, kw).
* ``nn.ConvTranspose`` (transpose_kernel=False) correlates with its kernel
  as stored, while torch's transposed conv applies the spatial flip: the
  kernel is flipped along kh and kw and laid out as (in, out, kh, kw).  The
  uneven SAME padding is handled by ``models.autoencoder.conv_transpose_same``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from specenh_torch.config import ModelConfig

__all__ = ["state_dict_from_flax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


def state_dict_from_flax(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Flax params -> ``ConvAutoencoder(cfg).state_dict()``-shaped dict."""
    p = params["params"] if "params" in params else params
    sd = {}
    for i in range(cfg.depth):
        enc = p[f"enc_conv{i}"]
        sd[f"enc_convs.{i}.weight"] = _t(np.asarray(enc["kernel"]).transpose(3, 2, 0, 1))
        sd[f"enc_convs.{i}.bias"] = _t(enc["bias"])
        dec = p[f"dec_deconv{i}"]
        k = np.asarray(dec["kernel"])[::-1, ::-1]
        sd[f"dec_deconvs.{i}.weight"] = _t(k.transpose(2, 3, 0, 1))
        sd[f"dec_deconvs.{i}.bias"] = _t(dec["bias"])
    out = p["out_conv"]
    sd["out_conv.weight"] = _t(np.asarray(out["kernel"]).transpose(3, 2, 0, 1))
    sd["out_conv.bias"] = _t(out["bias"])
    return sd
