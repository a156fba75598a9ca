"""Import reference Keras autoencoder weights into the port's
``state_dict`` (the counterpart of ``specenh.models.keras_import``).

The reference persists trained models as Keras SavedModels
(``autoencoder.save(path + 'keras_model')``, VAE/hyperparam_scan.py:191;
the missing ``VAE/best_model`` artifact is one of these).  This module lets
a user of the reference carry those weights over.  Nothing here imports
TensorFlow: the input is ``keras_model.get_weights()``.

Layout conversions (held against TF's predictions by the tests):
* Conv2D: the Keras kernel is HWIO; torch's is (out, in, kh, kw):
  ``transpose(3, 2, 0, 1)``.
* Conv2DTranspose: the Keras kernel is (kh, kw, OUT, IN) and the op is the
  gradient of a convolution, as torch's ``conv_transpose2d``, whose weight
  is (IN, OUT, kh, kw): ``transpose(3, 2, 0, 1)`` with no spatial flip.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from specenh_torch.config import ModelConfig

__all__ = ["params_from_keras_weights", "model_config_from_keras_weights"]


def _split_layers(weights: Sequence[np.ndarray]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Group a flat [kernel, bias, kernel, bias, ...] weight list."""
    if len(weights) % 2 != 0:
        raise ValueError("expected alternating kernel/bias weights")
    return [(np.asarray(weights[i]), np.asarray(weights[i + 1])) for i in range(0, len(weights), 2)]


def model_config_from_keras_weights(
    weights: Sequence[np.ndarray], input_shape=(256, 128, 1)
) -> ModelConfig:
    """Infer the ModelConfig of a reference autoencoder from its weight list
    (2*depth+1 conv layers: depth Conv2D + depth Conv2DTranspose + head)."""
    layers = _split_layers(weights)
    n = len(layers)
    if n % 2 != 1:
        raise ValueError(f"expected odd number of conv layers, got {n}")
    depth = (n - 1) // 2
    filters = tuple(int(k.shape[-1]) for k, _ in layers[:depth])
    kernels = tuple((int(k.shape[0]), int(k.shape[1])) for k, _ in layers[:depth])
    out_kernel = (int(layers[-1][0].shape[0]), int(layers[-1][0].shape[1]))
    return ModelConfig(
        filters=filters, kernels=kernels, out_kernel=out_kernel, input_shape=input_shape
    )


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C", copy=True))


def params_from_keras_weights(weights: Sequence[np.ndarray],
                              cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Convert ``keras_model.get_weights()`` into a
    ``ConvAutoencoder(cfg).state_dict()``-shaped dict.  Keras layer order
    is the module's: the encoder convs, the decoder transposes from the
    deepest up, the output conv."""
    layers = _split_layers(weights)
    depth = cfg.depth
    sd = {}
    for i in range(depth):
        k, b = layers[i]
        sd[f"enc_convs.{i}.weight"] = _t(k.transpose(3, 2, 0, 1))
        sd[f"enc_convs.{i}.bias"] = _t(b)
    for j, i in enumerate(reversed(range(depth))):
        k, b = layers[depth + j]
        sd[f"dec_deconvs.{i}.weight"] = _t(k.transpose(3, 2, 0, 1))
        sd[f"dec_deconvs.{i}.bias"] = _t(b)
    k, b = layers[-1]
    sd["out_conv.weight"] = _t(k.transpose(3, 2, 0, 1))
    sd["out_conv.bias"] = _t(b)
    return sd
