"""K7, depth-3 conv-AE training on the CUDA stage kernels (the counterpart
of ``specenh.ops.ae3_train_kernel``), for the geometries ``supports3``
accepts (the deep3 preset: filters (16, 32, 64), k5;
VAE/manual_scan_3layers.py:185-214).

A step runs the depth-generic stages of ``ops.ae_train_kernel`` over the
seven-layer table:

  forward   ae_train_in         conv0 + relu + pool, routing bits
            ae_train_conv_pool  conv1, conv2 + relu + pool, routing bits
            ae_convt (ae.cu)    the three transposed convs + relu
            ae_train_loss       out-conv -> logits, masked BCE sum, dz
  backward  out-conv:      ae_train_wgrad, ae_train_dgrad_conv gated by
                           relu of its input
            convT0, T1:    ae_train_wgrad, ae_train_dgrad_convt gated by
                           relu of their inputs
            convT2:        ae_train_wgrad, ae_train_dgrad_convt gated by
                           conv2's routing bits
            conv2, conv1:  ae_train_wgrad, ae_train_dgrad_conv, dz routed
                           through the level's bits, gated by the next
                           level's
            conv0:         ae_train_wgrad_x

with the TPU kernel's semantics: the gradient to every maximal phase of a
pool window whose max is > 0, relu'(0) = 0, every dz rounded to the kernel
dtype once before both of its products, float32 sums.  The TPU kernel
trained scattered operands (``TrainMaps3``, the one-hot tap matmul of its
first conv); here the stages read the module's weights in the kernels'
layout and the gradients come back in torch's.  There is no pre-cast
variant (the JAX package has no K7b).  The functions below are those of
``ops.ae_train_kernel`` held to depth 3: each raises for a geometry that
``supports3`` does not accept.
"""

from __future__ import annotations

import torch

from specenh_torch.config import ModelConfig
from specenh_torch.models.autoencoder import ConvAutoencoder
from specenh_torch.ops import ae_train_kernel as TK
from specenh_torch.ops.ae_kernel import supports3

__all__ = ["supports3", "build_train3_weights", "kernel_loss_grad_sums3",
           "kernel_loss_grad_sums3_plain", "kernel_bce_sum3",
           "kernel_value_and_grad3", "make_kernel_train_step3",
           "kernel_train_epoch_fn3"]


def build_train3_weights(model: ConvAutoencoder, dtype=torch.bfloat16
                         ) -> TK.TrainWeights:
    """The depth-3 kernels' weights, forward and input-gradient operands."""
    return TK.build_train_weights(model, dtype, depth=3)


def kernel_loss_grad_sums3(model: ConvAutoencoder, x, y, mask,
                           dtype=torch.bfloat16):
    """UNNORMALISED (bce_sum, mask_sum, grad_sums) of one batch from the
    stage kernels; ``grad_sums`` keyed like ``model.named_parameters()``."""
    return TK.loss_grad_sums(build_train3_weights(model, dtype), x, y, mask)


def kernel_loss_grad_sums3_plain(model: ConvAutoencoder, x, y, mask,
                                 dtype=torch.bfloat16):
    """The plain twin of ``kernel_loss_grad_sums3``, on any device."""
    return TK.loss_grad_sums(build_train3_weights(model, dtype), x, y, mask,
                             plain=True)


def kernel_bce_sum3(model: ConvAutoencoder, x, y, mask, dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """The masked BCE sum as a differentiable scalar: ``.backward()`` writes
    the module's ``.grad``s from the backward stage kernels."""
    return TK.bce_sum(build_train3_weights(model, dtype), model, x, y, mask)


def kernel_value_and_grad3(model: ConvAutoencoder, x, y, mask,
                           dtype=torch.bfloat16):
    """(mean masked BCE, gradients keyed like ``named_parameters``)."""
    return TK.normalise(kernel_loss_grad_sums3(model, x, y, mask, dtype))


def make_kernel_train_step3(cfg: ModelConfig, dtype=torch.bfloat16):
    """``step(state, x, y, mask) -> (state, loss)`` on the depth-3 stage
    kernels, then the state's optimizer (Adam)."""
    return TK.make_kernel_train_step(cfg, dtype, depth=3)


def kernel_train_epoch_fn3(cfg: ModelConfig, dtype=torch.bfloat16):
    """``epoch(state, x, y, batch_idx, batch_mask) -> (state, losses)`` on
    the depth-3 stage kernels, the ``train.train_epoch`` equivalent."""
    return TK.kernel_train_epoch_fn(cfg, dtype, depth=3)
