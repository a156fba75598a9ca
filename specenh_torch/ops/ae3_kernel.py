"""K8-in + K6 + K8-out, depth-3 conv-AE inference on the spectrograms (the
counterpart of ``specenh.ops.ae3_kernel`` and the depth-3 tile turns of
``specenh.ops.parity_turn``), for the deep3 preset (filters (16, 32, 64),
k5; VAE/manual_scan_3layers.py:185-233) and the geometries ``supports3``
accepts.

The depth-3 AE runs the same stage kernels of ``csrc/ae.cu`` as the depth-2
one (``ops.ae_kernel``), over a layer table of seven layers:

  ae_tile_in    S1  K8-in (tile load + cast) fused with conv0 + relu + pool
  ae_conv_pool  S2  conv1, conv2 + relu + pool                   (K6)
  ae_convt      S3  the three stride-2 transposed convs + relu   (K6)
  ae_tile_out   S4  out-conv + sigmoid fused with K8-out (restitched store)

The TPU kernel's x64 parity rows, interleaved lanes, host-scattered first
conv and hi/lo bf16 output split worked around Mosaic and VMEM; here
activations are NCHW per tile in device memory and the output is stored in
float32.  The stage chain of ``ae_kernel`` is depth-generic, so the
depth-3 functions below are its own under the JAX package's names;
``build_kernel3_weights`` raises for a geometry ``supports3`` does not
accept.
"""

from __future__ import annotations

import torch

from specenh_torch.models.autoencoder import ConvAutoencoder
from specenh_torch.ops.ae_kernel import (AEKernelWeights, ae_kernel_apply,
                                         ae_kernel_enhance_specs,
                                         ae_kernel_enhance_specs_plain,
                                         build_kernel_weights, supports3)

__all__ = ["supports3", "build_kernel3_weights", "ae3_kernel_enhance_specs",
           "ae3_kernel_apply", "ae3_kernel_enhance_specs_plain"]


def build_kernel3_weights(model: ConvAutoencoder, dtype=torch.bfloat16
                          ) -> AEKernelWeights:
    """The depth-3 kernels' weights from the module, on its device."""
    return build_kernel_weights(model, dtype, depth=3)


ae3_kernel_enhance_specs = ae_kernel_enhance_specs
ae3_kernel_apply = ae_kernel_apply
ae3_kernel_enhance_specs_plain = ae_kernel_enhance_specs_plain
