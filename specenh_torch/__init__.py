"""specenh_torch — the PyTorch/CUDA port of specenh for NVIDIA Hopper.

The JAX package ``specenh`` stays the reference; this package runs the same
serving path (raw shot -> STFT -> depth-2 conv-AE -> restitch) on an H100,
with every TPU kernel of that path rewritten by hand in CUDA C++
(``specenh_torch/csrc``).  Each kernel wrapper launches its kernel for a
CUDA tensor and runs its plain PyTorch twin for a CPU tensor.

Only ``specenh.config`` is shared with the JAX package: it is plain
dataclasses, and ``specenh/__init__.py`` guards its jax import, so this
package imports on a machine without jax.
"""

__version__ = "0.1.0"

from specenh.config import ModelConfig, PatchSpec, SpecParams  # noqa: F401

__all__ = ["ModelConfig", "PatchSpec", "SpecParams"]
