"""specenh_torch — the PyTorch/CUDA port of specenh for NVIDIA Hopper.

The JAX package ``specenh`` stays the reference; this package runs the
serving path (raw shot -> STFT -> depth-2 conv-AE -> restitch), the
dataset build (``pipeline``: raw shots -> spectrograms + classical-pipeline
labels -> HDF5 store), the training path (``train.fit`` on the kernel
engine; ``e2e``: raw shots -> model with no store), sweeps and the
analyses (``ops.svd``, ``ops.crosspower``) on an H100, with every
TPU kernel of those paths rewritten by hand in CUDA C++
(``specenh_torch/csrc``).  Each kernel wrapper launches its kernel for a
CUDA tensor and runs its plain PyTorch twin for a CPU tensor.

The package imports torch, numpy and scipy, and nothing of ``specenh``: it
keeps its own copies of what it needs (``config``, ``bench.reference``,
``io``).  h5py is imported only where a store file is opened.
"""

__version__ = "0.2.0"

from specenh_torch.config import (MODEL_PRESETS, Config,  # noqa: F401
                                  ModelConfig, PatchSpec, PathConfig,
                                  PipelineConfig, SpecParams, SweepConfig,
                                  TrainConfig)

__all__ = ["Config", "ModelConfig", "PatchSpec", "PathConfig", "PipelineConfig",
           "SpecParams", "SweepConfig", "TrainConfig", "MODEL_PRESETS"]
