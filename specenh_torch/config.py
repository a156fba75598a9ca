"""The port's configuration: its own copy of the dataclasses of
``specenh.config`` that it uses, with the same defaults (the reference's
values).  The port imports nothing of the JAX package.

``SpecParams``: STFT (spec_denoising/pipeline_data.py:77-84);
``PatchSpec``: 256x128 tiles, 30 per spectrogram (VAE/hyperparam_scan.py:30-38);
``ModelConfig``: the conv-AE family (hyperparam_scan.py:152-165,
manual_scan.py:189-202, manual_scan_3layers.py:185-201);
``TrainConfig``: the training recipe (hyperparam_scan.py:176-184);
``PipelineConfig``: the classical label pipeline (pipeline_data.py:100-110);
``SweepConfig``: the sweep grids (hyperparam_scan.py:123, manual_scan.py:120-124,
manual_scan_3layers.py:119-123), fields only;
``PathConfig``: where the raw shots, the store and the outputs live;
``Config``: the tree of all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

__all__ = ["SpecParams", "PatchSpec", "PipelineConfig", "ModelConfig", "TrainConfig",
           "SweepConfig", "PathConfig", "Config", "MODEL_PRESETS"]


@dataclasses.dataclass(frozen=True)
class SpecParams:
    """STFT parameters: nperseg 512, noverlap 256, fs 500 kHz, periodic
    Hamming window, density scaling, per-segment linear detrend, eps 1e-11
    before the log; ``cut_shot`` seconds kept from the head of the shot."""

    nperseg: int = 512
    noverlap: int = 256
    fs: float = 500_000.0
    window: str = "hamm"
    scaling: str = "density"  # {'density', 'spectrum'}
    detrend: str = "linear"  # {'linear', 'constant', 'none'}
    eps: float = 1e-11
    cut_shot: float = 2.0

    @property
    def hop(self) -> int:
        return self.nperseg - self.noverlap

    @property
    def n_samples(self) -> int:
        return int(self.cut_shot * self.fs)

    @property
    def n_frames(self) -> int:
        return (self.n_samples - self.nperseg) // self.hop + 1

    @property
    def n_freqs_onesided(self) -> int:
        return self.nperseg // 2 + 1

    @property
    def n_freqs_kept(self) -> int:
        """The reference drops the last (Nyquist) row."""
        return self.n_freqs_onesided - 1


@dataclasses.dataclass(frozen=True)
class PatchSpec:
    """(256, 128) tiles at time step 128; 30 per 256x3905 spectrogram,
    columns 3840..3904 dropped."""

    tile_freq: int = 256
    tile_time: int = 128
    step: int = 128
    tiles_per_spec: int = 30

    @property
    def time_cols_used(self) -> int:
        return self.tiles_per_spec * self.step


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The label pipeline's fixed stages: quantfilt -> gaussblr(31,3) ->
    meansub -> morph -> meansub.  Kernel and structuring-element sizes are
    OpenCV's (width = time taps, height = freq taps); ``emulate_uint8``
    keeps every uint8 quantisation point of the OpenCV recipe (bit for
    bit), False keeps everything in float (not reference-exact)."""

    quant_threshold: float = 0.9
    gauss_ksize: Tuple[int, int] = (31, 3)
    close_se: Tuple[int, int] = (4, 4)
    open_se: Tuple[int, int] = (3, 1)
    emulate_uint8: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Convolutional denoising autoencoder: encoder widths (outermost
    first), their kernels, the kernel of the 1-channel sigmoid head, and the
    (H, W, C) tile."""

    filters: Tuple[int, ...] = (32, 32)
    kernels: Tuple[Tuple[int, int], ...] = ((3, 3), (3, 3))
    out_kernel: Tuple[int, int] = (3, 3)
    input_shape: Tuple[int, int, int] = (256, 128, 1)

    @property
    def depth(self) -> int:
        return len(self.filters)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Keras Adam defaults (eps 1e-7, not torch's 1e-8), batch 128, a
    per-epoch shuffle from ``seed``, the reference's 60/25/15 split by tile,
    and opt-in early stopping on val_loss (``patience`` stale epochs)."""

    epochs: int = 15
    batch_size: int = 128
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-7
    shuffle: bool = True
    seed: int = 0
    split_fracs: Tuple[float, float] = (0.6, 0.85)
    split_by: str = "tile"
    patience: int | None = None


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Sweep grids: the array sweep's kernels, the 2-layer manual scan's
    five axes and the 3-layer scan's four, and the epochs of a config."""

    kernel_vals: Sequence[Tuple[int, int]] = ((3, 3), (5, 5), (7, 7))
    ker1_vals: Sequence[Tuple[int, int]] = ((5, 5),)
    ker2_vals: Sequence[Tuple[int, int]] = ((5, 5),)
    ker3_vals: Sequence[Tuple[int, int]] = ((5, 5),)
    conv1_vals: Sequence[int] = (64,)
    conv2_vals: Sequence[int] = (32,)
    conv3_vals: Sequence[int] = (64,)
    ker_vals_3layer: Sequence[Tuple[int, int]] = ((5, 5),)
    conv1_vals_3layer: Sequence[int] = (16,)
    conv2_vals_3layer: Sequence[int] = (32,)
    conv3_vals_3layer: Sequence[int] = (64,)
    epochs: int = 100


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Filesystem layout: the raw shots, the HDF5 store, the outputs."""

    data_dir: str = "data/raw"
    dataset_file: str = "data/spectrogram_data.hdf5"
    out_dir: str = "out"
    frames_dir: str = "out/frames"


@dataclasses.dataclass(frozen=True)
class Config:
    spec: SpecParams = dataclasses.field(default_factory=SpecParams)
    patch: PatchSpec = dataclasses.field(default_factory=PatchSpec)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    sweep: SweepConfig = dataclasses.field(default_factory=SweepConfig)
    paths: PathConfig = dataclasses.field(default_factory=PathConfig)


MODEL_PRESETS = {
    "scan_k3": ModelConfig(filters=(32, 32), kernels=((3, 3), (3, 3)), out_kernel=(3, 3)),
    "scan_k5": ModelConfig(filters=(32, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    "scan_k7": ModelConfig(filters=(32, 32), kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
    "manual": ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    "deep3": ModelConfig(
        filters=(16, 32, 64), kernels=((5, 5), (5, 5), (5, 5)), out_kernel=(5, 5)
    ),
    "graphs": ModelConfig(filters=(32, 32), kernels=((3, 3), (3, 3)), out_kernel=(3, 3)),
}
