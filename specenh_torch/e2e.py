"""Raw traces -> trained model on the device, with no store in between (the
counterpart of ``specenh.e2e``):

    raw traces (C_total, n_samples)          [one upload, the only transfer]
      -> K1 STFT + classical_pipeline()       [device: process_shot_fn]
      -> patch -> 60/25/15 split              [device]
      -> fit()                                [device]

The front is the dataset build's (``pipeline.process_shot_fn``: K1 where
``stft_fused.supported`` admits the geometry, else the matmul STFT, then
the label pipeline), so the tiles are the ones a store built by
``build_dataset`` would hold.  The HDF5 store stays the durable artifact
path (``pipeline``); this module is the path when you want a model, not a
dataset.  Everything runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from specenh_torch.config import Config, ModelConfig, TrainConfig
from specenh_torch.data.tiles import patch
from specenh_torch.pipeline import process_shot_fn
from specenh_torch.train import TrainState, create_state, fit

__all__ = ["prepare_tiles_on_device", "train_from_raw"]


def prepare_tiles_on_device(traces, cfg: Config, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, n_samples) raw traces (numpy or a tensor) -> (tiles_x, tiles_y),
    (C * k, 256, 128, 1) float32 on ``device``: the reference's spec and
    pipeline_out tile pairs, channel-major."""
    specs, labels = process_shot_fn(cfg, device)(traces)
    return patch(specs, cfg.patch)[..., None], patch(labels, cfg.patch)[..., None]


def train_from_raw(
    traces,
    cfg: Config = Config(),
    model_cfg: Optional[ModelConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    epochs: Optional[int] = None,
    channels_per_shot: int = 1,
    dtype=None,
    verbose: bool = False,
    device="cuda",
    **fit_kwargs,
) -> Tuple[TrainState, Dict[str, list]]:
    """Raw shot batch -> trained autoencoder, all compute on ``device``.

    ``traces``: (C_total, n_samples), e.g. every channel of a campaign
    stacked shot-major (all channels of shot 0, then shot 1, ...).  The
    split follows ``train_cfg.split_by``: ``'tile'`` is the reference's
    leaky tile-level 60/25/15 (hyperparam_scan.py:148-149); ``'shot'``
    splits the SHOT list before tiling (dataset.ipynb cell 3) — pass
    ``channels_per_shot`` so all channels of one physical shot land on the
    same side (the default 1 treats each trace as its own shot).

    ``dtype`` goes to ``create_state`` (bf16 autograd); engine swaps ride
    ``fit_kwargs`` (``epoch_fn=kernel_epoch_for(...)`` for the CUDA
    training kernels: the CLI's ``train-raw --engine kernel``).
    """
    model_cfg = model_cfg or cfg.model
    train_cfg = train_cfg or cfg.train
    x, y = prepare_tiles_on_device(traces, cfg, device)
    n = x.shape[0]
    if train_cfg.split_by == "shot":
        n_ch = traces.shape[0]
        if n_ch % channels_per_shot:
            raise ValueError(
                f"{n_ch} traces do not group into shots of "
                f"{channels_per_shot} channels"
            )
        n_shots = n_ch // channels_per_shot
        k = (n // n_ch) * channels_per_shot  # tiles per shot
        a_s = int(n_shots * train_cfg.split_fracs[0])
        b_s = int(n_shots * train_cfg.split_fracs[1])
        if a_s == 0 or b_s == a_s:
            raise ValueError(
                f"{n_shots} shots are too few for a shot-level "
                f"{train_cfg.split_fracs} split (train or tune would be "
                "empty); add shots or use split_by='tile'"
            )
        a, b = a_s * k, b_s * k
    else:
        a, b = int(n * train_cfg.split_fracs[0]), int(n * train_cfg.split_fracs[1])
    state = create_state(model_cfg, train_cfg, device=device, dtype=dtype)
    return fit(state, x[:a], y[:a], x[a:b], y[a:b], train_cfg, epochs=epochs,
               verbose=verbose, **fit_kwargs)
