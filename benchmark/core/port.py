"""What the benchmark takes from the program (``specenh_torch``): its
configuration types, built from a configuration file, and the build of the
cell's own CUDA libraries."""

from __future__ import annotations

import time
from typing import Dict, Sequence

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def configs(cfg: Dict):
    """(the port's ``Config`` with the STFT and the tiles, its ``ModelConfig``)."""
    from specenh_torch.config import Config, ModelConfig, PatchSpec, SpecParams

    m = cfg["model"]
    model_cfg = ModelConfig(filters=tuple(m["filters"]),
                            kernels=tuple(tuple(k) for k in m["kernels"]),
                            out_kernel=tuple(m["out_kernel"]),
                            input_shape=tuple(m["input_shape"]))
    return Config(spec=SpecParams(**cfg["spec"]), patch=PatchSpec(**cfg["patch"])), model_cfg


def train_config(cfg: Dict, **kw):
    """The port's ``TrainConfig`` with the configuration's recipe."""
    from specenh_torch.config import TrainConfig

    hp = cfg["train"]
    return TrainConfig(batch_size=hp["batch_size"], learning_rate=hp["learning_rate"],
                       beta1=hp["beta1"], beta2=hp["beta2"], adam_eps=hp["adam_eps"], **kw)


def build(run, names: Sequence[str]) -> None:
    """The cell's own libraries, compiled into the checkout's build
    directory unless already built there (nvcc in parallel); their seconds
    go into ``run.build_s``."""
    if run.device.type != "cuda":
        return
    from specenh_torch import _build

    t0 = time.perf_counter()
    run.build_s = {k: round(v, 3) for k, v in _build.build_all(tuple(names)).items()}
    run.build_s["total"] = round(time.perf_counter() - t0, 3)
