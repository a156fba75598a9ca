"""The JAX package's numpy-only reference code, loaded by file path.

``specenh/bench/reference_cpu.py`` (the SciPy spectrogram recipe) and
``specenh/utils/metrics.py`` (SSIM) need only numpy, scipy and
``specenh.config``.  Importing them as ``specenh.bench.*`` or
``specenh.utils.*`` would run those packages' ``__init__`` files, which
import jax; loading the two files by path keeps jax out, so the port's
checks run where jax is not installed.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import numpy as np

from specenh.config import SpecParams

__all__ = ["spectrogram_ref", "ssim"]

_SPECENH = Path(__file__).resolve().parents[2] / "specenh"


@functools.cache
def _load(relpath: str):
    path = _SPECENH / relpath
    spec = importlib.util.spec_from_file_location(
        "_specenh_ref_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spectrogram_ref(sig: np.ndarray, sp: SpecParams) -> np.ndarray:
    """The reference recipe (SciPy) for one channel: (256, n_frames)."""
    return _load("bench/reference_cpu.py").spectrogram_ref(sig, sp)[0]


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Mean SSIM, data range 1 (skimage defaults, uniform 7x7 window)."""
    return _load("utils/metrics.py").ssim(a, b)
