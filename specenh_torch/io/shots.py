"""Raw shot readers (host side): a copy of ``specenh.io.shots``.

Mirrors the reference's three loaders:

* ECE pickle shots:  key ``'\\tecef%.2i' % chn`` — NOTE this is a LITERAL
  backslash + 'tecef01' (an MDSplus-style tag name), not a tab: the
  reference source (spec_denoising/pipeline_data.py:30) contains a
  double-backslash literal.  20-40 channels of raw digitizer floats.
* BES pickle shots:  key ``'besfu{:02d}'.format(chn)``, nested field
  ``'data.BES'`` (denoising_by_svd.ipynb cell 1); 30 channels.
* Interferometer HDF5 chord pairs + shot index + time base
  (interferometer/crosspowerspec.py:8-22,29-38).

Pure host code (pickle/h5py); traces go to device as one batched array.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ece_key",
    "bes_key",
    "read_ece_channels",
    "read_bes_channels",
    "shot_number_from_path",
    "load_time_series_tensor",
    "lookup_fid",
    "ShotReadError",
]


class ShotReadError(RuntimeError):
    """Raised for unreadable/corrupt shot files (callers quarantine these —
    the reference's try/except-continue at pipeline_data.py:118-122, minus
    its unimported-traceback crash bug)."""


def ece_key(chn: int) -> str:
    """``'\\tecef%.2i' % chn`` — literal backslash prefix."""
    return "\\tecef%.2i" % chn


def bes_key(chn: int) -> str:
    return "besfu{:02d}".format(chn)


def _load_pickle(fname: str):
    try:
        with open(fname, "rb") as fh:
            return pickle.load(fh)
    # EOFError (truncated/empty file) and IndexError (bad opcode stream)
    # are file-corruption modes and safe to quarantine.  ImportError /
    # AttributeError from pickle.load usually mean a broken ENVIRONMENT
    # (module/version skew) — those must crash loudly, not quarantine the
    # shot: campaigns skip quarantined shots permanently on resume.
    except (pickle.UnpicklingError, EOFError, IndexError) as e:
        raise ShotReadError(f"corrupt pickle {fname}: {e}") from e
    except OSError as e:
        raise ShotReadError(f"unreadable {fname}: {e}") from e


def read_ece_channels(
    fname: str, channels: Sequence[int], n_samples: Optional[int] = None
) -> np.ndarray:
    """Read ECE channels (1-based, per the reference's ``chn+1`` loops) into
    one (C, n_samples) float32 array, truncating each trace like ``specgr``
    (pipeline_data.py:31).  Raises ShotReadError on corrupt files or missing
    keys."""
    data = _load_pickle(fname)
    out: List[np.ndarray] = []
    for chn in channels:
        key = ece_key(chn)
        if key not in data:
            raise ShotReadError(f"{fname}: missing channel key {key!r}")
        sig = np.asarray(data[key], dtype=np.float32)
        out.append(sig[:n_samples] if n_samples else sig)
    n = min(len(s) for s in out)
    return np.stack([s[:n] for s in out])


def read_bes_channels(
    fname: str, channels: Sequence[int], n_samples: Optional[int] = None
) -> np.ndarray:
    """BES variant: ``data[key]['data.BES']`` (denoising_by_svd.ipynb)."""
    data = _load_pickle(fname)
    out: List[np.ndarray] = []
    for chn in channels:
        key = bes_key(chn)
        if key not in data:
            raise ShotReadError(f"{fname}: missing channel key {key!r}")
        sig = np.asarray(data[key]["data.BES"], dtype=np.float32)
        out.append(sig[:n_samples] if n_samples else sig)
    n = min(len(s) for s in out)
    return np.stack([s[:n] for s in out])


def shot_number_from_path(fname: str) -> str:
    """``fname[fname.rfind('_')+1 : fname.rfind('.')]``
    (pipeline_data.py:93) — e.g. 'ece_176053.pkl' -> '176053'."""
    return fname[fname.rfind("_") + 1 : fname.rfind(".")]


# --- interferometer (crosspowerspec.py) ------------------------------------

_CHORD_DATASETS = {
    ("v1", "v3"): ("dp1v1uf", "dp1v3uf"),
    ("v2", "r0"): ("dp1v2uf", "dp1r0uf"),
}


def load_time_series_tensor(
    base_dir: str, fid: int, chord1: str, chord2: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``load_time_series_tensor`` (crosspowerspec.py:8-22) with the GPFS
    prefix replaced by ``base_dir``.  Layout:
    <base>/<c1><c2>/signal{1,2}_<fid>.h5 and <base>/shots_<fid>.h5."""
    import h5py

    key = (chord1, chord2)
    if key not in _CHORD_DATASETS:
        raise ValueError(f"unsupported chord pair {key}; one of {list(_CHORD_DATASETS)}")
    ds1, ds2 = _CHORD_DATASETS[key]
    pair_dir = os.path.join(base_dir, f"{chord1}{chord2}")
    with h5py.File(os.path.join(pair_dir, f"signal1_{fid}.h5"), "r") as f:
        signal1 = f[ds1][()]
    with h5py.File(os.path.join(pair_dir, f"signal2_{fid}.h5"), "r") as f:
        signal2 = f[ds2][()]
    with h5py.File(os.path.join(base_dir, f"shots_{fid}.h5"), "r") as f:
        shots = f["shot"][()]
    return signal1, signal2, np.asarray(shots[:, 0].astype(int))


def lookup_fid(fid_file: str, shotnum: int) -> int:
    """File-ID lookup from fid.txt (crosspowerspec.py:29-31).

    Reference quirk kept: ``(file_ids <= shotnum).argmin()`` is the
    reference's exact expression — when shotnum is beyond EVERY entry the
    all-True mask argmins to index 0 and the first file id is returned."""
    file_ids = np.genfromtxt(fid_file, dtype=int)
    i = int((file_ids <= shotnum).argmin())
    return int(file_ids[i])
