"""Frame dump and movie render (graphs.ipynb cells 18-19), copies of
``specenh.viz.movie``, held equal to them by ``tests/test_torch_guard.py``.

``dump_frames`` writes one freq-x-channel JPG a time frame, named
``s<shot>-f<NNNNN>.jpg``; ``render_movie`` stitches them into an mp4 with
``cv2.VideoWriter`` (H264, else avc1, else mp4v).  It loads matplotlib
(through ``viz.plots``): import it inside the call that draws.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from specenh_torch.viz.plots import plot_frame_view

__all__ = ["dump_frames", "render_movie"]


def dump_frames(
    noisy: np.ndarray,
    processed: np.ndarray,
    predictions: np.ndarray,
    t: np.ndarray,
    f: np.ndarray,
    shotn,
    out_dir: str,
    start: int = 0,
    stop: Optional[int] = None,
) -> int:
    """Write per-frame JPGs (graphs.ipynb cell 18).  Inputs are
    (n_freq, n_frames, n_channels) stacks.  Returns frames written."""
    os.makedirs(out_dir, exist_ok=True)
    n_frames = noisy.shape[1]
    stop = n_frames if stop is None else min(stop, n_frames)
    for i in range(start, stop):
        fname = os.path.join(out_dir, "s%s-f%s.jpg" % (shotn, str(i).zfill(5)))
        plot_frame_view(noisy, processed, predictions, i, shotn, t, f, fname)
    return stop - start


def render_movie(frames_dir: str, shotn, fps: int = 30) -> str:
    """Stitch ``s<shot>-f*.jpg`` frames into <frames_dir>/<shot>.mp4
    (graphs.ipynb cell 19)."""
    import cv2

    frmlist = sorted(glob.glob(os.path.join(frames_dir, f"s{shotn}-f*.jpg")))
    if not frmlist:
        raise FileNotFoundError(f"no frames for shot {shotn} in {frames_dir}")
    img = cv2.imread(frmlist[0])
    height, width, _ = img.shape
    out_path = os.path.join(frames_dir, f"{shotn}.mp4")
    for fourcc_name in ("H264", "avc1", "mp4v"):
        fourcc = cv2.VideoWriter_fourcc(*fourcc_name)
        writer = cv2.VideoWriter(out_path, fourcc, fps, (width, height))
        if writer.isOpened():
            break
    else:  # pragma: no cover
        raise RuntimeError("no usable VideoWriter codec")
    for fname in frmlist:
        writer.write(cv2.imread(fname))
    writer.release()
    return out_path
