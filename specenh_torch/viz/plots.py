"""Figures, host-side matplotlib: the reference's figures as copies of
``specenh.viz.plots``, held equal to them by ``tests/test_torch_guard.py``:
``display`` (random original/enhanced pairs, hyperparam_scan.py:59-82),
``plt_spec_shot`` (the raw/predicted/pipeline triptych, :84-117), the
label pipeline's stages (denoising_spectrogram.ipynb cells 4-5), the SVD
denoiser's 4-row compare (denoising_by_svd.ipynb cell 3), the
freq-x-channel frame view (graphs.ipynb cell 17) and the loss figure
(hyperparam_scan.py:209-212).  Import it inside the call that plots: the
card need not have matplotlib.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.gridspec as gridspec
import matplotlib.pyplot as plt
import numpy as np

__all__ = [
    "display",
    "plt_spec_shot",
    "plot_stages",
    "plot_svd_compare",
    "plot_frame_view",
    "plot_val_loss",
]


def _axes(sp_f: np.ndarray, sp_t: np.ndarray, img=None):
    """The reference plots f in 'kHz' as (f/1000)+1 and t truncated to the
    tiled width (hyperparam_scan.py:62-63)."""
    t_ax = np.asarray(sp_t)
    f_ax = (np.asarray(sp_f) / 1000.0) + 1
    if img is not None:
        f_ax, t_ax = f_ax[: img.shape[-2]], t_ax[: img.shape[-1]]
    return t_ax, f_ax


def display(sxx, final, fname: str, f: np.ndarray, t: np.ndarray, n: int = 5, seed=None):
    """n random (original, enhanced) spectrogram pairs
    (``display``, hyperparam_scan.py:59-82)."""
    sxx = np.asarray(sxx)
    final = np.asarray(final)
    t_ax, f_ax = _axes(f, t, sxx)
    rng = np.random.default_rng(seed)
    idx = rng.integers(len(sxx), size=n)
    fig = plt.figure(figsize=(8, 12))
    grd = gridspec.GridSpec(ncols=1, nrows=2 * n, figure=fig)
    for i, j in enumerate(idx):
        ax = fig.add_subplot(grd[2 * i])
        ax.pcolormesh(t_ax, f_ax, sxx[j], cmap="hot", shading="gouraud")
        ax.set_ylabel("Original (kHz)")
        ax2 = fig.add_subplot(grd[2 * i + 1])
        ax2.pcolormesh(t_ax, f_ax, final[j], cmap="hot", shading="gouraud")
        ax2.set_ylabel("Final (kHz)")
    fig.savefig(fname)
    plt.close(fig)


def plt_spec_shot(noisy, predicted, pipeline, shotn, chn, fname: str, f, t):
    """Raw / predicted / pipeline triptych (plt_spec_shot,
    hyperparam_scan.py:84-117).  All three are (256, 3840) spectrograms."""
    t_ax, f_ax = _axes(f, t, np.asarray(noisy))
    fig = plt.figure(figsize=(8, 12))
    grd = gridspec.GridSpec(ncols=1, nrows=3, figure=fig)
    rows = [
        (np.asarray(noisy), "Original - Raw Data (kHz)"),
        (np.asarray(predicted), "Predicted Denoised (kHz)"),
        (np.asarray(pipeline), "Pipeline (kHz)"),
    ]
    for i, (img, label) in enumerate(rows):
        ax = fig.add_subplot(grd[i])
        ax.pcolormesh(t_ax, f_ax, img[:, : len(t_ax)], cmap="hot", shading="gouraud")
        ax.set_ylabel(label)
        if i == 0:
            ax.set(title=f"shot# {shotn}, channel {chn}")
    fig.savefig(fname)
    plt.close(fig)


def plot_stages(stages: Dict[str, np.ndarray], spec, fname: str, f, t):
    """Original + quant/gauss/mean(/morph/final) stage plot
    (denoising_spectrogram.ipynb cell 5)."""
    t_ax, f_ax = _axes(f, t)
    names = ["Original"] + list(stages.keys())
    imgs = [np.asarray(spec)] + [np.asarray(v) for v in stages.values()]
    fig = plt.figure(figsize=(8, 3 * len(imgs)))
    grd = gridspec.GridSpec(ncols=1, nrows=len(imgs), figure=fig)
    for i, (img, name) in enumerate(zip(imgs, names)):
        ax = fig.add_subplot(grd[i])
        ax.pcolormesh(t_ax[: img.shape[1]], f_ax[: img.shape[0]], img, cmap="hot", shading="gouraud")
        ax.set_ylabel(name)
    fig.savefig(fname)
    plt.close(fig)


def plot_svd_compare(spec, processed, svded, shotn: str, channel: int, fname: str):
    """4-row spectrogram/processed/SVD'd/SVD'd>0 compare with log-density
    histograms (denoising_by_svd.ipynb cell 3)."""
    hacked = np.asarray(svded).copy()
    hacked[hacked < 0.0] = 0.0
    datas = [np.asarray(spec), np.asarray(processed), np.asarray(svded), hacked]
    titles = ["spectrogram", "processed", "SVD'd", "SVD'd > 0"]
    fig, axs = plt.subplots(
        4, 2, sharex="col", figsize=(16, 12), gridspec_kw={"width_ratios": [3, 1]}
    )
    fig.suptitle("BES, shot number: {:s}, channel: {:02d}".format(str(shotn), channel))
    for ax, d, title in zip(axs, datas, titles):
        nvals, edges = np.histogram(d.flatten(), bins=50, density=True)
        ax[1].bar(x=edges[:-1], height=nvals, width=(edges[1] - edges[0]), align="edge")
        ax[1].set_yscale("log")
        ax[0].imshow(d, origin="lower", aspect="auto", cmap="hot")
        ax[0].set_ylabel("f (kHz)")
        ax[0].set_title(title)
    axs[-1][0].set_xlabel("time (ms)")
    fig.savefig(fname)
    plt.close(fig)


def plot_frame_view(
    noisy, processed, predictions, frm: int, shotn, t, f, fname: str
):
    """freq x channel view at a fixed time frame (graphs.ipynb cell 17):
    inputs are (n_freq, n_frames, n_channels) stacks."""
    noisy = np.asarray(noisy)
    n_ch = noisy.shape[2]
    t_ax = np.asarray(t)
    f_ax = (np.asarray(f) / 1000.0) + 1
    caption = "shot# %s, fr# %i/%i, t:%ims" % (shotn, frm, noisy.shape[1], t_ax[frm] * 1000)
    fig = plt.figure(figsize=(9, 6))
    grd = gridspec.GridSpec(ncols=1, nrows=3, figure=fig)
    rows = [
        (noisy, dict(ylabel="Freq. (KHz)", yscale="linear", xticks=[], title=caption)),
        (np.asarray(processed), dict(ylabel="Freq. (KHz)", yscale="linear", xticks=[])),
        (np.asarray(predictions), dict(ylabel="Freq. (KHz)", yscale="linear", xlabel="ECE Channel")),
    ]
    for i, (img, kw) in enumerate(rows):
        ax = fig.add_subplot(grd[i])
        ax.pcolormesh(range(n_ch), f_ax, img[:, frm, :], cmap="hot", shading="gouraud")
        ax.set(**kw)
    fig.savefig(fname)
    plt.close(fig)


def plot_val_loss(val_loss: Sequence[float], fname_png: str, fname_txt: Optional[str] = None):
    """val_loss.png / val_loss.txt artifacts (hyperparam_scan.py:209-212)."""
    fig = plt.figure()
    plt.plot(range(len(val_loss)), val_loss)
    fig.savefig(fname_png)
    plt.close(fig)
    if fname_txt:
        np.savetxt(fname_txt, np.asarray(val_loss))
