"""Figures, host-side matplotlib: the sweep's loss figure ``plot_val_loss``
(hyperparam_scan.py:209-212) and the SVD denoiser's ``plot_svd_compare``
(denoising_by_svd.ipynb cell 3), copies of the JAX package's functions,
held equal to them by ``tests/test_torch_guard.py``.  Import it inside the call
that plots: the card need not have matplotlib.
"""

from __future__ import annotations

from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

__all__ = ["plot_val_loss", "plot_svd_compare"]


def plot_val_loss(val_loss: Sequence[float], fname_png: str, fname_txt: Optional[str] = None):
    """val_loss.png / val_loss.txt artifacts (hyperparam_scan.py:209-212)."""
    fig = plt.figure()
    plt.plot(range(len(val_loss)), val_loss)
    fig.savefig(fname_png)
    plt.close(fig)
    if fname_txt:
        np.savetxt(fname_txt, np.asarray(val_loss))


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
