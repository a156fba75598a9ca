"""The sweep's loss figure, host-side matplotlib: ``plot_val_loss``
(hyperparam_scan.py:209-212), a copy of the JAX package's function, held
equal to it by ``tests/test_torch_guard.py``.  Import it inside the call
that plots: the card need not have matplotlib.
"""

from __future__ import annotations

from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

__all__ = ["plot_val_loss"]


def plot_val_loss(val_loss: Sequence[float], fname_png: str, fname_txt: Optional[str] = None):
    """val_loss.png / val_loss.txt artifacts (hyperparam_scan.py:209-212)."""
    fig = plt.figure()
    plt.plot(range(len(val_loss)), val_loss)
    fig.savefig(fname_png)
    plt.close(fig)
    if fname_txt:
        np.savetxt(fname_txt, np.asarray(val_loss))
