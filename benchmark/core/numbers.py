"""The numbers that decide ``correct``: what the timed path produced
against the plain reference's answer on the same inputs.  Each cell's
limits file (``limits/<workload>.json``) names the numbers it compares
and their limits; the rest are printed only.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence, Tuple

import torch



@contextlib.contextmanager
def reference_off_tf32() -> Iterator[None]:
    """float32 products in float32 (TF32 off) inside, as they were after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


SERVE_NUMBERS = ("spec_max_abs", "enh_tile_nrmse")


def serve_numbers(got: Tuple[torch.Tensor, torch.Tensor],
                  ref: Tuple[torch.Tensor, torch.Tensor], tile: int = 128) -> Dict[str, float]:
    """One shot's (specs, enhanced) against the reference's:
    ``spec_max_abs`` the spectrograms' widest gap; ``enh_tile_nrmse`` the
    enhanced spectrograms' worst tile's RMS gap in units of its channel's
    standard deviation in the reference (with random weights the enhanced
    images are of low contrast around 0.5)."""
    (s, e), (rs, re) = got, ref
    if s.shape != rs.shape or e.shape != re.shape:
        return dict.fromkeys(SERVE_NUMBERS, float("inf"))
    de = e.double() - re.double()
    c, f, t = e.shape
    sd = re.double().std(dim=(1, 2))                                 # (C,)
    tile_rms = de[..., : t - t % tile].reshape(c, f, -1, tile).pow(2).mean(dim=(1, 3)).sqrt()
    return {
        "spec_max_abs": float((s.double() - rs.double()).abs().max()),
        "enh_tile_nrmse": float((tile_rms / sd[:, None]).max()),
    }


def _leaf_gaps(got: Sequence[float], ref: Sequence[float],
               keep: Sequence[bool]) -> float:
    """The worst leaf's gap between two norms, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    kept = sorted(r for r, k in zip(ref, keep) if k)
    med = kept[len(kept) // 2] if kept else 0.0
    gaps = [abs(g - r) / max(r, med) for g, r, k in zip(got, ref, keep) if k]
    return max(gaps) if gaps else float("inf")


def train_numbers(got: Dict, ref: Dict, leaves: List[str]) -> Dict[str, float]:
    """The first steps of training against the reference's: ``got`` and
    ``ref`` hold ``losses`` (each step's), ``grad`` (the first step's
    gradient by leaf), ``change`` (each leaf's change over the steps) and
    ``val_loss`` (the validation loss after them).
    ``loss_gap``: the worst step's relative gap; ``val_gap``: the
    validation loss's; ``grad_gap`` and
    ``change_gap``: the worst leaf's gap between the two norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; ``grad_diff``: the norm of the whole first gradient's
    difference over the reference's norm (it separates a batch's half left
    out from rounding, which the norms cannot).  A leaf whose reference
    gradient is under a thousandth of the median leaf's moves by round-off
    alone and is left out of the change."""
    g_ref = [float(ref["grad"][k].norm()) for k in leaves]
    g_med = sorted(g_ref)[len(g_ref) // 2]
    moves = [g >= 1e-3 * g_med for g in g_ref]
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    if len(got["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    g_diff = sum(float((got["grad"][k] - ref["grad"][k]).norm()) ** 2 for k in leaves)
    return {
        "loss_gap": max(losses),
        "val_gap": abs(got["val_loss"] - ref["val_loss"]) / abs(ref["val_loss"]),
        "grad_diff": (g_diff / sum(g * g for g in g_ref)) ** 0.5,
        "grad_gap": _leaf_gaps([float(got["grad"][k].norm()) for k in leaves], g_ref,
                               [True] * len(leaves)),
        "change_gap": _leaf_gaps([float(got["change"][k].norm()) for k in leaves],
                                 [float(ref["change"][k].norm()) for k in leaves], moves),
        "leaves_left_out": float(len(leaves) - sum(moves)),
    }


def train_leaves(got: Dict, ref: Dict, leaves: List[str]) -> Dict[str, List[float]]:
    """Each leaf's first-gradient norms, the norm of their difference, and
    its change's norms: what the numbers above are taken from."""
    n = lambda t: float(t.norm())
    return {k: [n(got["grad"][k]), n(ref["grad"][k]), n(got["grad"][k] - ref["grad"][k]),
                n(got["change"][k]), n(ref["change"][k])] for k in leaves}
