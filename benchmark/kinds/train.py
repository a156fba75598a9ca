"""Training traffic: whole epochs of ``specenh_torch.train.fit`` on the
hand-written training kernels (``fit(..., epoch_fn=kernel_epoch_for(...))``),
tiles and labels resident on the device, a validation pass every epoch.
Each epoch is one ``fit`` call whose shuffle seed is drawn from the run's
seed, so every epoch has its own order.

End-to-end: ``train_tiles_per_s``, the training tiles of the whole epochs
that completed in the window over the time from the window's start to the
end of the last of them (validation inside it).

``correct``: set-up builds the one training state the window goes on
with and drives it through its first steps by the window's own call, one
``fit`` call over the first rows of the training split: whole batches,
then a last batch as short as the window's epochs end with (padded and
masked), shuffled by ``fit`` from its seed, validated on the whole
validation split.  The reference (float32, TF32 off) rebuilds that
shuffle from the same seed and follows the same steps from the same
weights.  The numbers: each step's loss, each leaf's first gradient as
Adam holds it after the first step (its first moment over 1 - beta1, read
by a hook on the optimizer's step), each leaf's change over the steps, and
the validation loss after them; the cell's limits file says which are
compared.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark.core import inputs, port
from benchmark.core.numbers import reference_off_tf32, train_leaves, train_numbers
from benchmark.reference import ae as ref_ae
from benchmark.reference import lowp


def setup(run) -> None:
    mix, cfg = run.mix, run.config
    port.build(run, ("ae_train", "ae"))
    run.mark("built")
    weights = inputs.glorot_weights(cfg["model"], run.seed, run.device)
    x = inputs.training_tiles(mix["shots"], mix["channels"], cfg["spec"], cfg["patch"],
                              mix["shot"], run.seed, run.device)
    y = (x * mix["label"]["scale"] + mix["label"]["offset"]).clamp_(0.0, 1.0)
    n = x.shape[0]
    a, b = int(mix["split"][0] * n), int(mix["split"][1] * n)
    bs = cfg["train"]["batch_size"]
    rows = check_rows(a, bs, mix["check"]["steps"])
    if rows > a:
        raise ValueError(f"{a} training tiles cannot give the check's {mix['check']['steps']} "
                         "batches")
    seeds = np.random.default_rng([run.seed, 13]).integers(0, 2**31, 2)
    run.state.update(weights=weights, x=x, y=y, train=(x[:a], y[:a]), val=(x[a:b], y[a:b]),
                     check=(x[:rows], y[:rows]), check_seed=int(seeds[1]),
                     warm_seed=int(seeds[0]))
    run.mark("inputs")
    check_steps(run)
    run.mark("check_steps")
    from specenh_torch import train as T

    # one whole epoch warms the window's call at its full size
    xt, yt = run.state["train"]
    xv, yv = run.state["val"]
    tcfg = port.train_config(run.config, seed=run.state["warm_seed"])
    T.fit(run.state["program"], xt, yt, xv, yv, tcfg, epochs=1,
          epoch_fn=run.state["epoch_fn"])


def check_rows(n_train: int, bs: int, steps: int) -> int:
    """The check's rows: ``steps - 1`` whole batches and a last batch as
    long as the one each window epoch over ``n_train`` rows ends with."""
    return (steps - 1) * bs + (n_train % bs or bs)


def check_steps(run) -> None:
    """A new state from the run's weights, driven through the check's
    steps by one ``fit`` call; what the reference compares is kept, and
    the state and the epoch function go on to the window."""
    from specenh_torch import train as T

    _, model_cfg = port.configs(run.config)
    tcfg = port.train_config(run.config)
    state = T.create_state(model_cfg, tcfg, device=run.device)
    state.model.load_state_dict(run.state["weights"])
    run.mark("state")
    epoch_fn = T.kernel_epoch_for(model_cfg, tcfg, dtype=port.DTYPES[run.config["precision"]["ae"]])
    names = dict(state.model.named_parameters())
    got: Dict = {}

    def first_gradient(opt, args, kwargs) -> None:
        if "grad" not in got:
            st = opt.state
            got["grad"] = {n: (st[p]["exp_avg"] / (1 - tcfg.beta1) if p in st
                               and "exp_avg" in st[p] else torch.zeros_like(p)).detach().clone()
                           for n, p in names.items()}

    def recording(state, *args):
        state, losses = epoch_fn(state, *args)
        got["losses"] = losses
        return state, losses

    xc, yc = run.state["check"]
    xv, yv = run.state["val"]
    hook = state.optimizer.register_step_post_hook(first_gradient)
    try:
        _, hist = T.fit(state, xc, yc, xv, yv,
                        dataclasses.replace(tcfg, seed=run.state["check_seed"]), epochs=1,
                        epoch_fn=recording)
    finally:
        hook.remove()
    got["losses"] = [float(v) for v in got["losses"].tolist()]
    got["val_loss"] = float(hist["val_loss"][0])
    got.setdefault("grad", {n: torch.zeros_like(p) for n, p in names.items()})
    got["change"] = {n: (p.detach() - run.state["weights"][n]).clone() for n, p in names.items()}
    run.state.update(program=state, epoch_fn=epoch_fn, got=got)


def window(run) -> Dict[str, float]:
    from specenh_torch import train as T

    state, epoch_fn = run.state["program"], run.state["epoch_fn"]
    xt, yt = run.state["train"]
    xv, yv = run.state["val"]
    tcfg = port.train_config(run.config)
    rng = np.random.default_rng([run.seed, 17])
    epochs, secs, losses = 0, [], []
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while True:
        te = time.perf_counter()
        with run.span("fit_epoch"):
            _, hist = T.fit(state, xt, yt, xv, yv,
                            dataclasses.replace(tcfg, seed=int(rng.integers(0, 2**31))),
                            epochs=1, epoch_fn=epoch_fn)
        secs.append(time.perf_counter() - te)
        losses.append(hist["loss"][0])
        epochs += 1
        if time.perf_counter() >= deadline:
            break
    run.window_s = time.perf_counter() - t0
    n_tr, n_va, bs = xt.shape[0], xv.shape[0], tcfg.batch_size
    run.attempted = epochs
    run.failed = sum(not math.isfinite(v) for v in losses)
    run.counters = {"epochs": epochs, "train_tiles": epochs * n_tr, "val_tiles": epochs * n_va,
                    "steps": epochs * -(-n_tr // bs), "batch": bs}
    run.spans = {"epoch": secs}
    return {"train_tiles_per_s": epochs * n_tr / run.window_s}


def release(run) -> None:
    run.state.pop("program", None)
    run.state.pop("epoch_fn", None)


def _check_batches(run):
    """The check's batches as ``fit`` makes them: its rows shuffled by
    numpy's generator from the call's seed, cut into batches, the last
    padded with row 0 and masked."""
    xc, yc = run.state["check"]
    n, bs = xc.shape[0], run.config["train"]["batch_size"]
    perm = np.random.default_rng(run.state["check_seed"]).permutation(n)
    out = []
    for a in range(0, n, bs):
        idx, mask = perm[a : a + bs], np.ones(bs, np.float32)
        if len(idx) < bs:
            mask[len(idx) :] = 0
            idx = np.concatenate([idx, np.zeros(bs - len(idx), idx.dtype)])
        i = torch.from_numpy(idx).to(xc.device)
        out.append((xc[i], yc[i], torch.from_numpy(mask).to(xc.device)))
    return out


def _reference_steps(run, control: bool) -> Dict:
    depth = len(run.config["model"]["filters"])
    q, qg = (lowp.fp8, lowp.fp8_grad) if control else (lambda v: v, lambda v: v)
    losses, grad, after = ref_ae.train_steps(run.state["weights"], _check_batches(run), depth,
                                             run.config["train"], q, qg)
    change = {k: after[-1][k] - run.state["weights"][k] for k in after[-1]}
    xv, yv = run.state["val"]
    val = ref_ae.mean_bce(after[-1], xv, yv, depth, q)
    return {"losses": losses, "grad": grad, "change": change, "val_loss": val}


def check(run, control: bool = False) -> Dict[str, float]:
    """The numbers of the check's steps: the program's, or with
    ``control`` the fp8 reference's, against the reference."""
    leaves = ref_ae.leaf_names(len(run.config["model"]["filters"]))
    with reference_off_tf32():
        ref = _reference_steps(run, control=False)
        got = _reference_steps(run, control=True) if control else run.state["got"]
    run.state["leaves"] = train_leaves(got, ref, leaves)
    return train_numbers(got, ref, leaves)
