"""Faults planted under the timed path, to show that the check catches
them: context managers that patch the program while they are open.  Used
by ``calibrate.py`` (at the cells' sizes, on the card) and by the tests
(at a small size, on the CPU); the benchmark's own runs plant none.

- ``serve_altered``: one tile of each shot's enhanced output is another
  tile's (an answer altered where it is produced);
- ``serve_half``: half of a shot's channels left out, zeros in their place;
- ``train_frozen``: each epoch returns its state unchanged (the
  parameters and Adam's state as they were before it);
- ``train_half``: half of each batch left out, the mean taken over the rest.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def _patched(obj, name: str, new) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def serve_altered():
    from specenh_torch.serve import EnhanceService

    orig = EnhanceService.dispatch

    def dispatch(self, traces):
        specs, enhanced = orig(self, traces)
        enhanced[0, :, :128] = enhanced[-1, :, -128:]
        return specs, enhanced

    return _patched(EnhanceService, "dispatch", dispatch)


def serve_half():
    from specenh_torch.serve import EnhanceService

    orig = EnhanceService.dispatch

    def dispatch(self, traces):
        c = traces.shape[0]
        specs, enhanced = orig(self, traces[: c // 2])
        pad = lambda t: torch.cat([t, torch.zeros((c - t.shape[0], *t.shape[1:]),
                                                  dtype=t.dtype, device=t.device)])
        return pad(specs), pad(enhanced)

    return _patched(EnhanceService, "dispatch", dispatch)


def _epoch_wrapper(wrap):
    from specenh_torch import train as T

    orig = T.kernel_epoch_for

    def kernel_epoch_for(*args, **kw):
        return wrap(orig(*args, **kw))

    return _patched(T, "kernel_epoch_for", kernel_epoch_for)


def train_frozen():
    def wrap(epoch):
        def frozen(state, *args):
            saved = [p.detach().clone() for p in state.model.parameters()]
            opt = {k: {n: v.clone() if torch.is_tensor(v) else v for n, v in st.items()}
                   for k, st in state.optimizer.state.items()}
            state, losses = epoch(state, *args)
            with torch.no_grad():
                for p, s in zip(state.model.parameters(), saved):
                    p.copy_(s)
            state.optimizer.state.clear()
            state.optimizer.state.update(opt)
            return state, losses

        return frozen

    return _epoch_wrapper(wrap)


def train_half():
    def wrap(epoch):
        def half(state, x, y, batch_idx, batch_mask):
            m = batch_mask.clone()
            m[:, m.shape[1] // 2 :] = 0
            return epoch(state, x, y, batch_idx, m)

        return half

    return _epoch_wrapper(wrap)


FAULTS = {"serve": {"altered": serve_altered, "half": serve_half},
          "train": {"frozen": train_frozen, "half": train_half}}
