"""The weight gradients' share of their roofline (``ae_train_wgrad``,
``ae_train_wgrad_x``): every layer's weight-gradient operations, and each
layer's input and output gradient read and the float32 weight gradients
written once a step, over the device time of ``wgrad_kernel``."""

from benchmark.core.kernels import WGRAD
from benchmark.counts import ae, peaks


def read(run):
    t = run.summary.seconds(WGRAD) if run.summary else None
    if not t:
        return None
    model, c, dtype = run.config["model"], run.counters, run.config["precision"]["ae"]
    act = 2 if dtype == "bfloat16" else 4
    nbytes = (ae.wgrad_bytes(model, c["train_tiles"], act)
              + (c["steps"] - 1) * ae.n_params(model) * 4)
    return 100.0 * peaks.bound_s(c["train_tiles"] * ae.wgrad_flops(model), nbytes, dtype) / t
