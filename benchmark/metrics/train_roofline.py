"""The training step kernels' share of their roofline: the least time of
the window's steps (forward, weight and input gradients at the peak of the
compute dtype; the tiles x and y read, the weights read and their gradients
written once at the memory's bandwidth) over the device time of the port's
step kernels."""

from benchmark.core.kernels import TRAIN_STEP
from benchmark.counts import ae, peaks


def read(run):
    t = run.summary.seconds(TRAIN_STEP) if run.summary else None
    if not t:
        return None
    model, c = run.config["model"], run.counters
    flops = c["train_tiles"] * ae.train_flops(model)
    nbytes = (2.0 * c["train_tiles"] * ae.tile_bytes(model)
              + c["steps"] * 2.0 * ae.n_params(model) * 4)
    return 100.0 * peaks.bound_s(flops, nbytes, run.config["precision"]["ae"]) / t
