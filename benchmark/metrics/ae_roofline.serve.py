"""The AE serving stages' share of their roofline: the least time of the
window's shots (the larger of the AE's conv operations at the peak of its
compute dtype and the spectrograms' tiles read, the enhanced tiles written
and the weights read once at the memory's bandwidth) over the device time
of the stage kernels."""

from benchmark.core.kernels import AE_STAGES
from benchmark.counts import ae, peaks


def read(run):
    t = run.summary.seconds(AE_STAGES) if run.summary else None
    if not t:
        return None
    model, dtype = run.config["model"], run.config["precision"]["ae"]
    tiles = run.counters["channels"] * run.config["patch"]["tiles_per_spec"]
    wbytes = 2 if dtype == "bfloat16" else 4
    per_shot = peaks.bound_s(tiles * ae.forward_flops(model),
                             ae.serve_bytes(model, tiles, wbytes), dtype)
    return 100.0 * run.counters["shots"] * per_shot / t
