"""The training epochs' share of the card's bf16 peak: three forwards a
training tile and one a validation tile, over the window."""

from benchmark.counts import ae, peaks


def read(run):
    c = run.counters
    if not c.get("epochs"):
        return None
    f = ae.forward_flops(run.config["model"])
    flops = 3 * f * c["train_tiles"] + f * c["val_tiles"]
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS
