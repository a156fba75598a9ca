"""The service's share of the card's bf16 peak: the autoencoder's
operations for the shots completed in the window, over the window."""

from benchmark.counts import ae, peaks


def read(run):
    shots = run.counters.get("shots")
    if not shots:
        return None
    tiles = shots * run.counters["channels"] * run.config["patch"]["tiles_per_spec"]
    return 100.0 * tiles * ae.forward_flops(run.config["model"]) / run.window_s / peaks.BF16_FLOPS
