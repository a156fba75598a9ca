"""K1's share of its roofline: the least time of the window's STFTs (the
traces read once, the normalized spectrogram and each channel's min and
max written once; the FFT's operations at the float32 peak) over the
device time of K1's layer: the STFT kernel and the normalization's
kernels."""

from benchmark.core.kernels import K1
from benchmark.counts import peaks, stft


def read(run):
    t = run.summary.seconds(K1) if run.summary else None
    if not t:
        return None
    spec, c, shots = run.config["spec"], run.counters["channels"], run.counters["shots"]
    return 100.0 * shots * peaks.bound_s(stft.flops(spec, c), stft.nbytes(spec, c),
                                         "float32") / t
