"""The counts against hand-worked operations and bytes."""

from __future__ import annotations

import json

import pytest

from benchmark.counts import ae, peaks, stft
from benchmark.tests.tiny import ROOT


def _cfg(name):
    return json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())


# multiply-adds x 2 per layer, by hand: H.W.k^2.Cin.Cout for a conv at its
# output, h.w.k^2.Cin.Cout for a stride-2 transposed conv at its input
FLAGSHIP = [2 * 256 * 128 * 9 * 1 * 32, 2 * 128 * 64 * 9 * 32 * 32,
            2 * 64 * 32 * 9 * 32 * 32, 2 * 128 * 64 * 9 * 32 * 32, 2 * 256 * 128 * 9 * 32 * 1]
DEEP3 = [2 * 256 * 128 * 25 * 1 * 16, 2 * 128 * 64 * 25 * 16 * 32, 2 * 64 * 32 * 25 * 32 * 64,
         2 * 32 * 16 * 25 * 64 * 64, 2 * 64 * 32 * 25 * 64 * 32, 2 * 128 * 64 * 25 * 32 * 16,
         2 * 256 * 128 * 25 * 16 * 1]


@pytest.mark.parametrize("name,layers,params", [
    ("flagship", FLAGSHIP, (9 * 32 + 32) + 3 * (9 * 32 * 32 + 32) + (9 * 32 + 1)),
    ("deep3", DEEP3, (25 * 16 + 16) + (25 * 16 * 32 + 32) + (25 * 32 * 64 + 64)
     + (25 * 64 * 64 + 64) + (25 * 64 * 32 + 32) + (25 * 32 * 16 + 16) + (25 * 16 + 1)),
])
def test_autoencoder_counts(name, layers, params):
    model = _cfg(name)["model"]
    assert [ae.layer_flops(l) for l in ae.layers(model)] == layers
    f = sum(layers)
    assert ae.forward_flops(model) == f
    assert ae.train_flops(model) == 3 * f - layers[0]
    assert ae.n_params(model) == params
    assert ae.serve_bytes(model, 600, 2) == 2 * 600 * 256 * 128 * 4 + 2 * params


def test_the_forwards_by_hand():
    assert ae.forward_flops(_cfg("flagship")["model"]) == 377_487_360      # ~377.5 MFLOP
    assert ae.forward_flops(_cfg("deep3")["model"]) == 996_147_200         # ~997 MFLOP
    assert 600 * ae.forward_flops(_cfg("flagship")["model"]) == pytest.approx(226.5e9, rel=1e-3)


def test_weight_gradient_bytes_of_the_flagship():
    model = _cfg("flagship")["model"]
    # conv0: the float32 tile in, its (32, 256, 128) bf16 output's gradient;
    # conv1 (32 -> 32 at 128 x 64); dec1 (32 at 64 x 32 -> 32 at 128 x 64);
    # dec0 (32 at 128 x 64 -> 32 at 256 x 128); out (32 at 256 x 128 -> 1)
    per_tile = (256 * 128 * 4 + 32 * 256 * 128 * 2) + (32 * 128 * 64 * 2 * 2) \
        + (32 * 64 * 32 * 2 + 32 * 128 * 64 * 2) + (32 * 128 * 64 * 2 + 32 * 256 * 128 * 2) \
        + (32 * 256 * 128 * 2 + 256 * 128 * 2)
    assert ae.wgrad_bytes(model, 10, 2) == 10 * per_tile + ae.n_params(model) * 4


def test_stft_counts():
    spec = _cfg("flagship")["spec"]
    assert stft.n_frames(spec) == 3905
    assert stft.flops(spec, 20) == 20 * 3905 * (7 * 512 + 2.5 * 512 * 9 + 6 * 257)
    assert stft.nbytes(spec, 20) == 4 * 20 * (1_000_000 + 256 * 3905 + 2)
    # the byte bound of a 20-channel shot, as PERF.md's kernel table has it (0.0478 ms)
    assert peaks.bound_s(stft.flops(spec, 20), stft.nbytes(spec, 20), "float32") \
        == pytest.approx(4.78e-5, rel=0.01)
