"""Operations and bytes of the conv autoencoder, from a configuration's
shapes alone: the same work whatever implements it.

A layer's operations are 2 x its multiply-adds.  A 'same' conv at an
(H, W) output does H.W.k^2.Cin.Cout of them; a stride-2 transposed conv
does in_positions.k^2.Cin.Cout (each input position scatters a k x k
window into the doubled output).  Pooling, activations and the loss are
elementwise and left out.  Backward: the weight gradient of every layer
and the input gradient of every layer but the first (the tiles need none)
each cost what the layer's forward does.
"""

from __future__ import annotations

from typing import Dict, List

TILE_BYTES_F32 = 4


def layers(model: Dict) -> List[Dict]:
    """The forward's layers in order: kind, cin, cout, k (square kernels
    only: every configuration here has them), input (H, W), output (H, W)."""
    h, w, c = model["input_shape"]
    f = list(model["filters"])
    depth = len(f)
    out: List[Dict] = []
    cin = c
    for i in range(depth):
        k = model["kernels"][i][0]
        out.append(dict(kind="conv", cin=cin, cout=f[i], k=k, hw_in=(h, w), hw_out=(h, w)))
        cin = f[i]
        h, w = h // 2, w // 2
    for i in reversed(range(depth)):
        k = model["kernels"][i][0]
        c_in = f[min(i + 1, depth - 1)]
        out.append(dict(kind="convt", cin=c_in, cout=f[i], k=k, hw_in=(h, w),
                        hw_out=(2 * h, 2 * w)))
        h, w = 2 * h, 2 * w
    k = model["out_kernel"][0]
    out.append(dict(kind="conv", cin=f[0], cout=1, k=k, hw_in=(h, w), hw_out=(h, w)))
    return out


def layer_flops(layer: Dict) -> float:
    """Operations of one layer's forward on one tile."""
    h, w = layer["hw_out"] if layer["kind"] == "conv" else layer["hw_in"]
    return 2.0 * h * w * layer["k"] ** 2 * layer["cin"] * layer["cout"]


def forward_flops(model: Dict) -> float:
    """Operations of the forward on one tile."""
    return sum(layer_flops(layer) for layer in layers(model))


def wgrad_flops(model: Dict) -> float:
    """Operations of every layer's weight gradient, one tile."""
    return forward_flops(model)


def dgrad_flops(model: Dict) -> float:
    """Operations of the input gradients of every layer but the first."""
    return sum(layer_flops(layer) for layer in layers(model)[1:])


def train_flops(model: Dict) -> float:
    """Operations of one training tile: forward, weight and input gradients."""
    return forward_flops(model) + wgrad_flops(model) + dgrad_flops(model)


def n_params(model: Dict) -> int:
    return sum(l["cin"] * l["cout"] * l["k"] ** 2 + l["cout"] for l in layers(model))


def tile_bytes(model: Dict) -> int:
    """One float32 tile."""
    h, w, c = model["input_shape"]
    return h * w * c * TILE_BYTES_F32


def serve_bytes(model: Dict, n_tiles: int, weight_bytes: int) -> float:
    """The AE stage's least traffic: the spectrogram's tiles read once, the
    enhanced tiles written once (both float32), the weights read once."""
    return 2.0 * n_tiles * tile_bytes(model) + n_params(model) * weight_bytes


def train_step_bytes(model: Dict, n_tiles: int) -> float:
    """A step's least traffic: the tiles x and y read once (float32), the
    float32 weights read and their gradients written once."""
    return 2.0 * n_tiles * tile_bytes(model) + 2.0 * n_params(model) * 4


def wgrad_bytes(model: Dict, n_tiles: int, act_bytes: int) -> float:
    """The weight gradients' least traffic: each layer's input and its
    output's gradient read once (the first layer's input is the float32
    tile, every other activation ``act_bytes`` wide), the float32 weight
    gradients written once."""
    total = 0.0
    for i, l in enumerate(layers(model)):
        (hi, wi), (ho, wo) = l["hw_in"], l["hw_out"]
        in_b = TILE_BYTES_F32 if i == 0 else act_bytes
        total += n_tiles * (l["cin"] * hi * wi * in_b + l["cout"] * ho * wo * act_bytes)
    return total + n_params(model) * 4
