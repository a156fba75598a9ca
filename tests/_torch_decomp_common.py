"""Helpers shared by the decomposition tests (``tests/test_torch_decomp*.py``):
the training tiles, the K1 tests' ``SpecParams``, and the tensor-core
stride-1 conv's emulation (``conv_igemm_kernel``), its geometries and the
bf16 ulp measure, which the transposed convs' and the out-conv's tests use
too."""

import numpy as np
import torch

from specenh.config import SpecParams
from specenh_torch import ModelConfig
from specenh_torch.ops import ae_train_kernel as ttk


# ---------------------------------------------------------------------------
# the weight-gradient kernel
# ---------------------------------------------------------------------------


def _tiles(n=2, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 256, 128, 1)).astype(np.float32)
    y = (rng.random((n, 256, 128, 1)) > 0.6).astype(np.float32)
    return x, y, np.ones(n, np.float32)


# ---------------------------------------------------------------------------
# the tensor-core stride-1 conv
# ---------------------------------------------------------------------------


def conv_igemm_emulated(x, wt, k, epi, bias=None, dz_bits=None, gate=None,
                        dtype=torch.bfloat16):
    """``conv_igemm_kernel`` as it computes, block by block: per (tile,
    strip of R rows), the input rows y0 - r .. y0 + R - 1 + r (r = K // 2)
    with the taps' halo columns, zeros outside the tile, staged one
    16-channel chunk at a time; every tap a shifted window of the strip;
    each chunk summed on its own and added in order; then the epilogue:
    "pool" (bias, relu, 2x2 max pool -> the output in ``dtype``),
    "pool_mask" (and the routing bits) or "gate" (the routed input
    gradient: the stored output and one bias partial row per block, summed
    by ``ae_train_sum``).  x (B, Cin, H, W), or with ``dz_bits`` the pooled
    gradient (B, Cin, H/2, W/2) routed through them (each value decoded
    once); wt (K, K, Cout, Cin)."""
    x = x.float() if dz_bits is None else ttk.route_expand(x.float(), dz_bits)
    b, cin, h, w = x.shape
    cout, r, wt = wt.shape[2], k // 2, wt.float()
    strips = ttk.conv_igemm_rows(1, h, w, cout)
    rows = h // strips
    xp = torch.nn.functional.pad(x, (r, r, r, r))
    acc = torch.empty(b, cout, h, w)
    for s in range(strips):
        y0 = s * rows
        strip = xp[:, :, y0:y0 + rows + 2 * r]                 # staged once a chunk
        sacc = torch.zeros(b, cout, rows, w)
        for c0 in range(0, cin, 16):
            cacc = torch.zeros(b, cout, rows, w)
            for tap in range(k * k):
                i, j = divmod(tap, k)
                win = strip[:, c0:c0 + 16, i:i + rows, j:j + w]
                cacc += torch.einsum("bcyx,oc->boyx", win, wt[i, j, :, c0:c0 + 16])
            sacc += cacc
        acc[:, :, y0:y0 + rows] = sacc
    if epi == "gate":
        out, g = ttk._gate(acc, gate, dtype)
        part = g.reshape(b, cout, strips, rows, w).sum((3, 4)).permute(0, 2, 1)
        return out, ttk.ae_train_sum(part.reshape(b * strips, cout).contiguous())
    relu = torch.relu(acc + bias[:, None, None])
    pooled = torch.nn.functional.max_pool2d(relu, 2)
    out = pooled.to(dtype)
    return out if epi == "pool" else (out, ttk.route_bits(relu, pooled))


IGEMM_GEOMETRIES = {
    "k3": ModelConfig(),
    "deep3": ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3, out_kernel=(5, 5)),
    "k7": ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
    "48-48-64k3": ModelConfig(filters=(48, 48, 64), kernels=((3, 3),) * 3, out_kernel=(3, 3)),
}


def _bf16_ulp_excess(got, want):
    """How far |got - want| exceeds one bf16 ulp of want (+ 1e-5): <= 0."""
    return float(((got.float() - want.float()).abs() - 2.0 ** -7 * want.float().abs()
                  - 1e-5).max())


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


SP = SpecParams(cut_shot=0.2)  # 389 frames: not a multiple of 16
