"""Plain-torch emulations of the CUDA kernels' block decompositions, on the
CPU where the kernels cannot run, held against the plain twins and the JAX
package:

- the tensor-core stride-1 conv (``csrc/ae_conv.cuh`` ``conv_igemm_kernel``,
  split by ``ops.ae_train_kernel.conv_igemm_rows``): per (tile, strip)
  block, the input rows with the taps' halo staged one 16-channel chunk at
  a time, each chunk summed on its own and added in order, its three
  epilogues (pool; pool and routing bits; the routed input gradient's gate
  and one bias partial row per block); against the twins, JAX's K3 in
  interpret mode and Flax autodiff.

Shared helpers in ``tests/_torch_decomp_common.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh.config import ModelConfig as JModelConfig
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import ae_kernel as jak
from specenh.train import bce_from_logits as jbce
from specenh_torch import ModelConfig
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops import ae_train_kernel as ttk
from specenh_torch.ops.stft import spectrogram
from tests._torch_decomp_common import (IGEMM_GEOMETRIES, SP, _bf16_ulp_excess,
                                        _tiles, conv_igemm_emulated)


# ---------------------------------------------------------------------------
# the tensor-core stride-1 conv
# ---------------------------------------------------------------------------


def _dgrad_wt(tw, layer):
    """The encoder conv's input-gradient operand in the tensor-core layout
    (K, K, Cin, Cout): the kernel flipped, dz's channel fastest."""
    return tw.fwd.w[layer].flip(1, 2).permute(1, 2, 0, 3)


def dgrad_conv_emulated(tw, layer, dz, gate, dz_bits=None):
    """``ae_train_dgrad_conv`` with the encoder convs' launches emulated as
    ``conv_igemm_kernel`` computes them; the out-conv's (one dz channel,
    ``conv_quad_kernel``) is the twin."""
    if dz_bits is None:
        return ttk.ae_train_dgrad_conv_plain(tw, layer, dz, gate)
    return conv_igemm_emulated(dz, _dgrad_wt(tw, layer), tw.fwd.k(layer), "gate",
                               dz_bits=dz_bits, gate=gate, dtype=tw.dtype)


@pytest.mark.parametrize("name", list(IGEMM_GEOMETRIES))
def test_conv_igemm_decomposition_matches_twins(name):
    """bf16, every encoder conv after conv 0 on 2 tiles of random inputs:
    the emulated kernel with each epilogue against the twin of its entry
    point (``ae_conv_pool``, ``ae_train_conv_pool``, the encoder convs'
    ``ae_train_dgrad_conv``), read from the weights in the layouts the
    layer table arranges: outputs within one bf16 ulp (chip_smoke.py's
    stage bound), routing bits equal but on ties (<= 1e-4 of them), bias
    sums to 1e-5 of their scale (float32 sums in another order)."""
    model = make_model(IGEMM_GEOMETRIES[name], generator=torch.Generator().manual_seed(1))
    tw = ttk.build_train_weights(model, torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    for i in range(1, tw.fwd.depth):
        shape = ttk._act_shape(tw, i, 2)
        k, cout = tw.fwd.k(i), tw.fwd.cout(i)
        x = torch.randn(shape, generator=g).clamp_min(0).to(torch.bfloat16)
        got = conv_igemm_emulated(x, tw.fwd.wt[i], k, "pool", tw.fwd.b[i])
        assert _bf16_ulp_excess(got, tak.ae_conv_pool_plain(tw.fwd, x, i)) <= 0, i
        got, bits = conv_igemm_emulated(x, tw.fwd.wt[i], k, "pool_mask", tw.fwd.b[i])
        want, wbits = ttk.ae_train_conv_pool_plain(tw, x, i)
        assert _bf16_ulp_excess(got, want) <= 0, i
        assert float((bits != wbits).float().mean()) <= 1e-4, i
        pooled = (2, cout, shape[2] // 2, shape[3] // 2)
        dz = torch.randn(pooled, generator=g).to(torch.bfloat16)
        dz_bits = torch.randint(0, 16, pooled, generator=g, dtype=torch.uint8)
        gate = torch.randint(0, 16, shape, generator=g, dtype=torch.uint8)
        out, db = conv_igemm_emulated(dz, tw.bwd[i], k, "gate", dz_bits=dz_bits, gate=gate)
        rout, rdb = ttk.ae_train_dgrad_conv_plain(tw, i, dz, gate, dz_bits)
        assert _bf16_ulp_excess(out, rout) <= 0, i
        assert float((db - rdb).abs().max()) <= 1e-5 * float(rdb.abs().max()), i


def test_conv_igemm_s2_chain_matches_twin_and_jax():
    """The flagship's bf16 serving chain with the emulated S2 in place of
    its twin: against the twins' chain (the whole AE in bf16, 5e-3) and
    against JAX's K3 with its parity turns in interpret mode (the bound of
    tests/test_torch_ae.py, 5e-3)."""
    cfg = JModelConfig()
    fm = flax_model(cfg)
    params = fm.init(jax.random.PRNGKey(0), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(ModelConfig(), generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, ModelConfig()))
    x = np.random.default_rng(1).standard_normal((2, SP.n_samples)).astype(np.float32)
    specs, k = spectrogram(torch.from_numpy(x), SP), 3
    wts = tak.build_kernel_weights(model, torch.bfloat16)
    act = tak.ae_tile_in(wts, specs, k)
    for i in range(1, wts.depth):
        act = conv_igemm_emulated(act, wts.wt[i], wts.k(i), "pool", wts.b[i])
    for i in range(wts.depth, wts.out):
        act = tak.ae_convt(wts, act, i)
    got = tak.ae_tile_out(wts, act, k).numpy()
    twin = tak.ae_kernel_enhance_specs(wts, specs, k).numpy()
    want = np.asarray(jak.ae_kernel_enhance_specs(jak.build_kernel_weights(params, cfg),
                                                  jnp.asarray(specs.numpy()), k, interpret=True))
    assert got.shape == want.shape == (2, 256, k * 128)
    np.testing.assert_allclose(got, twin, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


@pytest.mark.parametrize("name", ["k3", "deep3"])
def test_conv_igemm_routed_gradient_in_the_chain_matches_flax(name):
    """float32: the twins' backward with the encoder convs' input gradients
    emulated as the tensor-core kernel computes them, normalised, against
    autodiff of the Flax model (2e-5 of the scale, as the other
    emulations)."""
    cfg = IGEMM_GEOMETRIES[name]
    jcfg = JModelConfig(filters=cfg.filters, kernels=cfg.kernels, out_kernel=cfg.out_kernel)
    fm = flax_model(jcfg)
    params = fm.init(jax.random.PRNGKey(0), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    x, y, mask = _tiles(n=1, seed=4)
    tw = ttk.build_train_weights(model, torch.float32)
    xs, ys, ms = ttk._inputs(tw, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), False)
    saved, _, bce = ttk._forward(tw, xs, ys, ms, False, ttk._PLAIN)
    gw, gb = ttk._backward(tw, saved, False, dict(ttk._PLAIN, dgrad_conv=dgrad_conv_emulated))
    _, grads = ttk.normalise((bce[0], ms.sum(), ttk.grads_to_torch(gw, gb)))
    _, ref = jax.value_and_grad(lambda p: jbce(fm.apply(p, x, logits=True), y, mask))(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref), cfg)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert err < 2e-5 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("name", list(IGEMM_GEOMETRIES))
def test_conv_igemm_strips_cover_the_grid(name):
    """The kernel's split of each encoder conv's launches (the forward over
    the layer's input grid with its Cout, the input gradient with the
    layer's Cin), as the C launcher checks it: strips of R rows (R even)
    tile the grid, R * W is the 256 (<= 32 channels) or 128 positions of a
    block, each of its warps a row pair x 16 columns, and the staged strip
    and weight chunk fit the 227 KB of shared memory (less the 1 KB of the
    bias reduction)."""
    tw = ttk.build_train_weights(make_model(IGEMM_GEOMETRIES[name], generator=torch.Generator()),
                                 torch.bfloat16)
    for i in range(1, tw.fwd.depth):
        _, cin, h, w = ttk._act_shape(tw, i, 1)
        k, r = tw.fwd.k(i), tw.fwd.k(i) // 2
        for cout in (tw.fwd.cout(i), cin):
            strips = ttk.conv_igemm_rows(1, h, w, cout)
            rows = h // strips
            assert strips * rows == h and rows % 2 == 0 and w % 16 == 0
            assert rows * w == (256 if cout <= 32 else 128)
            xo = (r + 1) & ~1
            smem = (2 * (rows + 2 * r) * ((xo + w + r + 1) // 2) + k * k * cout) * 32
            assert smem <= 227 * 1024 - 1024, (i, smem)
            assert ttk.conv_igemm_rows(5, h, w, cout) == 5 * strips


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tensor_core_weight_layouts(dtype):
    """The layer table arranges the tensor-core kernels' operands once: in
    bf16 the encoder convs after conv 0 and the transposed convs (16
    channels or more on each side) get w with the input channel fastest,
    (K, K, Cout, Cin), the encoder convs' input-gradient operand (K, K,
    Cin, Cout) and the transposed convs' (K, K, Cin, Cout), w with dz's
    channel fastest; the single-channel layers and every float32 layer
    keep the CUDA-core templates' layouts (and no ``wt``)."""
    cfg = IGEMM_GEOMETRIES["deep3"]
    tw = ttk.build_train_weights(make_model(cfg, generator=torch.Generator().manual_seed(3)),
                                 dtype)
    mma = dtype == torch.bfloat16
    for i in range(tw.fwd.out + 1):
        w = tw.fwd.w[i]
        enc, convt = 1 <= i < tw.fwd.depth, tw.fwd.is_convt(i)
        if (enc or convt) and mma:
            assert torch.equal(tw.fwd.wt[i], w.permute(1, 2, 3, 0))
        else:
            assert tw.fwd.wt[i] is None
        if enc and mma:
            assert torch.equal(tw.bwd[i], _dgrad_wt(tw, i))
        if convt:
            assert torch.equal(tw.bwd[i], w.permute(1, 2, 0, 3))
        if (enc and not mma) or i == tw.fwd.out:
            assert torch.equal(tw.bwd[i], w.flip(1, 2).permute(3, 1, 2, 0))
