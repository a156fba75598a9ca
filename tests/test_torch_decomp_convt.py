"""Plain-torch emulations of the CUDA kernels' block decompositions, on the
CPU where the kernels cannot run, held against the plain twins and the JAX
package:

- the transposed convs' input gradient (``convt_dgrad_kernel``, split by
  ``ops.ae_train_kernel.dgrad_convt_rows``): per (tile, strip) block, dz's
  phase planes staged with the taps' halo one channel chunk at a time,
  each chunk summed on its own and added in order, the gate, one bias
  partial row per block; against the twin and Flax autodiff;
- the tensor-core transposed conv (``convt_igemm_kernel``, split by
  ``ops.ae_kernel.convt_igemm_rows``): per (tile, strip) block, the input
  rows with the taps' halo staged one 16-channel chunk at a time, each
  output parity a stride-1 product over its taps, each chunk summed on its
  own and added in order, bias, relu, one rounding; against the twin,
  Flax's ``ConvTranspose`` and JAX's K3 in interpret mode.

Shared helpers in ``tests/_torch_decomp_common.py``."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from specenh.config import ModelConfig as JModelConfig
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import ae_kernel as jak
from specenh.train import bce_from_logits as jbce
from specenh_torch import ModelConfig
from specenh_torch.models.autoencoder import convt_pad_before, make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops import ae_train_kernel as ttk
from specenh_torch.ops.stft import spectrogram
from tests._torch_decomp_common import (IGEMM_GEOMETRIES, SP, _bf16_ulp_excess,
                                        _tiles, conv_igemm_emulated)


# ---------------------------------------------------------------------------
# the transposed convs' input-gradient kernel
# ---------------------------------------------------------------------------


def dgrad_convt_emulated(tw, layer, dz, gate):
    """``ae_train_dgrad_convt`` as ``convt_dgrad_kernel`` computes it: per
    (tile, strip of R rows) block, dz's four phase planes staged with the
    taps' halo (zeros outside the grid) one channel chunk at a time (16
    channels in bf16, 8 in float32), every tap a shifted window of a
    plane, each chunk summed on its own and added in order, the gate, one
    bias partial row per block, the rows summed in order."""
    k = tw.fwd.k(layer)
    pa = convt_pad_before(k)
    hlo, hhi = (pa - k + 1) >> 1, pa >> 1
    b, cz, h2, w2 = dz.shape
    h, w = h2 // 2, w2 // 2
    cout = tw.fwd.w[layer].shape[0]
    strips = ttk.dgrad_convt_rows(1, h, w, cout)
    r = h // strips
    ch = 16 if tw.dtype == torch.bfloat16 else 8
    wt = tw.bwd[layer].float()                                  # (K, K, Cout, Cz)
    out = torch.empty(b, cout, h, w, dtype=tw.dtype)
    part = torch.empty(b * strips, cout)
    for bi in range(b):
        d = dz[bi].float()
        planes = torch.stack([d[:, ry::2, rx::2] for ry in (0, 1) for rx in (0, 1)], 1)
        planes = torch.nn.functional.pad(planes, (-hlo, hhi, -hlo, hhi))
        for s in range(strips):
            y0 = s * r
            strip = planes[:, :, y0:y0 + r + hhi - hlo]         # staged once
            acc = torch.zeros(cout, r, w)
            for c0 in range(0, cz, ch):
                cacc = torch.zeros(cout, r, w)
                for tap in range(k * k):
                    ai, aj = pa - tap // k, pa - tap % k
                    plane = (ai & 1) * 2 + (aj & 1)
                    dy, dx = (ai >> 1) - hlo, (aj >> 1) - hlo
                    win = strip[c0:c0 + ch, plane, dy:dy + r, dx:dx + w]
                    cacc += torch.einsum("cyx,oc->oyx", win, wt[tap // k, tap % k, :, c0:c0 + ch])
                acc += cacc
            g = gate[bi:bi + 1, :, y0:y0 + r]
            o, gv = ttk._gate(acc[None], g, tw.dtype)
            out[bi, :, y0:y0 + r] = o[0]
            part[bi * strips + s] = gv[0].sum((1, 2))
    return out, ttk.ae_train_sum(part)


DGRAD_GEOMETRIES = {
    "k3": ModelConfig(),
    "deep3": ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3, out_kernel=(5, 5)),
    "64-32-64k7": ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3, out_kernel=(7, 7)),
    "48-16-48mixed": ModelConfig(filters=(48, 16, 48), kernels=((3, 3), (5, 5), (1, 1)),
                                 out_kernel=(3, 3)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(DGRAD_GEOMETRIES))
def test_dgrad_convt_decomposition_matches_twin(name, dtype):
    """Every transposed-conv layer (the first gated by random routing bits,
    the others by their relu'd input) on one tile of random inputs: the
    emulated kernel against the twin, the output within one ulp of the
    dtype (float32: 1e-5 of the scale) and the bias sums to 1e-5 of their
    scale."""
    model = make_model(DGRAD_GEOMETRIES[name], generator=torch.Generator().manual_seed(1))
    tw = ttk.build_train_weights(model, dtype)
    g = torch.Generator().manual_seed(2)
    for i in range(tw.fwd.depth, tw.fwd.out):
        shape = ttk._act_shape(tw, i, 1)
        dz = torch.randn(1, tw.fwd.cout(i), 2 * shape[2], 2 * shape[3], generator=g).to(dtype)
        gate = (torch.randint(0, 16, shape, generator=g, dtype=torch.uint8) if i == tw.fwd.depth
                else torch.randn(shape, generator=g).clamp_min(0).to(dtype))
        out, db = dgrad_convt_emulated(tw, i, dz, gate)
        rout, rdb = ttk.ae_train_dgrad_convt_plain(tw, i, dz, gate)
        d, ref = (out.float() - rout.float()).abs(), rout.float().abs()
        if dtype == torch.bfloat16:
            assert float((d - 2.0 ** -7 * ref - 1e-5).max()) <= 0, i
        else:
            assert float(d.max()) <= 1e-5 * float(ref.max()), i
        assert float((db - rdb).abs().max()) <= 1e-5 * float(rdb.abs().max()), i


@pytest.mark.parametrize("name", ["k3", "deep3"])
def test_dgrad_convt_decomposition_in_the_chain_matches_flax(name):
    """float32: the twins' backward with the emulated transposed-conv input
    gradients in place of the twin's, normalised, against autodiff of the
    Flax model (2e-5 of the scale, as the weight-gradient emulation)."""
    cfg = DGRAD_GEOMETRIES[name]
    jcfg = JModelConfig(filters=cfg.filters, kernels=cfg.kernels, out_kernel=cfg.out_kernel)
    fm = flax_model(jcfg)
    params = fm.init(jax.random.PRNGKey(0), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    x, y, mask = _tiles(n=1, seed=3)
    tw = ttk.build_train_weights(model, torch.float32)
    xs, ys, ms = ttk._inputs(tw, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), False)
    saved, _, bce = ttk._forward(tw, xs, ys, ms, False, ttk._PLAIN)
    gw, gb = ttk._backward(tw, saved, False, dict(ttk._PLAIN, dgrad_convt=dgrad_convt_emulated))
    _, grads = ttk.normalise((bce[0], ms.sum(), ttk.grads_to_torch(gw, gb)))
    _, ref = jax.value_and_grad(lambda p: jbce(fm.apply(p, x, logits=True), y, mask))(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref), cfg)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert err < 2e-5 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("name", list(DGRAD_GEOMETRIES))
def test_dgrad_convt_strips_cover_the_grid(name):
    """The kernel's split of each transposed-conv layer, as the C launcher
    checks it: strips of R rows tile the output grid, a block's R * W
    positions fit its 8 warps of 16-position fragments, and its staged
    strip and weight chunk fit the 227 KB of shared memory (less the 2 KB
    of its bias reduction)."""
    tw = ttk.build_train_weights(make_model(DGRAD_GEOMETRIES[name],
                                            generator=torch.Generator()), torch.bfloat16)
    for i in range(tw.fwd.depth, tw.fwd.out):
        _, cout, h, w = ttk._act_shape(tw, i, 1)
        k, nf = tw.fwd.k(i), cout // 8
        strips = ttk.dgrad_convt_rows(1, h, w, cout)
        r = h // strips
        assert strips * r == h and w % 16 == 0 and cout % 16 == 0
        assert r * w <= 8 * 16 * (1 if nf >= 6 else 8 // nf)
        pa = convt_pad_before(k)
        halo = (pa >> 1) - ((pa - k + 1) >> 1)
        smem = (4 * (r + halo) * (w + halo) + k * k * cout) * 32
        assert smem <= 227 * 1024 - 2048, (i, smem)
        assert ttk.dgrad_convt_rows(5, h, w, cout) == 5 * strips


# ---------------------------------------------------------------------------
# the tensor-core transposed conv
# ---------------------------------------------------------------------------


def convt_igemm_emulated(x, wt, bias, k, dtype=torch.bfloat16):
    """``ae_convt`` as ``convt_igemm_kernel`` computes it, block by block:
    per (tile, strip of R = 128 / W input rows), the input rows y0 + DMIN
    .. y0 + R - 1 + DMAX and columns DMIN .. W - 1 + DMAX, zeros outside
    the tile, staged one 16-channel chunk at a time; output parity (a, b)
    a stride-1 product over its taps {(i, j): a + i - PA and b + j - PA
    even}, tap (i, j) the window of the staged strip at shift ((a + i -
    PA) / 2, (b + j - PA) / 2); each chunk summed on its own and added in
    order; then bias, relu and one rounding to ``dtype`` (float32: none).
    x (B, Cin, H, W), wt (K, K, Cout, Cin)."""
    pa = convt_pad_before(k)
    dmin, dmax = -(pa // 2), (k - pa) // 2
    b, cin, h, w = x.shape
    cout, r = wt.shape[2], tak.convt_igemm_rows(w)
    xp = torch.nn.functional.pad(x.float(), (-dmin, dmax, -dmin, dmax))
    strips = xp.unfold(2, r + dmax - dmin, r).permute(0, 2, 1, 4, 3)  # (B, S, Cin, RT, WT)
    acc = torch.zeros(b, h // r, cout, 2, 2, r, w)                 # parity planes a strip
    for c0 in range(0, cin, 16):
        cacc = torch.zeros_like(acc)
        for a, bb, i, j in itertools.product((0, 1), (0, 1), range(k), range(k)):
            if (a + i - pa) % 2 or (bb + j - pa) % 2:
                continue                                          # not a tap of (a, bb)
            dy, dx = (a + i - pa) // 2 - dmin, (bb + j - pa) // 2 - dmin
            win = strips[:, :, c0:c0 + 16, dy:dy + r, dx:dx + w]
            cacc[:, :, :, a, bb] += torch.einsum("bscyx,oc->bsoyx", win,
                                                 wt[i, j, :, c0:c0 + 16].float())
        acc += cacc
    y = acc.permute(0, 2, 1, 5, 3, 6, 4).reshape(b, cout, 2 * h, 2 * w)  # (2m + a, 2n + b)
    y = torch.relu(y + bias[:, None, None])
    return y if dtype == torch.float32 else y.to(dtype)


def _flax_convt_relu(x, w, bias, k):
    """Flax's ``ConvTranspose`` (stride 2, 'SAME', the module's) + relu in
    float32 at HIGHEST precision, on NCHW x with the kernel w (Cin, K, K,
    Cout) of the layer table."""
    conv = nn.ConvTranspose(w.shape[-1], (k, k), strides=(2, 2), padding="SAME",
                            precision=jax.lax.Precision.HIGHEST)
    params = {"params": {"kernel": w.float().permute(1, 2, 0, 3).numpy(),
                         "bias": bias.numpy()}}
    y = conv.apply(params, np.asarray(x.float().permute(0, 2, 3, 1)))
    return torch.from_numpy(np.array(jax.nn.relu(y))).permute(0, 3, 1, 2)


CONVT_WIDTHS = {"flagship": dict(), "deep3": dict(filters=(16, 32, 64))}


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("widths", list(CONVT_WIDTHS))
def test_convt_igemm_decomposition_matches_twin_and_flax(widths, k):
    """bf16, every transposed conv of the geometry on 2 tiles of random
    inputs: the emulated kernel within one bf16 ulp of ``ae_convt_plain``
    (chip_smoke.py's stage bound; k1's three tapless parities are
    relu(bias)), and in float32 (no rounding) against Flax's
    ``ConvTranspose`` on the same values to 1e-5 of the scale (float32 sums
    in another order)."""
    kw = CONVT_WIDTHS[widths]
    depth = len(kw.get("filters", (32, 32)))
    cfg = ModelConfig(**kw, kernels=((k, k),) * depth, out_kernel=(k, k))
    wts = tak.build_kernel_weights(make_model(cfg, generator=torch.Generator().manual_seed(1)),
                                   torch.bfloat16)
    g = torch.Generator().manual_seed(2)
    for i in range(wts.depth, wts.out):
        h, w = 256 >> (wts.out - i), 128 >> (wts.out - i)
        x = torch.randn(2, wts.w[i].shape[0], h, w, generator=g).clamp_min(0).to(torch.bfloat16)
        got = convt_igemm_emulated(x, wts.wt[i], wts.b[i], k)
        assert got.shape == (2, wts.cout(i), 2 * h, 2 * w)
        assert _bf16_ulp_excess(got, tak.ae_convt_plain(wts, x, i)) <= 0, i
        got32 = convt_igemm_emulated(x, wts.wt[i], wts.b[i], k, torch.float32)
        want = _flax_convt_relu(x, wts.w[i], wts.b[i], k)
        assert float((got32 - want).abs().max()) <= 1e-5 * float(want.abs().max()), i


def test_convt_igemm_s3_chain_matches_twin_and_jax():
    """The flagship's bf16 serving chain with the emulated S2 and S3 in
    place of their twins: against the twins' chain and against JAX's K3
    with its parity turns in interpret mode (the bounds of
    test_conv_igemm_s2_chain_matches_twin_and_jax, 5e-3)."""
    cfg = JModelConfig()
    fm = flax_model(cfg)
    params = fm.init(jax.random.PRNGKey(1), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(ModelConfig(), generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, ModelConfig()))
    x = np.random.default_rng(3).standard_normal((2, SP.n_samples)).astype(np.float32)
    specs, k = spectrogram(torch.from_numpy(x), SP), 3
    wts = tak.build_kernel_weights(model, torch.bfloat16)
    act = tak.ae_tile_in(wts, specs, k)
    for i in range(1, wts.depth):
        act = conv_igemm_emulated(act, wts.wt[i], wts.k(i), "pool", wts.b[i])
    for i in range(wts.depth, wts.out):
        act = convt_igemm_emulated(act, wts.wt[i], wts.b[i], wts.k(i))
    got = tak.ae_tile_out(wts, act, k).numpy()
    twin = tak.ae_kernel_enhance_specs(wts, specs, k).numpy()
    want = np.asarray(jak.ae_kernel_enhance_specs(jak.build_kernel_weights(params, cfg),
                                                  jnp.asarray(specs.numpy()), k, interpret=True))
    assert got.shape == want.shape == (2, 256, k * 128)
    np.testing.assert_allclose(got, twin, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


CONVT_GEOMETRIES = {
    **IGEMM_GEOMETRIES,
    "k1": ModelConfig(kernels=((1, 1), (1, 1)), out_kernel=(1, 1)),
    "64-32k5": ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    "64-32-64k7": ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3, out_kernel=(7, 7)),
}


@pytest.mark.parametrize("name", list(CONVT_GEOMETRIES))
def test_convt_igemm_strips_cover_the_grid(name):
    """The kernel's split of each transposed conv, as the C launcher checks
    it: strips of R rows tile the input grid, R * W is a block's 128
    positions (8 warps of one 16-position fragment), the channels are
    whole 16-channel chunks and groups, and the staged strip and weight
    chunk, and the (16, 2R, 2W) output stage, fit the 227 KB of shared
    memory."""
    wts = tak.build_kernel_weights(make_model(CONVT_GEOMETRIES[name],
                                              generator=torch.Generator()), torch.bfloat16)
    for i in range(wts.depth, wts.out):
        cin, k, cout = wts.w[i].shape[0], wts.k(i), wts.cout(i)
        h, w = 256 >> (wts.out - i), 128 >> (wts.out - i)
        r = tak.convt_igemm_rows(w)
        assert h % r == 0 and r * w == 128 and w % 16 == 0
        assert cin % 16 == 0 and cout % 16 == 0
        pa = convt_pad_before(k)
        nr = (k - pa) // 2 + pa // 2 + 1                      # DMAX - DMIN + 1
        smem = max(((r + nr - 1) * (w + nr - 1) + k * k * 16) * 32, 16 * (4 * 128 + 8) * 2)
        assert smem <= 227 * 1024, (i, smem)
