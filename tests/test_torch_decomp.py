"""Plain-torch emulations of the CUDA kernels' block decompositions, on the
CPU where the kernels cannot run, held against the plain twins and the JAX
package:

- the tensor-core out-conv (``conv_out_mma_kernel``, the bf16 S4 and the
  training loss, split by ``ops.ae_kernel.conv_out_plan``): per (tile,
  strip) block, the input rows with the taps' halo as the ring holds them,
  each output row's tap rows one product per 16-channel chunk, chunks
  added in order, then the taps' column shifts summed in float32 and the
  bias; then the sigmoid and the restitch, or the loss (labels rounded,
  logits, dz5, the BCE and dz5 sums in the threads' order, one partial row
  per (tile, band)); against the twins for k1 to k7 at 16, 32 and 64
  channels, in the flagship and deep3 chains against JAX's K3 and K6 in
  interpret mode, and the loss against the JAX model's BCE and gradients;
- the tensor-core one-channel-in conv (``conv_in_mma_kernel``: the bf16
  S1, the training conv 0 and the out-conv's input gradient, split by
  ``ops.ae_kernel.conv_in_strip``): per (tile, strip) block, the window
  staged in bf16 with the taps' halo, the taps as pairs of horizontal
  neighbours padded to 16-slot chunks, a float32 GEMM over the slots, the
  pool, the pool-and-routing-bits or the gate epilogue with one bias
  partial row per block; against the twins for k1 to k7 at 16, 32 and 64
  channels, in the flagship and deep3 serving chains against JAX's K3
  and K6 in interpret mode, conv 0 against JAX's conv 1 and its routing
  mask, and in a step's chain against Flax autodiff;
- ``ae_train_sum``'s order (``sum_rows_kernel``, ``sum_slabs``): against
  the float64 twin; a step's sums as one plan (``StepSums``): its segment
  table covers every partial row once, bit for bit the per-call sums;
- K1 (``csrc/stft.cu``): per block of 16 frames, detrend by mean and slope,
  the window, the 256-point complex FFT as 16 x 16 with the host's twiddle
  table, the real-to-complex split, per-block min/max; against the twin
  and JAX's ``stft_ft_log`` in interpret mode.

The weight gradient, the transposed convs and the stride-1 conv are in
``tests/test_torch_decomp_wgrad.py``, ``_convt.py`` and ``_igemm.py``;
shared helpers in ``tests/_torch_decomp_common.py``."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from specenh.config import ModelConfig as JModelConfig
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import ae3_kernel as jak3
from specenh.ops import ae_kernel as jak
from specenh.ops import ae_train_kernel as jtk
from specenh.ops import stft_fused as jsf
from specenh.train import bce_from_logits as jbce
from specenh_torch import ModelConfig
from specenh_torch.config import MODEL_PRESETS
from specenh_torch.data.tiles import patch, unpatch
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops import ae_train_kernel as ttk
from specenh_torch.ops.stft import spectrogram
from specenh_torch.ops import stft as tstft
from specenh_torch.ops import stft_fused as tsf
from tests._torch_decomp_common import IGEMM_GEOMETRIES, SP, _bf16_ulp_excess, _tiles


# ---------------------------------------------------------------------------
# the tensor-core out-conv (S4)
# ---------------------------------------------------------------------------


def conv_out_mma_emulated(x, w, bias, k_tiles=1, epilogue="sigmoid", y=None, mask=None,
                          dtype=torch.bfloat16):
    """The out-conv in bf16 as ``conv_out_mma_kernel`` computes it, block
    by block: per (tile, strip of R output rows, ``conv_out_rows``), the
    input rows y0 - r .. y0 + R - 1 + r (r = K // 2; zeros outside the
    tile) over the tile's columns, as the ring holds them; per 16-channel
    chunk, the tap rows' products summed in float32 in fresh sums (tap rows
    ascending: output row y takes tap row i from input row y + i - r) and
    added into the running sums S[y, x', j] chunk by chunk in order; then
    the gather z[y, x] = sum_j S[y, x + j - r, j] (taps ascending, columns
    outside the tile adding nothing) and the bias.  Then the epilogue:
    "sigmoid" (``ae_tile_out``: 1 / (1 + exp(-z)) and the restitch) or
    "loss" (``ae_train_loss``: the labels ``y`` rounded to ``dtype``, the
    logits z, dz5 = (sigmoid(z) - y) * mask rounded to ``dtype``, and the
    masked BCE and dz5 sums in the kernel's order: each thread's running
    sums over its pixels (strips in order, then its pixels u: row t // 128
    + 2 u, column t % 128), a warp's shuffle-down tree, the 8 warps in
    order, one partial row per (tile, band of ``CONV_OUT_BAND`` rows),
    summed by ``ae_train_sum``).  x (B, Cin, 256, 128), w (Cin, K, K, 1),
    bias (1,)."""
    b, cin, h, wd = x.shape
    k = w.shape[1]
    r, rows = k // 2, tak.conv_out_rows(k, cin)
    xp = torch.nn.functional.pad(x.float(), (0, 0, r, r))          # rows only
    strips = xp.unfold(2, rows + 2 * r, rows).permute(0, 2, 1, 4, 3)  # (B, S, Cin, RT, W)
    wf = w.float()[..., 0]                                          # (Cin, K, K)
    acc = torch.zeros(b, h // rows, rows, wd, k)
    for c0 in range(0, cin, 16):
        cacc = torch.zeros_like(acc)
        for i in range(k):
            cacc += torch.einsum("bscyx,cj->bsyxj", strips[:, :, c0:c0 + 16, i:i + rows],
                                 wf[c0:c0 + 16, i])
        acc += cacc
    z = torch.zeros(b, h // rows, rows, wd)
    for j in range(k):
        d = j - r                                                   # out[x] += S[x + d, j]
        if d >= 0:
            z[..., :wd - d] += acc[..., d:, j]
        else:
            z[..., -d:] += acc[..., :wd + d, j]
    z = (z + bias).reshape(b, h, wd)
    if epilogue == "sigmoid":
        return unpatch(1.0 / (1.0 + torch.exp(-z)), tiles_per_spec=k_tiles)
    yv = y.float() if dtype == torch.float32 else y.to(dtype).float()
    mk = mask.float()[:, None, None]
    d = (1.0 / (1.0 + torch.exp(-z)) - yv) * mk
    per = (z.clamp_min(0) - z * yv + torch.log1p(torch.exp(-z.abs()))) * mk
    band = tak.CONV_OUT_BAND
    parts = []
    for v in (per, d):
        # (B, bands, strip s, pixel u, t // 128, t % 128)
        v = v.reshape(b, h // band, band // rows, rows // 2, 2, wd)
        run = torch.zeros(b, h // band, 2, wd)
        for si in range(band // rows):
            for u in range(rows // 2):
                run = run + v[:, :, si, u]
        lanes = run.reshape(b, h // band, 8, 32)                    # warp t // 32, lane t % 32
        for o in (16, 8, 4, 2, 1):
            lanes = lanes[..., :o] + lanes[..., o:2 * o]
        tot = torch.zeros(b, h // band)
        for wp in range(8):
            tot = tot + lanes[..., wp, 0]
        parts.append(tot.reshape(-1))
    sums = ttk.ae_train_sum(torch.stack(parts, 1).contiguous())
    dz = d if dtype == torch.float32 else d.to(dtype)
    return z, dz[:, None], sums[0:1], sums[1:2]


def _out_conv_cfg(cin, k):
    """A geometry whose out-conv reads ``cin`` channels through a k x k
    kernel (the encoder's k may differ)."""
    filters = {16: (16, 32, 64), 32: (32, 32), 64: (64, 32)}[cin]
    return ModelConfig(filters=filters, kernels=((3, 3),) * len(filters), out_kernel=(k, k))


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("cin", [16, 32, 64])
def test_conv_out_mma_decomposition_matches_twin(cin, k):
    """bf16 weights and activations on 3 tiles (one restitched channel):
    the emulated kernel against ``ae_tile_out_plain`` (``F.conv2d`` in
    float32 on the same values, sigmoid, ``unpatch``) within 1e-5, float32
    sums in another order (``chip_smoke.py`` holds the kernel to TOL_F32,
    1e-4)."""
    wts = tak.build_kernel_weights(make_model(_out_conv_cfg(cin, k),
                                              generator=torch.Generator().manual_seed(k)),
                                   torch.bfloat16)
    o = wts.out
    g = torch.Generator().manual_seed(cin + k)
    x = torch.rand(3, cin, 256, 128, generator=g).to(torch.bfloat16)
    got = conv_out_mma_emulated(x, wts.w[o], wts.b[o], 3)
    want = tak.ae_tile_out_plain(wts, x, 3)
    assert got.shape == want.shape == (1, 256, 3 * 128)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("cin", [16, 32, 64])
def test_conv_out_mma_loss_decomposition_matches_twin(cin, k):
    """bf16 weights and activations on 2 tiles (the second masked out),
    float32 labels in [0, 1]: the emulated kernel with the loss epilogue
    against ``ae_train_loss_plain`` (``F.conv2d`` in float32 on the same
    values, the BCE and dz5 in float64): logits within 1e-5 of their scale
    (float32 sums in another order), dz5 within one bf16 ulp, the BCE and
    dz5 sums within 1e-5 of their scale (float32 per-thread sums and a
    fixed tree against float64).  The labels in bf16 (K5b) give the same
    bits as the float32 labels (K5) rounded as loaded."""
    wts = tak.build_kernel_weights(make_model(_out_conv_cfg(cin, k),
                                              generator=torch.Generator().manual_seed(k)),
                                   torch.bfloat16)
    tw, o = ttk.train_weights(wts), wts.out
    g = torch.Generator().manual_seed(cin + k + 1)
    x = torch.rand(2, cin, 256, 128, generator=g).to(torch.bfloat16)
    y = torch.rand(2, 256, 128, generator=g)
    mask = torch.tensor([1.0, 0.0])
    got = conv_out_mma_emulated(x, wts.w[o], wts.b[o], epilogue="loss", y=y, mask=mask)
    pre = conv_out_mma_emulated(x, wts.w[o], wts.b[o], epilogue="loss",
                                y=y.to(torch.bfloat16), mask=mask)
    assert all(torch.equal(a, c) for a, c in zip(got, pre))
    logits, dz, bce, db = got
    rl, rdz, rbce, rdb = ttk.ae_train_loss_plain(tw, x, y, mask)
    assert logits.shape == rl.shape == (2, 256, 128) and dz.shape == rdz.shape == (2, 1, 256, 128)
    assert float((logits - rl).abs().max()) <= 1e-5 * float(rl.abs().max())
    assert _bf16_ulp_excess(dz, rdz) <= 0
    assert not bool(dz[1].float().any())
    for a, c in ((bce, rbce), (db, rdb)):
        assert float((a - c).abs()) <= 1e-5 * float(c.abs()), (a, c)


@pytest.mark.parametrize("name", ["k3", "deep3"])
def test_conv_out_mma_loss_in_the_chain_matches_jax(name):
    """float32: the twins' forward up to e, then the loss as
    ``conv_out_mma_kernel`` computes it (the labels and dz5 unrounded),
    against the JAX model on the same tile (the shapes of
    test_conv_in_mma_out_conv_gradient_in_the_chain_matches_flax): the
    logits within 1e-4 of their scale (two float32 chains of five convs in
    different orders), the BCE sum (``masked_bce_from_logits3d`` times its
    denominator) within 1e-5 of its scale, dz5 (``jax.grad`` of that sum
    with respect to the logits) within 1e-5 of 1, and db5 (``jax.grad`` of
    the model's loss with respect to the out-conv's bias, unnormalised)
    within 1e-4 of its scale."""
    cfg = IGEMM_GEOMETRIES[name]
    jcfg = JModelConfig(filters=cfg.filters, kernels=cfg.kernels, out_kernel=cfg.out_kernel)
    fm = flax_model(jcfg)
    params = fm.init(jax.random.PRNGKey(1), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    x, y, mask = _tiles(n=1, seed=8)
    tw = ttk.build_train_weights(model, torch.float32)
    xs, ys, ms = ttk._inputs(tw, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), False)
    saved, _, _ = ttk._forward(tw, xs, ys, ms, False, ttk._PLAIN)
    o = tw.fwd.out
    logits, dz, bce, db = conv_out_mma_emulated(saved["act"][o], tw.fwd.w[o], tw.fwd.b[o],
                                                epilogue="loss", y=ys, mask=ms,
                                                dtype=torch.float32)
    denom = float(mask.sum()) * 256 * 128
    y3 = jnp.asarray(y.reshape(1, 16, 2048))

    def bce_sum(z):
        return jtk.masked_bce_from_logits3d(z.reshape(1, 16, 2048), y3, jnp.asarray(mask)) * denom

    def model_loss(p):
        z = fm.apply(p, x, logits=True)
        return jbce(z, y, mask), z

    grads, jl = jax.grad(model_loss, has_aux=True)(params)
    want_bce, want_dz = jax.value_and_grad(bce_sum)(jl)
    want_db = float(grads["params"]["out_conv"]["bias"][0]) * denom
    jl, want_dz = np.asarray(jl)[..., 0], np.asarray(want_dz)[..., 0]
    assert float(np.abs(logits.numpy() - jl).max()) <= 1e-4 * float(np.abs(jl).max())
    assert abs(float(bce[0]) - float(want_bce)) <= 1e-5 * abs(float(want_bce))
    assert float(np.abs(dz[:, 0].numpy() - want_dz).max()) <= 1e-5
    assert abs(float(db[0]) - want_db) <= 1e-4 * max(abs(want_db), 1.0), (float(db[0]), want_db)


@pytest.mark.parametrize("name", ["flagship", "deep3"])
def test_conv_out_mma_s4_chain_matches_twin_and_jax(name):
    """The bf16 serving chain with the emulated S4 in place of its twin:
    against the twins' chain and against JAX's K3 (flagship) or K6 (deep3)
    with its tile turns in interpret mode (the bounds of
    test_conv_igemm_s2_chain_matches_twin_and_jax, 5e-3)."""
    cfg = ModelConfig() if name == "flagship" else MODEL_PRESETS["deep3"]
    jcfg = JModelConfig(filters=cfg.filters, kernels=cfg.kernels, out_kernel=cfg.out_kernel)
    params = flax_model(jcfg).init(jax.random.PRNGKey(2), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    x = np.random.default_rng(5).standard_normal((2, SP.n_samples)).astype(np.float32)
    specs, k = spectrogram(torch.from_numpy(x), SP), 3
    wts = tak.build_kernel_weights(model, torch.bfloat16)
    act = tak.ae_tile_in(wts, specs, k)
    for i in range(1, wts.depth):
        act = tak.ae_conv_pool(wts, act, i)
    for i in range(wts.depth, wts.out):
        act = tak.ae_convt(wts, act, i)
    got = conv_out_mma_emulated(act, wts.w[wts.out], wts.b[wts.out], k).numpy()
    twin = tak.ae_kernel_enhance_specs(wts, specs, k).numpy()
    if name == "flagship":
        want = jak.ae_kernel_enhance_specs(jak.build_kernel_weights(params, jcfg),
                                           jnp.asarray(specs.numpy()), k, interpret=True)
    else:
        want = jak3.ae3_kernel_enhance_specs(jak3.build_kernel3_weights(params, jcfg),
                                             jnp.asarray(specs.numpy()), k, interpret=True)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 256, k * 128)
    np.testing.assert_allclose(got, twin, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_conv_out_mma_strips_cover_the_tile(k):
    """The kernel's split of a tile at every supported input width (16, 32,
    48, 64 channels), as the C launcher plans it: bands of
    ``CONV_OUT_BAND`` rows, each walked in strips of ``conv_out_rows``
    rows, cover the 256 rows once; a strip's 128 x R pixels are whole
    pixels of its 256 threads; the ring holds a strip's R + 2 (k // 2)
    rows and the next strips' R rows each; the block fits the 227 KB of
    shared memory."""
    for cin in (16, 32, 48, 64):
        rows, pf = tak.conv_out_plan(k, cin)
        assert rows == tak.conv_out_rows(k, cin) and rows in (2, 4, 8) and 1 <= pf <= 3
        assert k < 7 or rows < 8  # the launcher instantiates no 8-row strip at k7
        band = tak.CONV_OUT_BAND
        covered = [y0 + s * rows + r for y0 in range(0, 256, band)
                   for s in range(band // rows) for r in range(rows)]
        assert sorted(covered) == list(range(256)), (cin, rows)
        assert rows * 128 % 256 == 0
        ring = 2 * (k // 2) + (pf + 1) * rows
        assert ring == rows + 2 * (k // 2) + pf * rows
        assert tak._conv_out_smem(k, cin, rows, ring) <= 227 * 1024, (cin, rows, pf)
        # the epilogue's pixels: thread t's pixel u of strip s is row s R + t // 128 + 2 u,
        # column t % 128; over a band's strips every pixel once
        seen = [s * rows + t // 128 + 2 * u for s in range(band // rows) for u in range(rows // 2)
                for t in range(256)]
        assert sorted(zip(seen, [t % 128 for _ in range(band // rows)
                                 for _ in range(rows // 2) for t in range(256)])) \
            == [(y, x) for y in range(band) for x in range(128)], (cin, rows)


def test_loss_partial_rows_cover_the_tile_once():
    """The loss's partial rows (``_loss_rows``): in bf16 one per (tile,
    band of ``CONV_OUT_BAND`` rows), the bands covering each tile's 256
    rows once; in float32 one per ``conv_quad_kernel`` quad block."""
    model = make_model(ModelConfig(), generator=torch.Generator())
    for b in (1, 2, 5):
        tw = ttk.build_train_weights(model, torch.bfloat16)
        band = tak.CONV_OUT_BAND
        assert ttk._loss_rows(tw, b) == b * 256 // band == b * len(range(0, 256, band))
        assert ttk._loss_rows(ttk.build_train_weights(model, torch.float32), b) \
            == ttk._rows(b, 256, 128)


# ---------------------------------------------------------------------------
# the tensor-core one-channel-in conv (S1, the out-conv's input gradient)
# ---------------------------------------------------------------------------


CI_XO, CI_RS = 4, 76  # csrc/ae_conv.cuh: staged column of input column 0, words a row


def _tap_pairs(k):
    """The GEMM's tap pairs (i, j), (i, j + 1), j even: slot 2 p + e is tap
    (i, j + e) of pair p, none where j + e = k (a half pair)."""
    return [(i, j) for i in range(k) for j in range(0, k, 2)]


def conv_in_mma_emulated(src, w, k, epilogue, bias=None, gate=None, dtype=torch.bfloat16):
    """``conv_in_mma_kernel`` as it computes, block by block: per (tile,
    strip of ``conv_in_strip`` rows), the window the block stages (input
    rows y0 - r .. y0 + R - 1 + r, columns -4 .. 131, zeros outside the
    tile, rounded to ``dtype``); A's slots the tap pairs of ``_tap_pairs``,
    padded to 16, 16, 32 and 64 slots for k1, k3, k5 and k7, a half pair's
    second slot and the slots past the last pair zero in A and in W; each
    strip a float32 GEMM over the slots; then the epilogue: "pool" (bias,
    relu, 2x2 max pool -> ``dtype``), "pool_mask" (and the routing bits
    from the float32 relu values: conv 0's ``CiPoolMaskEpi``) or "gate"
    (the relu gate against ``gate``: the stored output and one bias
    partial row per (tile, strip), summed by ``ae_train_sum``).  src (B,
    256, 128), w (1, K, K, Cout)."""
    b, h, wd = src.shape
    cout, r = w.shape[-1], k // 2
    rows = tak.conv_in_strip(cout, epilogue != "gate")
    x = src.float() if dtype == torch.float32 else src.to(dtype).float()
    xp = torch.nn.functional.pad(x, (CI_XO, CI_XO, r, r))  # staged columns -4 .. 131
    pairs = _tap_pairs(k)
    slots = 16 * -(-2 * len(pairs) // 16)
    assert slots == {1: 16, 3: 16, 5: 32, 7: 64}[k]
    wk = w.float().reshape(k, k, cout)
    W = torch.zeros(slots, cout)
    for p, (i, j) in enumerate(pairs):
        for e in range(2):
            if j + e < k:
                W[2 * p + e] = wk[i, j + e]
    acc = torch.empty(b, cout, h, wd)
    for y0 in range(0, h, rows):
        win = xp[:, y0:y0 + rows + 2 * r]                  # the block's staged window
        A = torch.zeros(b, rows, wd, slots)
        for p, (i, j) in enumerate(pairs):
            for e in range(2):
                if j + e < k:
                    c0 = CI_XO + j + e - r
                    A[..., 2 * p + e] = win[:, i:i + rows, c0:c0 + wd]
        acc[:, :, y0:y0 + rows] = torch.einsum("byxs,sc->bcyx", A, W)
    if epilogue == "gate":
        out, g = ttk._gate(acc, gate, dtype)
        strips = h // rows
        part = g.reshape(b, cout, strips, rows, wd).sum((3, 4)).permute(0, 2, 1)
        return out, ttk.ae_train_sum(part.reshape(b * strips, cout).contiguous())
    relu = torch.relu(acc + bias[:, None, None])
    pooled = torch.nn.functional.max_pool2d(relu, 2)
    out = pooled if dtype == torch.float32 else pooled.to(dtype)
    return out if epilogue == "pool" else (out, ttk.route_bits(relu, pooled))


def _in_conv_cfg(cout, k):
    """A geometry whose conv 0 and out-conv both have ``cout`` channels on
    their one-channel side and a k x k kernel."""
    filters = {16: (16, 32, 64), 32: (32, 32), 64: (64, 32)}[cout]
    return ModelConfig(filters=filters, kernels=((k, k),) * len(filters), out_kernel=(k, k))


def _raw_logpsd(g, c, k_tiles):
    """A raw (C, F, T) log-PSD a little larger than the tiles read, and its
    (C, 1) min/max, as the STFT kernel's outputs."""
    raw = torch.randn(c, 257, k_tiles * 128 + 5, generator=g) * 3 - 20
    return raw, raw.amin((1, 2))[:, None], raw.amax((1, 2))[:, None]


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("cout", [16, 32, 64])
def test_conv_in_mma_decomposition_matches_twins(cout, k):
    """bf16 on 3 tiles (one restitched channel): the emulated kernel with
    the pool epilogue against ``ae_tile_in_plain`` on spectrograms and
    ``ae_tile_in_norm_plain`` on a raw log-PSD in both layouts (the same
    normalized values), and with the gate epilogue against the out-conv's
    branch of ``ae_train_dgrad_conv_plain`` (dz and e random, the gate
    off where e <= 0), read from the weights the layer table arranges
    (``w[0]``, ``bwd[out]``): outputs within one bf16 ulp, bias sums to
    1e-5 of their scale (float32 sums in another order)."""
    model = make_model(_in_conv_cfg(cout, k), generator=torch.Generator().manual_seed(k))
    tw = ttk.build_train_weights(model, torch.bfloat16)
    wts, o = tw.fwd, tw.fwd.out
    g = torch.Generator().manual_seed(cout + k)
    specs = torch.rand(1, 256, 3 * 128, generator=g)
    got = conv_in_mma_emulated(patch(specs), wts.w[0], k, "pool", wts.b[0])
    assert got.shape == (3, cout, 128, 64)
    assert _bf16_ulp_excess(got, tak.ae_tile_in_plain(wts, specs, 3)) <= 0
    raw, mn, mx = _raw_logpsd(g, 1, 3)
    for layout, r in (("ft", raw), ("tf", raw.transpose(1, 2).contiguous())):
        got = conv_in_mma_emulated(tak.normalized_tiles(r, mn, mx, 3, layout), wts.w[0], k,
                                   "pool", wts.b[0])
        assert _bf16_ulp_excess(got, tak.ae_tile_in_norm_plain(wts, r, mn, mx, 3, layout)) <= 0
    dz = torch.randn(3, 1, 256, 128, generator=g).to(torch.bfloat16)
    e = torch.randn(3, cout, 256, 128, generator=g).to(torch.bfloat16)
    out, db = conv_in_mma_emulated(dz[:, 0], tw.bwd[o], k, "gate", gate=e)
    rout, rdb = ttk.ae_train_dgrad_conv_plain(tw, o, dz, e)
    assert _bf16_ulp_excess(out, rout) <= 0
    assert float((db - rdb).abs().max()) <= 1e-5 * float(rdb.abs().max())


def _check_routes(bits, want, x, w, bias, tag):
    """Routing bits equal the reference's, and the float64 bits of
    ``route_bits64``, outside its near ties (x, w, bias: the values conv 0
    reads); at most 1e-4 of the windows differ (the bound of the
    conv_igemm pool-mask tests).  Returns (windows that differ, near
    ties)."""
    bits64, near = ttk.route_bits64(x, w, bias)
    diff = bits != want
    assert not bool((diff & ~near).any()), tag
    assert not bool(((bits != bits64) & ~near).any()), tag
    assert float(diff.float().mean()) <= 1e-4, tag
    return int(diff.sum()), int(near.sum())


@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("cout", [16, 32, 64])
def test_conv_in_mma_pool_mask_decomposition_matches_twin(cout, k):
    """Conv 0 of a training step in bf16 on 2 float32 tiles: the emulated
    kernel with the pool-and-bits epilogue (``CiPoolMaskEpi``) against
    ``ae_train_in_plain``: p1 within one bf16 ulp, the routing bits equal
    but in the near ties ``route_bits64`` counts; the float32 tiles
    rounded as staged (K5, ``CiSpecSrc``) and the bf16 tiles (K5b,
    ``CiBf16Src``) give the same bits."""
    model = make_model(_in_conv_cfg(cout, k), generator=torch.Generator().manual_seed(k))
    tw = ttk.build_train_weights(model, torch.bfloat16)
    w, bias = tw.fwd.w[0], tw.fwd.b[0]
    x = torch.rand(2, 256, 128, generator=torch.Generator().manual_seed(cout + k + 2))
    got, bits = conv_in_mma_emulated(x, w, k, "pool_mask", bias)
    pre, pbits = conv_in_mma_emulated(x.to(torch.bfloat16), w, k, "pool_mask", bias)
    assert torch.equal(got, pre) and torch.equal(bits, pbits)
    want, wbits = ttk.ae_train_in_plain(tw, x)
    assert got.shape == want.shape == bits.shape == (2, cout, 128, 64)
    assert _bf16_ulp_excess(got, want) <= 0
    assert torch.equal(got, conv_in_mma_emulated(x, w, k, "pool", bias))
    _check_routes(bits, wbits, x.to(torch.bfloat16).float(), w.float(), bias, (cout, k))


@pytest.mark.parametrize("name", ["k3", "deep3"])
def test_conv_in_mma_conv0_matches_jax(name):
    """Conv 0 of a training step, emulated as ``conv_in_mma_kernel`` with
    ``CiPoolMaskEpi`` computes it, against JAX's conv 1 (the Flax model's
    ``enc_conv0``, relu, 2x2 max pool and the routing mask (r == p) * (p >
    0) of ``specenh/ops/ae_train_kernel.py``) on the same 2 tiles: in
    float32 p1 within 2^-17 of its scale and, in bf16 (JAX given the tiles
    and kernel rounded to bf16), within one bf16 ulp; the routing bits
    equal (and equal the float64 bits) but in the near ties
    ``route_bits64`` counts."""
    cfg = IGEMM_GEOMETRIES[name]
    jcfg = JModelConfig(filters=cfg.filters, kernels=cfg.kernels, out_kernel=cfg.out_kernel)
    params = flax_model(jcfg).init(jax.random.PRNGKey(2), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    x = _tiles(n=2, seed=9)[0]
    p0 = params["params"]["enc_conv0"]
    c1, k = cfg.filters[0], cfg.kernels[0][0]
    conv = nn.Conv(c1, (k, k), padding="SAME", precision=jax.lax.Precision.HIGHEST)
    for dt in (torch.float32, torch.bfloat16):
        tw = ttk.build_train_weights(model, dt)
        xs = torch.from_numpy(x[..., 0])
        got, bits = conv_in_mma_emulated(xs, tw.fwd.w[0], k, "pool_mask", tw.fwd.b[0], dtype=dt)
        bf = dt == torch.bfloat16

        def rnd(a):
            a = jnp.asarray(a)
            return a.astype(jnp.bfloat16).astype(jnp.float32) if bf else a

        r = jax.nn.relu(conv.apply({"params": {"kernel": rnd(p0["kernel"]), "bias": p0["bias"]}},
                                   rnd(x)))
        rq = r.reshape(2, 128, 2, 64, 2, c1)
        p = rq.max((2, 4))
        jbits = sum(((rq[:, :, a, :, c] == p) & (p > 0)).astype(jnp.uint8) << (2 * a + c)
                    for a in (0, 1) for c in (0, 1))
        want = torch.from_numpy(np.array(p)).permute(0, 3, 1, 2)
        wbits = torch.from_numpy(np.array(jbits)).permute(0, 3, 1, 2)
        if bf:
            assert _bf16_ulp_excess(got, want) <= 0
        else:
            assert float((got - want).abs().max()) <= 2.0 ** -17 * float(want.abs().max())
        xr = xs.to(torch.bfloat16).float() if bf else xs
        _check_routes(bits, wbits, xr, tw.fwd.w[0].float(), tw.fwd.b[0], (name, dt))


@pytest.mark.parametrize("name", ["flagship", "deep3"])
def test_conv_in_mma_s1_chain_matches_twin_and_jax(name):
    """The bf16 serving chain with the emulated S1 in place of its twin:
    against the twins' chain and against JAX's K3 (flagship) or K6 (deep3)
    with its tile turns in interpret mode (the bounds of
    test_conv_out_mma_s4_chain_matches_twin_and_jax, 5e-3)."""
    cfg = ModelConfig() if name == "flagship" else MODEL_PRESETS["deep3"]
    jcfg = JModelConfig(filters=cfg.filters, kernels=cfg.kernels, out_kernel=cfg.out_kernel)
    params = flax_model(jcfg).init(jax.random.PRNGKey(3), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    x = np.random.default_rng(6).standard_normal((2, SP.n_samples)).astype(np.float32)
    specs, k = spectrogram(torch.from_numpy(x), SP), 3
    wts = tak.build_kernel_weights(model, torch.bfloat16)
    act = conv_in_mma_emulated(patch(specs[:, :, :k * 128]), wts.w[0], wts.k(0), "pool",
                               wts.b[0])
    got = tak._enhance_pooled(wts, act, k).numpy()
    twin = tak.ae_kernel_enhance_specs(wts, specs, k).numpy()
    if name == "flagship":
        want = jak.ae_kernel_enhance_specs(jak.build_kernel_weights(params, jcfg),
                                           jnp.asarray(specs.numpy()), k, interpret=True)
    else:
        want = jak3.ae3_kernel_enhance_specs(jak3.build_kernel3_weights(params, jcfg),
                                             jnp.asarray(specs.numpy()), k, interpret=True)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 256, k * 128)
    np.testing.assert_allclose(got, twin, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


def _out_dgrad_emulated(tw, layer, dz, gate, dz_bits=None):
    """``ae_train_dgrad_conv`` with the out-conv's launch emulated as
    ``conv_in_mma_kernel`` computes it (in the kernel dtype; float32: no
    rounding); the encoder convs' are the twin."""
    if layer != tw.fwd.out:
        return ttk.ae_train_dgrad_conv_plain(tw, layer, dz, gate, dz_bits)
    return conv_in_mma_emulated(dz[:, 0], tw.bwd[layer], tw.fwd.k(layer), "gate", gate=gate,
                                dtype=tw.dtype)


@pytest.mark.parametrize("name", ["k3", "deep3"])
def test_conv_in_mma_out_conv_gradient_in_the_chain_matches_flax(name):
    """float32: the twins' backward with the out-conv's input gradient
    emulated as the tensor-core kernel computes it, normalised, against
    autodiff of the Flax model (2e-5 of the scale, the bound of
    test_conv_igemm_routed_gradient_in_the_chain_matches_flax)."""
    cfg = IGEMM_GEOMETRIES[name]
    jcfg = JModelConfig(filters=cfg.filters, kernels=cfg.kernels, out_kernel=cfg.out_kernel)
    fm = flax_model(jcfg)
    params = fm.init(jax.random.PRNGKey(0), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    x, y, mask = _tiles(n=1, seed=6)
    tw = ttk.build_train_weights(model, torch.float32)
    xs, ys, ms = ttk._inputs(tw, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), False)
    saved, _, bce = ttk._forward(tw, xs, ys, ms, False, ttk._PLAIN)
    gw, gb = ttk._backward(tw, saved, False, dict(ttk._PLAIN, dgrad_conv=_out_dgrad_emulated))
    _, grads = ttk.normalise((bce[0], ms.sum(), ttk.grads_to_torch(gw, gb)))
    _, ref = jax.value_and_grad(lambda p: jbce(fm.apply(p, x, logits=True), y, mask))(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref), cfg)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert err < 2e-5 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_conv_in_mma_strips_cover_the_grid(k):
    """The kernel's split, for every channel count S1 and the out-conv take
    (16 to 64) and both epilogues, as the C launcher plans it: strips of R
    rows (R even) tile the 256 rows once, their 4 R fragment pairs (row
    pair, 16 columns) whole rounds of the 8 warps; the window's two copies,
    the B fragments and the stage fit the 227 KB of shared memory (less the
    gate's 2 KB reduction); the gradient's partial rows are one per (tile,
    strip); and every A load (lane l's pair 8 c + 4 h + l % 4 at column 2 (l
    / 4) + m of fragment m of a pair) reads one copy of the window and puts
    its 32 words in 32 banks."""
    pairs = _tap_pairs(k)
    for cout in (16, 32, 48, 64):
        for pool in (True, False):
            rows = tak.conv_in_strip(cout, pool)
            assert 256 % rows == 0 and rows % 2 == 0 and 4 * rows % 8 == 0
            assert sorted(y for y0 in range(0, 256, rows) for y in range(y0, y0 + rows)) \
                == list(range(256))
            assert tak._conv_in_smem(k, cout, pool) <= 227 * 1024 - 2048, (cout, pool)
        assert tak._conv_in_smem(k, cout, True, bits=True) <= 227 * 1024 - 2048, cout
        assert ttk.conv_in_rows(5, 256, cout) == 5 * 256 // tak.conv_in_strip(cout, False)
    for c, h, m in itertools.product(range(-(-2 * len(pairs) // 16)), (0, 1), (0, 1)):
        words = set()
        for lane in range(32):
            p = 8 * c + 4 * h + lane % 4
            q = p if p < len(pairs) else (8 * c + 4 * h if 8 * c + 4 * h < len(pairs) else 0)
            i, j = pairs[q]
            col = 2 * (lane // 4) + m + j - k // 2 + CI_XO
            words.add((col % 2, i * CI_RS + col // 2))  # (copy, word in it)
        assert len({cp for cp, _ in words}) == 1, (c, h, m)
        assert len({wd % 32 for _, wd in words}) == len(words), (c, h, m)


# ---------------------------------------------------------------------------
# the fixed-order sum of partial rows
# ---------------------------------------------------------------------------


def sum_rows_emulated(part):
    """``ae_train_sum`` in float32 in the kernel's order: slab y of
    ``sum_slabs`` holds rows n * y // slabs .. n * (y + 1) // slabs - 1;
    warp w sums its rows w, w + 8, .. in order; then ((w0 + w4) + (w2 +
    w6)) + ((w1 + w5) + (w3 + w7)); with more than one slab, the same over
    the slabs' sums."""
    def one_pass(p, slabs):
        n = p.shape[0]
        out = torch.empty(slabs, p.shape[1])
        for y in range(slabs):
            r0, r1 = n * y // slabs, n * (y + 1) // slabs
            warp = []
            for w in range(8):
                s = torch.zeros(p.shape[1])
                for r in range(r0 + w, r1, 8):
                    s = s + p[r]
                warp.append(s)
            for stride in (4, 2, 1):
                warp = [warp[w] + warp[w + stride] for w in range(stride)]
            out[y] = warp[0]
        return out

    slabs = ttk.sum_slabs(*part.shape)
    first = one_pass(part, slabs)
    return (first if slabs == 1 else one_pass(first, 1))[0]


@pytest.mark.parametrize("shape", [(8192, 2), (4096, 32), (4096, 288), (600, 64), (300, 2400),
                                   (1, 5), (70, 3)])
def test_sum_order_matches_sum64(shape):
    """The kernel's order in float32 against the twin's float64 sum: within
    float32 rounding (1e-6 of the column's sum of magnitudes); the slabs
    fill at most 264 blocks and hold 64 rows or more."""
    n, m = shape
    part = torch.randn(shape, generator=torch.Generator().manual_seed(n + m))
    got, want = sum_rows_emulated(part), ttk._sum64(part, 0)
    assert got.dtype == want.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-6 * part.abs().sum(0)).all())
    slabs = ttk.sum_slabs(n, m)
    assert slabs == 1 or (slabs * -(-m // 32) <= 264 and n // slabs >= 64)


def sum_plan_emulated(parts):
    """A step's sums as ``StepSums`` runs them (``ae_train_sum``'s segment
    table): pass 1 over every segment's slabs, blocks numbered segment by
    segment (groups x slabs each, block l taking column group l % groups
    of slab l // groups), a segment with one slab straight into its output;
    pass 2 over the slab sums of the others.  Returns the sums and, per
    segment, how often each (row, column) was read in pass 1."""
    def one_pass(table):
        starts = np.cumsum([0] + [-(-m // 32) * slabs for _, m, slabs in table])
        outs = [torch.empty(slabs, m) for _, m, slabs in table]
        reads = [torch.zeros(p.shape, dtype=torch.int32) for p, _, _ in table]
        for blk in range(starts[-1]):
            i = int(np.searchsorted(starts, blk, side="right")) - 1  # its segment
            p, m, slabs = table[i]
            n, groups, l = p.shape[0], -(-m // 32), blk - starts[i]
            cols = slice(l % groups * 32, min(m, l % groups * 32 + 32))
            y = l // groups
            r0, r1 = n * y // slabs, n * (y + 1) // slabs
            warp = []
            for w in range(8):
                s = torch.zeros(cols.stop - cols.start)
                for r in range(r0 + w, r1, 8):
                    s = s + p[r, cols]
                    reads[i][r, cols] += 1
                warp.append(s)
            for stride in (4, 2, 1):
                warp = [warp[w] + warp[w + stride] for w in range(stride)]
            outs[i][y, cols] = warp[0]
        return outs, reads

    first, reads = one_pass([(p, p.shape[1], ttk.sum_slabs(*p.shape)) for p in parts])
    two = [i for i, f in enumerate(first) if f.shape[0] > 1]
    second, _ = one_pass([(first[i], first[i].shape[1], 1) for i in two])
    for i, v in zip(two, second):
        first[i] = v
    return [f[0] for f in first], reads


@pytest.mark.parametrize("name", ["k3", "deep3"])
def test_step_sums_plan_matches_per_call_order(name):
    """A step's partial arrays (``step_partials``, 2 tiles; the segments of
    a K5 or K7 step) summed as one plan: its table reads every partial row
    once, and each segment's sums equal the per-call order bit for bit;
    the plan's columns are the step's parameters plus the BCE; the loss
    hands in one row per (tile, band) of ``conv_out_mma_kernel`` and the
    out-conv's input gradient one bias row per (tile, strip) of
    ``conv_in_mma_kernel`` in bf16, each one per quad block in float32."""
    model = make_model(IGEMM_GEOMETRIES[name], generator=torch.Generator())
    tw = ttk.build_train_weights(model, torch.bfloat16)
    shapes = ttk.step_partials(tw, 2)
    c1 = tw.fwd.w[tw.fwd.out].shape[0]
    assert shapes[0] == (2 * 256 // tak.CONV_OUT_BAND, 2)
    assert shapes[2] == (ttk.conv_in_rows(2, 256, c1), c1)
    f32 = ttk.step_partials(ttk.build_train_weights(model, torch.float32), 2)
    assert f32[0] == (ttk._rows(2, 256, 128), 2)
    assert f32[2] == (ttk._rows(2, 256, 128), c1)
    assert len(shapes) == 4 * tw.fwd.depth + 2 <= 32
    g = torch.Generator().manual_seed(7)
    parts = [torch.randn(n, m, generator=g) for n, m in shapes]
    got, reads = sum_plan_emulated(parts)
    for p, s, r in zip(parts, got, reads):
        assert bool((r == 1).all())
        assert torch.equal(s, sum_rows_emulated(p))
    n_params = sum(t.numel() for t in (*tw.fwd.w, *tw.fwd.b))
    assert sum(m for _, m in shapes) == n_params + 1


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


TB = 16  # frames per block


def k1_emulated(traces: torch.Tensor, sp):
    """K1 (F, T) as the kernel computes it: (log-PSD, min, max)."""
    n, nh = sp.nperseg, sp.nperseg // 2
    tab = torch.as_tensor(tsf.fft_table(sp), dtype=torch.float32)
    win = tab[:n]
    w256 = torch.complex(tab[n:n + nh], tab[n + nh:n + 2 * nh])
    w512 = torch.complex(tab[n + 2 * nh:n + 3 * nh + 1], tab[n + 3 * nh + 1:])
    weights = torch.as_tensor(tstft.psd_weights(sp), dtype=torch.float32)
    i16 = torch.arange(16)
    w16 = w256[(16 * i16[:, None] * i16[None, :]) % nh]       # W16^(a b)
    tw = w256[(i16[:, None] * i16[None, :]) % nh]              # W256^(n1 k2)
    tc = torch.arange(n, dtype=torch.float32) - (n - 1) / 2
    s2 = float(np.sum((np.arange(n) - (n - 1) / 2) ** 2))
    c, nt = traces.shape[0], sp.n_frames
    out = torch.empty(c, nh + 1, nt)
    mins, maxs = [], []
    for t0 in range(0, nt, TB):  # one block of frames
        nvalid = min(TB, nt - t0)
        hops = traces[:, t0 * sp.hop:(t0 + nvalid - 1) * sp.hop + n]  # loaded once
        fr = hops.unfold(-1, n, sp.hop)                          # (C, nvalid, 512)
        fr = fr - fr.sum(-1, keepdim=True) / n                   # the mean first
        fr = fr - (fr * tc).sum(-1, keepdim=True) / s2 * tc      # then the slope
        fr = fr * win
        z = torch.complex(fr[..., 0::2], fr[..., 1::2]).reshape(c, nvalid, 16, 16)
        y = torch.einsum("...ab,ac->...bc", z, w16) * tw         # [n1][k2]
        zk = torch.einsum("...ab,ac->...cb", y, w16).reshape(c, nvalid, nh)
        zm = zk[..., (-torch.arange(nh)) % nh].conj()            # Z*[256 - k]
        xk = (zk + zm) / 2 - 1j * w512[:nh] * (zk - zm) / 2
        xn = zk[..., :1].real - zk[..., :1].imag                 # Nyquist
        psd = torch.cat([xk.real ** 2 + xk.imag ** 2, xn ** 2], -1)
        v = torch.log(psd * weights + sp.eps).transpose(1, 2)    # (C, 257, nvalid)
        out[:, :, t0:t0 + nvalid] = v
        mins.append(v.amin((1, 2)))
        maxs.append(v.amax((1, 2)))
    return out, torch.stack(mins, 1).amin(1, keepdim=True), torch.stack(maxs, 1).amax(1, keepdim=True)


@pytest.fixture(scope="module")
def traces():
    return np.random.default_rng(0).standard_normal((2, SP.n_samples)).astype(np.float32)


def test_k1_decomposition_matches_twin_and_jax(traces):
    """The emulated K1 against the twin and JAX's float32 kernel, at the
    bounds of tests/test_torch_fused_front.py (rtol 1e-5, atol 1e-4)."""
    assert SP.n_frames % TB != 0
    got, mn, mx = k1_emulated(torch.from_numpy(traces), SP)
    want, wmn, wmx = tsf.stft_ft_log_plain(torch.from_numpy(traces), SP)
    ja, jmn, jmx, _ = jsf.stft_ft_log(jnp.asarray(traces), SP, bf16=False, interpret=True)
    for ref, rmn, rmx in ((want.numpy(), wmn.numpy(), wmx.numpy()),
                          (np.asarray(ja)[:, :257, :SP.n_frames], np.asarray(jmn),
                           np.asarray(jmx))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(mn.numpy(), rmn, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(mx.numpy(), rmx, rtol=1e-5, atol=1e-4)


def test_fft_table_is_window_and_twiddles():
    """The kernel's table: the periodic Hamming window, then W256^k and
    W512^k (cos, sin of -2 pi k / n), from float64."""
    tab = tsf.fft_table(SP)
    assert tab.dtype == np.float64 and tab.shape == (512 + 2 * 256 + 2 * 257,)
    np.testing.assert_array_equal(tab[:512], tstft.hamming_periodic(512))
    k = np.arange(257)
    np.testing.assert_allclose(tab[512:768] + 1j * tab[768:1024],
                               np.exp(-2j * np.pi * k[:256] / 256), atol=1e-15)
    np.testing.assert_allclose(tab[1024:1281] + 1j * tab[1281:],
                               np.exp(-2j * np.pi * k / 512), atol=1e-15)
