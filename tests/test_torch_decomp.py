"""Plain-torch emulations of the CUDA kernels' block decompositions, on the
CPU where the kernels cannot run, held against the plain twins and the JAX
package:

- the weight-gradient kernel (``csrc/ae_train.cu`` ``wgrad_kernel``, split
  by ``ops.ae_train_kernel.wgrad_plan``): per (tile, row group, slice of
  D's rows) block, strips of rows with the taps' halo (zeros at the tile's
  edges), the transposed convs' dz as four phase planes with the S = 2 /
  OFF shifts, routed dz decoded once per strip, each tap read from the
  staged strip, sums over the strips in order and partial rows summed in
  order; against the twin and Flax autodiff for k3, k5 and k7;
- the transposed convs' input gradient (``convt_dgrad_kernel``, split by
  ``ops.ae_train_kernel.dgrad_convt_rows``): per (tile, strip) block, dz's
  phase planes staged with the taps' halo one channel chunk at a time,
  each chunk summed on its own and added in order, the gate, one bias
  partial row per block; against the twin and Flax autodiff;
- the tensor-core stride-1 conv (``csrc/ae_conv.cuh`` ``conv_igemm_kernel``,
  split by ``ops.ae_train_kernel.conv_igemm_rows``): per (tile, strip)
  block, the input rows with the taps' halo staged one 16-channel chunk at
  a time, each chunk summed on its own and added in order, its three
  epilogues (pool; pool and routing bits; the routed input gradient's gate
  and one bias partial row per block); against the twins, JAX's K3 in
  interpret mode and Flax autodiff;
- the tensor-core transposed conv (``convt_igemm_kernel``, split by
  ``ops.ae_kernel.convt_igemm_rows``): per (tile, strip) block, the input
  rows with the taps' halo staged one 16-channel chunk at a time, each
  output parity a stride-1 product over its taps, each chunk summed on its
  own and added in order, bias, relu, one rounding; against the twin,
  Flax's ``ConvTranspose`` and JAX's K3 in interpret mode;
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
  and JAX's ``stft_ft_log`` in interpret mode."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from specenh.config import ModelConfig as JModelConfig, SpecParams
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import ae3_kernel as jak3
from specenh.ops import ae_kernel as jak
from specenh.ops import ae_train_kernel as jtk
from specenh.ops import stft_fused as jsf
from specenh.train import bce_from_logits as jbce
from specenh_torch import ModelConfig
from specenh_torch.config import MODEL_PRESETS
from specenh_torch.data.tiles import patch, unpatch
from specenh_torch.models.autoencoder import convt_pad_before, make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops import ae_train_kernel as ttk
from specenh_torch.ops.stft import spectrogram
from specenh_torch.ops import stft as tstft
from specenh_torch.ops import stft_fused as tsf

# ---------------------------------------------------------------------------
# the weight-gradient kernel
# ---------------------------------------------------------------------------


def wgrad_emulated(tw, layer, inp, dz, dz_bits=None, pre=False):
    """``ae_train_wgrad`` as the kernel computes it, block by block."""
    k, convt = tw.fwd.k(layer), tw.fwd.is_convt(layer)
    x = inp.to(tw.dtype).float()
    x = x[:, None] if x.ndim == 3 else x
    b, cin, h, w = x.shape
    cout, kk = tw.fwd.cout(layer), k * k
    stride, off = (2, convt_pad_before(k)) if convt else (1, k // 2)
    plan = ttk.wgrad_plan(cin, cout, k, h, w, stride, off, tw.dtype.itemsize)
    taps, lo, r = plan.taps(), plan.hlo, plan.rows
    m_rows, per_slice = plan.ct * kk, plan.gm * plan.mw * 16
    part = torch.empty(b * plan.sg, cin * kk * cout)
    for bi in range(b):
        if convt:  # T: dz's phase planes (Cout, 4, H, W); P: the input
            d = dz[bi].float()
            t_all = torch.stack([d[:, ry::2, rx::2] for ry in (0, 1) for rx in (0, 1)], 1)
            p_src = x[bi]
        else:  # T: the input (Cin, 1, H, W); P: dz, routed below if pooled
            t_all, p_src = x[bi][:, None], dz[bi].float()
        # the 'same' padding: T is zero outside its (H, W) grid
        t_pad = torch.nn.functional.pad(t_all, (-lo, plan.hhi, -lo, plan.hhi))
        for s in range(plan.slices):
            row0, row1 = s * per_slice, min(m_rows, (s + 1) * per_slice)
            tc0 = row0 // kk
            for g in range(plan.sg):
                acc = torch.zeros(row1 - row0, plan.cp)
                for y0 in range(g * h // plan.sg, (g + 1) * h // plan.sg, r):
                    # the strip: T rows y0 + hlo .. y0 + R - 1 + hhi of the
                    # slice's channels, and P's R rows (decoded once)
                    ts = t_pad[tc0:(row1 - 1) // kk + 1, :, y0:y0 + r + plan.hhi - lo]
                    if dz_bits is None or convt:
                        ps = p_src[:, y0:y0 + r]
                    else:
                        ps = ttk.route_expand(dz[bi:bi + 1, :, y0 // 2:(y0 + r) // 2].float(),
                                              dz_bits[bi:bi + 1, :, y0 // 2:(y0 + r) // 2])[0]
                    for row in range(row0, row1):
                        plane, dy, dx = taps[row % kk]
                        win = ts[row // kk - tc0, plane, dy - lo:dy - lo + r, dx - lo:dx - lo + w]
                        acc[row - row0] += torch.einsum("yx,cyx->c", win, ps)
                for row in range(row0, row1):
                    t, tap = divmod(row, kk)
                    for c in range(plan.cp):
                        ci, co = (t, c) if stride == 1 else (c, t)
                        part[bi * plan.sg + g, (ci * kk + tap) * cout + co] = acc[row - row0, c]
    return ttk.ae_train_sum(part).reshape(cin, k, k, cout)


GEOMETRIES = {
    "k3": dict(),
    "k5": dict(kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    "k7": dict(kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
}


def _tiles(n=2, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 256, 128, 1)).astype(np.float32)
    y = (rng.random((n, 256, 128, 1)) > 0.6).astype(np.float32)
    return x, y, np.ones(n, np.float32)


def _emulated_grads(model, x, y, mask, dtype):
    """Gradient sums of the twins' chain with the emulated weight
    gradients in place of the twin's, normalised."""
    tw = ttk.build_train_weights(model, dtype)
    xs, ys, ms = ttk._inputs(tw, torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask), False)
    saved, _, bce = ttk._forward(tw, xs, ys, ms, False, ttk._PLAIN)
    f = dict(ttk._PLAIN, wgrad=wgrad_emulated)
    gw, gb = ttk._backward(tw, saved, False, f)
    plain = ttk._backward(tw, saved, False, ttk._PLAIN)
    return ttk.normalise((bce[0], ms.sum(), ttk.grads_to_torch(gw, gb))), \
        ttk.grads_to_torch(*plain), ttk.grads_to_torch(gw, gb)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_wgrad_decomposition_matches_twin_and_flax(name):
    """float32: the emulated weight gradients of every layer against the
    twin's (f32 sums in another order: 1e-5 of each layer's scale) and,
    normalised, against autodiff of the Flax model (2e-5 of the scale, the
    bound of test_torch_train_kernel.py)."""
    kw = GEOMETRIES[name]
    fm = flax_model(JModelConfig(**kw))
    params = fm.init(jax.random.PRNGKey(0), np.zeros((1, 256, 128, 1), np.float32))
    model = make_model(ModelConfig(**kw), generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, ModelConfig(**kw)))
    x, y, mask = _tiles()
    (_, grads), twin, emu = _emulated_grads(model, x, y, mask, torch.float32)
    for key in twin:
        if key.endswith("weight"):
            scale = float(twin[key].abs().max())
            assert float((emu[key] - twin[key]).abs().max()) <= 1e-5 * max(scale, 1e-6), key
    _, ref = jax.value_and_grad(lambda p: jbce(fm.apply(p, x, logits=True), y, mask))(params)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref), ModelConfig(**kw))
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert err < 2e-5 * max(scale, 1.0), (err, scale)


def test_wgrad_decomposition_bf16_and_deep3_match_twin():
    """bf16 operands (the values the kernel stages) and the depth-3 family's
    layer kinds (16 -> 32 -> 64 channels, k5): the emulation against the
    twin, layer by layer, to 1e-5 of each layer's scale."""
    x, y, mask = _tiles(n=1, seed=5)
    for cfg, dt in ((ModelConfig(), torch.bfloat16),
                    (ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3,
                                 out_kernel=(5, 5)), torch.bfloat16)):
        model = make_model(cfg, generator=torch.Generator().manual_seed(1))
        _, twin, emu = _emulated_grads(model, x, y, mask, dt)
        for key in twin:
            scale = float(twin[key].abs().max())
            assert float((emu[key] - twin[key]).abs().max()) <= 1e-5 * max(scale, 1e-6), key


@pytest.mark.parametrize("args", [
    (1, 32, 3, 256, 128, 1, 1), (32, 32, 3, 128, 64, 1, 1), (32, 32, 3, 64, 32, 2, 2),
    (32, 1, 3, 256, 128, 1, 1), (64, 64, 5, 32, 16, 2, 3), (32, 64, 5, 64, 32, 1, 2),
    (64, 32, 7, 128, 64, 1, 3), (48, 48, 3, 128, 64, 1, 1), (1, 64, 7, 256, 128, 1, 3),
])
@pytest.mark.parametrize("item", [2, 4], ids=["bf16", "f32"])
def test_wgrad_plan_covers_the_layer(args, item):
    """Every plan covers D's rows with whole slices, splits the tile's rows
    into whole strips, bounds the steps an accumulator takes, keeps a
    thread's accumulators at 64 and a block's shared memory within the
    card's 227 KB."""
    cin, cout, k, h, w, stride, off = args
    p = ttk.wgrad_plan(cin, cout, k, h, w, stride, off, item)
    mf, np_ = -(-p.ct * k * k // 16), -(-p.cp // 8)
    assert p.gm in (1, 2, 4, 8) and p.slices * p.gm * p.mw >= mf
    assert (p.slices - 1) * p.gm * p.mw < mf
    assert h % (p.sg * p.rows) == 0 and p.rows % 2 == 0
    assert h // p.sg * w // 16 <= ttk._WG_CHAIN * (8 // p.gm)
    assert p.mw * np_ * 4 <= 64
    shifts = [d for _, d, _ in p.taps()]
    assert (p.hlo, p.hhi) == (min(shifts), max(shifts))
    nph = 4 if stride == 2 else 1
    assert ttk._wg_bytes(p.ct, p.cp, k, h, w, p.rows, nph, p.hlo, p.hhi, p.gm, p.mw,
                         item) <= 227 * 1024


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

SP = SpecParams(cut_shot=0.2)  # 389 frames: not a multiple of 16
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
