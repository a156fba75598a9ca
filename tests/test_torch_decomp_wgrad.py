"""Plain-torch emulation of the CUDA weight-gradient kernel's block
decomposition, on the CPU where the kernel cannot run, held against the
plain twin and the JAX package:

- the weight-gradient kernel (``csrc/ae_train.cu`` ``wgrad_kernel``, split
  by ``ops.ae_train_kernel.wgrad_plan``): per (tile, row group, slice of
  D's rows) block, strips of rows with the taps' halo (zeros at the tile's
  edges), the transposed convs' dz as four phase planes with the S = 2 /
  OFF shifts, routed dz decoded once per strip, each tap read from the
  staged strip, sums over the strips in order and partial rows summed in
  order; against the twin and Flax autodiff for k3, k5 and k7.

The other kernels' emulations are in ``tests/test_torch_decomp.py`` and its
siblings; shared helpers in ``tests/_torch_decomp_common.py``."""

import numpy as np
import pytest
import torch

import jax

from specenh.config import ModelConfig as JModelConfig
from specenh.models.autoencoder import make_model as flax_model
from specenh.train import bce_from_logits as jbce
from specenh_torch import ModelConfig
from specenh_torch.models.autoencoder import convt_pad_before, make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_train_kernel as ttk
from tests._torch_decomp_common import _tiles


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
