"""The CUDA kernels (serving in every STFT mode and training, depth 2 and 3,
and the toolchain probes) against their plain twins, and the SVD denoiser,
the cross power and ``e2e.train_from_raw`` on the card against the CPU, on a
GPU (marker ``gpu``; skipped where no CUDA device is present).  This file imports no jax, so it
runs where only torch is installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from specenh_torch import ModelConfig, SpecParams, _build, probe_walls
from specenh_torch.bench import harness
from specenh_torch.bench.reference import ssim
from specenh_torch.models.autoencoder import make_model
from specenh_torch.config import MODEL_PRESETS
from specenh_torch.ops import ae3_kernel as tak3
from specenh_torch.ops import ae3_train_kernel as ttk3
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops import ae_train_kernel as ttk
from specenh_torch.ops import stft_fused as tsf

pytestmark = pytest.mark.gpu

SP = SpecParams(cut_shot=0.2)
DEPTH3 = [
    MODEL_PRESETS["deep3"],
    ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3, out_kernel=(7, 7)),
    ModelConfig(filters=(48, 16, 48), kernels=((3, 3), (5, 5), (1, 1)), out_kernel=(3, 3)),
]
DEPTH3_IDS = ["deep3", "64-32-64k7", "48-16-48mixed"]
GEOMETRIES = [
    ModelConfig(),
    ModelConfig(kernels=((1, 1), (1, 1)), out_kernel=(1, 1)),
    ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
    ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    ModelConfig(filters=(64, 64), kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def traces(cuda):
    x = np.random.default_rng(0).standard_normal((3, SP.n_samples + 7))
    return torch.from_numpy(x.astype(np.float32)).to(cuda)


def test_stft_kernel_matches_twin(traces):
    before = tsf.STFT_KERNEL.launches
    out, mn, mx = tsf.stft_ft_log(traces, SP)
    ref, rmn, rmx = tsf.stft_ft_log_plain(traces, SP)
    assert tsf.STFT_KERNEL.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)
    torch.testing.assert_close(mn, rmn, rtol=0, atol=2e-3)
    torch.testing.assert_close(mx, rmx, rtol=0, atol=2e-3)


@pytest.mark.parametrize("cfg", GEOMETRIES, ids=["k3", "k1", "k5", "k7", "manual", "64x64k7"])
def test_ae_kernels_match_module(cuda, traces, cfg):
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda).eval()
    specs = tsf.spectrogram_fused(traces, SP)
    with torch.no_grad():
        want = tak.ae_kernel_enhance_specs_plain(model, specs, 3)
    got = tak.ae_kernel_enhance_specs(tak.build_kernel_weights(model, torch.float32), specs, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    got16 = tak.ae_kernel_enhance_specs(tak.build_kernel_weights(model, torch.bfloat16), specs, 3)
    assert float((got16 - want).abs().max()) < 2e-2


def test_weights_on_another_device_raise(traces):
    wts = tak.build_kernel_weights(make_model(ModelConfig(), generator=torch.Generator()))
    with pytest.raises(ValueError):
        tak.ae_tile_in(wts, tsf.spectrogram_fused(traces, SP), 3)


def _train_setup(cuda, cfg, n=3):
    model = make_model(cfg, generator=torch.Generator().manual_seed(2), device=cuda)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((n, 256, 128)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.random((n, 256, 128)).astype(np.float32)).to(cuda)
    mask = torch.ones(n, device=cuda)
    mask[-1] = 0.0
    return model, x, y, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", GEOMETRIES + DEPTH3,
                         ids=["k3", "k1", "k5", "k7", "manual", "64x64k7"] + DEPTH3_IDS)
def test_train_stages_match_twins(cuda, cfg, dtype):
    """Every training stage against its twin on the same stored inputs (the
    kernel stage's own, as a step feeds them): activations and dz within one
    ulp of the dtype, routing bits equal except on ties (<= 1e-4 of them),
    logits to 1e-3, gradient sums to 1e-4 of their scale (f32 sums in
    another order)."""
    model, x, y, mask = _train_setup(cuda, cfg)
    tw = ttk.build_train_weights(model, dtype)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    pairs = []

    def both(name):
        def call(*args, **kw):
            out = ttk._KERNEL[name](*args, **kw)
            pairs.append((name, out, ttk._PLAIN[name](*args, **kw)))
            return out
        return call

    def act(name, a, b):
        excess = float(((a.float() - b.float()).abs() - ulp * b.float().abs() - 1e-5).max())
        assert excess <= 0, f"{name}: beyond one ulp by {excess:.3g}"

    def sums(name, a, b):
        err, scale = float((a - b).abs().max()), max(float(b.abs().max()), 1.0)
        assert err <= 1e-4 * scale, f"{name}: |err| {err:.3g} of scale {scale:.3g}"

    stages = {name: both(name) for name in ttk._KERNEL}
    before = _templates()
    saved, _, _ = ttk._forward(tw, x, y, mask, False, stages)
    ttk._backward(tw, saved, False, stages)
    took = _took(before)
    assert {n for n, _, _ in pairs} == set(ttk._KERNEL)
    # bf16: conv 0 and the out-conv's input gradient on conv_in_mma_kernel,
    # the loss on conv_out_mma_kernel, no conv_quad_kernel; float32: every
    # stride-1 conv on conv_quad_kernel
    d = tw.fwd.depth
    bf = dtype == torch.bfloat16
    want = {"conv_quad_kernel": 0 if bf else 2 * d + 1,
            "conv_igemm_kernel": 2 * (d - 1) if bf else 0, "convt_relu_kernel": 0,
            "convt_igemm_kernel": 0, "conv_out_mma_kernel": int(bf), "conv_in_mma_kernel": 2 * bf}
    assert took["ae_train"] == want, took
    for i, (name, got, want) in enumerate(pairs):
        name = f"{name} (stage {i})"
        if name.startswith(("in_", "conv_pool")):
            act(name, got[0], want[0])
            assert float((got[1] != want[1]).float().mean()) <= 1e-4, name
        elif name.startswith("convt"):
            act(name, got, want)
        elif name.startswith("loss"):
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)
            act(name, got[1], want[1])
            torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
            sums(name, got[3], want[3])
        elif name.startswith("wgrad"):
            sums(name, got, want)
        else:
            act(name, got[0], want[0])
            sums(name, got[1], want[1])


@pytest.mark.parametrize("cfg", GEOMETRIES, ids=["k3", "k1", "k5", "k7", "manual", "64x64k7"])
def test_train_chain_matches_twin_chain(cuda, cfg):
    """float32, depth 2: the kernels' forward chain against the twins' own
    chain (activations within 1e-6 relative, routing bits equal except on
    ties, logits to 1e-3, BCE sum to rtol 1e-5), then the kernels' and the
    twins' backward chains from the kernels' forward: gradient sums to 1e-4
    of their scale."""
    model, x, y, mask = _train_setup(cuda, cfg)
    tw = ttk.build_train_weights(model, torch.float32)
    s, logits, bce = ttk._forward(tw, x, y, mask, False)
    p, plog, pbce = ttk._forward(tw, x, y, mask, False, ttk._PLAIN)
    for i, (a, b) in enumerate(zip(s["act"][1:] + [s["dz"]], p["act"][1:] + [p["dz"]])):
        assert bool(((a - b).abs() <= 1e-6 * b.abs() + 1e-5).all()), i
    for a, b in zip(s["bits"], p["bits"]):
        assert float((a != b).float().mean()) <= 1e-4
    torch.testing.assert_close(logits, plog, rtol=0, atol=1e-3)
    torch.testing.assert_close(bce, pbce, rtol=1e-5, atol=0)
    gw, gb = ttk._backward(tw, s, False)
    pw, pb = ttk._backward(tw, s, False, ttk._PLAIN)
    for a, b in zip(gw + gb, pw + pb):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1.0)


def test_k5_and_k5b_bit_identical(cuda):
    model, x, y, mask = _train_setup(cuda, ModelConfig())
    a = ttk.kernel_loss_grad_sums(model, x, y, mask, torch.bfloat16)
    b = ttk.kernel_loss_grad_sums(model, x, y, mask, torch.bfloat16, pre=True)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def test_kernel_grads_match_autograd(cuda):
    """float32 kernels against their whole plain twin and against autograd
    of the module (TF32 off): 1e-4 of the largest gradient, loss to rtol
    1e-5 (float32 sums in other orders)."""
    model, x, y, mask = _train_setup(cuda, ModelConfig())
    sums = ttk.kernel_loss_grad_sums(model, x, y, mask, torch.float32)
    plain = ttk.kernel_loss_grad_sums_plain(model, x, y, mask, torch.float32)
    torch.testing.assert_close(sums[0], plain[0], rtol=1e-5, atol=0)
    for k in sums[2]:
        assert float((sums[2][k] - plain[2][k]).abs().max()) <= \
            1e-4 * max(float(plain[2][k].abs().max()), 1.0), k
    loss, grads = ttk.kernel_value_and_grad(model, x, y, mask, torch.float32)
    model.zero_grad()
    ref = ttk.masked_bce_from_logits(model(x, logits=True), y, mask)
    ref.backward()
    scale = max(float(p.grad.abs().max()) for p in model.parameters())
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    for name, p in model.named_parameters():
        assert float((grads[name] - p.grad).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("cfg", DEPTH3, ids=DEPTH3_IDS)
def test_ae3_kernels_match_module(cuda, traces, cfg):
    """The depth-3 stage kernels, composed, against the module: float32 to
    1e-4, bf16 to 2e-2 (the depth-2 bounds above)."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda).eval()
    specs = tsf.spectrogram_fused(traces, SP)
    with torch.no_grad():
        want = tak3.ae3_kernel_enhance_specs_plain(model, specs, 3)
    before = tak.CONVT.launches
    got = tak3.ae3_kernel_enhance_specs(tak3.build_kernel3_weights(model, torch.float32), specs, 3)
    assert tak.CONVT.launches == before + 3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    got16 = tak3.ae3_kernel_enhance_specs(tak3.build_kernel3_weights(model, torch.bfloat16), specs, 3)
    assert float((got16 - want).abs().max()) < 2e-2


def _autograd(model, x, y, mask, deterministic=True):
    """Loss, gradients and the gates of torch autograd of the module in
    float32, by default with cuDNN's deterministic algorithms (set and
    restored):
    the relu gates of the transposed convs (their outputs > 0, from
    forward hooks) and the routing bits of the encoder pools."""
    outs = {}
    mods = [*model.enc_convs, *model.dec_deconvs]
    hooks = [m.register_forward_hook(lambda _m, _i, o, k=k: outs.__setitem__(k, o.detach()))
             for k, m in enumerate(mods)]
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        model.zero_grad()
        ref = ttk.masked_bce_from_logits(model(x, logits=True), y, mask)
        ref.backward()
    finally:
        torch.backends.cudnn.deterministic = old
        for h in hooks:
            h.remove()
    d = model.cfg.depth
    bits = []
    for i in range(d):
        r = torch.relu(outs[i])
        bits.append(ttk.route_bits(r, torch.nn.functional.max_pool2d(r, 2)))
    relu = [outs[d + k] > 0 for k in range(d)]  # dec_deconvs[k] feeds layer 2d - k
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(ref.detach()), grads, bits, relu


@pytest.mark.parametrize("cfg", DEPTH3, ids=DEPTH3_IDS)
def test_ae3_kernel_grads_match_autograd(cuda, cfg):
    """float32 depth-3 kernels against their whole plain twin and against
    autograd of the module (TF32 off), with the depth-2 bounds.  Where a
    pool window's two largest values, or a transposed conv's output, lie
    within float32 rounding of each other or of 0, each chain's own forward
    may gate the gradient differently.  So the twins' backward also runs
    on the kernels' forward and must agree there; the twins' own chain, and
    autograd, must agree unless some gate differs between the forwards:
    the gates of autograd's forward are counted from forward hooks, as the
    twins' are.  Autograd's backward, and the twins (whose convs are
    cuDNN's), run with cuDNN's deterministic algorithms: two runs give the
    same bits (the default algorithms do not, so the twins' chain counted
    here could gate otherwise than the one compared)."""
    model, x, y, mask = _train_setup(cuda, cfg)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sums = ttk3.kernel_loss_grad_sums3(model, x, y, mask, torch.float32)
        plain = ttk3.kernel_loss_grad_sums3_plain(model, x, y, mask, torch.float32)
        tw = ttk3.build_train3_weights(model, torch.float32)
        s, _, _ = ttk._forward(tw, x, y, mask, False)
        p, _, _ = ttk._forward(tw, x, y, mask, False, ttk._PLAIN)
        fed = ttk.grads_to_torch(*ttk._backward(tw, s, False, ttk._PLAIN))
    finally:
        torch.backends.cudnn.deterministic = old
    torch.testing.assert_close(sums[0], plain[0], rtol=1e-5, atol=0)
    routed_apart = sum(int((a != b).sum()) for a, b in zip(s["bits"], p["bits"]))
    relu_apart = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(s["act"][4:], p["act"][4:]))
    own = 0.0
    for k in sums[2]:
        scale = max(float(plain[2][k].abs().max()), 1.0)
        err_fed = float((sums[2][k] - fed[k]).abs().max())
        assert err_fed <= 1e-4 * scale, (k, err_fed, scale)
        own = max(own, float((sums[2][k] - plain[2][k]).abs().max()) / scale)
    assert own <= 1e-4 or routed_apart + relu_apart > 0, own
    loss, grads = ttk3.kernel_value_and_grad3(model, x, y, mask, torch.float32)
    ref, ref_g, bits, relu = _autograd(model, x, y, mask)
    again = _autograd(model, x, y, mask)[1]
    assert all(torch.equal(ref_g[n], again[n]) for n in ref_g)
    fast = [_autograd(model, x, y, mask, deterministic=False)[1] for _ in range(2)]
    fast_equal = all(torch.equal(fast[0][n], fast[1][n]) for n in ref_g)
    auto_routed = sum(int((a != b).sum()) for a, b in zip(s["bits"], bits))
    auto_relu = sum(int((a != (s["act"][6 - k] > 0)).sum()) for k, a in enumerate(relu))
    scale = max(float(g.abs().max()) for g in ref_g.values())
    err = max(float((grads[n] - ref_g[n]).abs().max()) for n in ref_g) / scale
    print(f"{cfg}: {routed_apart} pool windows and {relu_apart} relu gates differ between "
          f"the kernels' and the twins' forwards, {auto_routed} and {auto_relu} between the "
          f"kernels' and autograd's; the twins' own chain off by {own:.3g} of scale, "
          f"autograd's by {err:.3g}; two autograd runs with cuDNN's default algorithms "
          f"bit-equal: {fast_equal}")
    assert abs(float(loss) - ref) <= 1e-5 * abs(ref), (float(loss), ref)
    if auto_routed + auto_relu == 0:
        assert err <= 1e-4, err


def test_stft_tf_kernel_matches_twin_and_ft(traces):
    """K1 in the (T, F) layout: its twin to 2e-3, and the (F, T) kernel's
    output transposed bit for bit, min and max included."""
    before = tsf.STFT_TF_KERNEL.launches
    out, mn, mx = tsf.stft_tf_log(traces, SP)
    assert tsf.STFT_TF_KERNEL.launches == before + 1
    ref, rmn, rmx = tsf.stft_tf_log_plain(traces, SP)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)
    ft, fmn, fmx = tsf.stft_ft_log(traces, SP)
    assert torch.equal(out, ft.transpose(1, 2))
    assert torch.equal(mn, fmn) and torch.equal(mx, fmx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["tf", "ft"])
@pytest.mark.parametrize("cfg", GEOMETRIES, ids=["k3", "k1", "k5", "k7", "manual", "64x64k7"])
def test_tile_in_norm_matches_twin_and_tile_in(traces, cfg, layout, dtype):
    """``ae_tile_in_norm`` within one ulp of its twin, and bit for bit
    ``ae_tile_in`` on the normalized spectrograms (IEEE division on both
    sides)."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=traces.device)
    wts = tak.build_kernel_weights(model, dtype)
    raw, mn, mx = (tsf.stft_tf_log if layout == "tf" else tsf.stft_ft_log)(traces, SP)
    before = tak.TILE_IN_NORM.launches
    got = tak.ae_tile_in_norm(wts, raw, mn, mx, 3, layout)
    assert tak.TILE_IN_NORM.launches == before + 1
    want = tak.ae_tile_in_norm_plain(wts, raw, mn, mx, 3, layout)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    excess = float(((got.float() - want.float()).abs() - ulp * want.float().abs() - 1e-5).max())
    assert excess <= 0, excess
    assert torch.equal(got, tak.ae_tile_in(wts, tsf.spectrogram_fused(traces, SP), 3))


@pytest.mark.parametrize("mode", ["fused", "fused_ft", "xla"])
def test_service_modes_match_auto(traces, mode):
    """The bf16 service per ``stft_mode``: "fused" and "fused_ft" bit for bit
    "auto" (specs and enhanced), "xla" within the bf16 AE bound of it; each
    through its own kernels."""
    model = make_model(ModelConfig(), generator=torch.Generator().manual_seed(1),
                       device=traces.device).eval()
    auto = harness.make_enhance_shot_fn(ModelConfig(), SP, device=traces.device)
    wts = auto.prepare(model)
    want = auto(wts, traces)
    fn = harness.make_enhance_shot_fn(ModelConfig(), SP, device=traces.device, stft_mode=mode)
    counted = (tsf.STFT_KERNEL, tsf.STFT_TF_KERNEL, tak.TILE_IN, tak.TILE_IN_NORM)
    before = [k.launches for k in counted]
    got = fn(wts, traces)
    ran = {k.symbol for k, b in zip(counted, before) if k.launches > b}
    assert ran == {"fused": {"stft_logpsd_tf", "ae_tile_in_norm"},
                   "fused_ft": {"stft_logpsd", "ae_tile_in"},
                   "xla": {"ae_tile_in"}}[mode]
    if mode == "xla":
        assert float((got[1] - want[1]).abs().max()) < 2e-2
    else:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", sorted(probe_walls.PROBES))
def test_probe_matches_twin(cuda, name):
    kern = {"sublane_offset1_slice": probe_walls.ROW_SLICE,
            "in_kernel_transpose": probe_walls.TRANSPOSE,
            "stride2_lane_slice": probe_walls.STRIDE2}[name]
    before = kern.launches
    assert probe_walls.run_probe(name, cuda)
    assert kern.launches == before + 1


@pytest.mark.parametrize("name", sorted(probe_walls.PROBES))
def test_redesigned_probe_one_launch_bit_for_bit(cuda, name):
    """The row slice, the transpose and the stride-2 slice (256 blocks
    each): one launch a call, equal to the twin bit for bit, on two
    seeds."""
    fn, plain, shape = probe_walls.PROBES[name]
    kern = {"sublane_offset1_slice": probe_walls.ROW_SLICE,
            "in_kernel_transpose": probe_walls.TRANSPOSE,
            "stride2_lane_slice": probe_walls.STRIDE2}[name]
    for seed in (1, 2):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(cuda)
        before = kern.launches
        got = fn(x)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert torch.equal(got, plain(x))


@pytest.mark.parametrize("name", sorted(probe_walls.PROBES))
def test_probe_entry_refuses_what_it_does_not_take(cuda, name):
    """A size off the kernel's blocks, or a pointer off 16 bytes, sent to
    the C entry: ``cudaErrorInvalidValue``, raised by the wrapper as
    RuntimeError, and no launch counted."""
    x = torch.zeros(264, 512, device=cuda)
    out = torch.empty(264, 512, device=cuda)
    if name == "sublane_offset1_slice":
        kern, calls = probe_walls.ROW_SLICE, [(x.data_ptr(), out.data_ptr(), 96),
                                              (x.data_ptr() + 4, out.data_ptr(), 256)]
    elif name == "in_kernel_transpose":
        kern, calls = probe_walls.TRANSPOSE, [(x.data_ptr(), out.data_ptr(), 100),
                                              (x.data_ptr() + 4, out.data_ptr(), 256)]
    else:
        kern, calls = probe_walls.STRIDE2, [(x.data_ptr(), out.data_ptr(), 256, 100),
                                            (x.data_ptr(), out.data_ptr(), 254, 256),
                                            (x.data_ptr(), out.data_ptr() + 8, 256, 256)]
    before = kern.launches
    for args in calls:
        with pytest.raises(RuntimeError):
            kern(*args)
    torch.cuda.synchronize()
    assert kern.launches == before


# every layer kind of the weight gradient, Cin / Cout in {1, 16, 32, 48, 64},
# K in {3, 5, 7}
WGRAD_GEOMETRIES = [
    ModelConfig(),
    MODEL_PRESETS["deep3"],
    ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    ModelConfig(filters=(48, 48, 64), kernels=((3, 3),) * 3, out_kernel=(3, 3)),
    ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3, out_kernel=(7, 7)),
    ModelConfig(filters=(16, 32, 64), kernels=((7, 7),) * 3, out_kernel=(7, 7)),
]
WGRAD_IDS = ["k3", "deep3", "64-32k5", "48-48-64k3", "64-32-64k7", "16-32-64k7"]


def _wgrad_inputs(cuda, tw, b, seed=0):
    """Layer -> (its input, dz, routing bits) of random values in the
    shapes and dtypes of a step (conv 0's input: float32 tiles)."""
    g = torch.Generator().manual_seed(seed)
    w, out = tw.fwd, {}
    for i in range(w.out + 1):
        shape = ttk._act_shape(tw, i, b)
        h, wd = shape[2:]
        inp = (torch.rand(b, 256, 128, generator=g) if i == 0
               else torch.randn(shape, generator=g).clamp_min(0)).to(cuda)
        inp = inp if i == 0 else inp.to(tw.dtype)
        bits = None
        if w.is_convt(i):
            dz = torch.randn(b, w.cout(i), 2 * h, 2 * wd, generator=g)
        elif i == w.out:
            dz = torch.randn(b, 1, h, wd, generator=g)
        else:
            dz = torch.randn(b, w.cout(i), h // 2, wd // 2, generator=g)
            bits = torch.randint(0, 16, dz.shape, generator=g, dtype=torch.uint8).to(cuda)
        out[i] = (inp, dz.to(cuda, tw.dtype), bits)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", WGRAD_GEOMETRIES, ids=WGRAD_IDS)
def test_wgrad_kernel_matches_twin(cuda, cfg, dtype):
    """The weight-gradient kernel, every layer of the geometry (conv 0, the
    encoder convs with routed dz, the transposed convs, the out-conv),
    against its twin on the same inputs: 1e-4 of the scale (f32 sums in
    another order); two runs bit-identical; conv 0 from tiles in the
    kernel dtype (K5b) bit-identical to float32 tiles (K5)."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    tw = ttk.build_train_weights(model, dtype)
    for i, (inp, dz, bits) in _wgrad_inputs(cuda, tw, 3).items():
        got = ttk.ae_train_wgrad(tw, i, inp, dz, bits)
        want = ttk.ae_train_wgrad_plain(tw, i, inp, dz, bits)
        scale = max(float(want.abs().max()), 1e-6)
        assert float((got - want).abs().max()) <= 1e-4 * scale, i
        assert torch.equal(got, ttk.ae_train_wgrad(tw, i, inp, dz, bits)), i
        if i == 0:
            assert torch.equal(got, ttk.ae_train_wgrad(tw, 0, inp.to(dtype), dz, bits, pre=True))


@pytest.mark.parametrize("cfg", [ModelConfig(), MODEL_PRESETS["deep3"]], ids=["k3", "deep3"])
def test_train_step_repeats_bit_for_bit(cuda, cfg):
    """Two runs of one step's kernels give identical loss and gradient
    sums: every cross-block sum is a fixed-order sum of partials."""
    model, x, y, mask = _train_setup(cuda, cfg)
    a = ttk.kernel_loss_grad_sums(model, x, y, mask, torch.bfloat16)
    b = ttk.kernel_loss_grad_sums(model, x, y, mask, torch.bfloat16)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


@pytest.mark.parametrize("cut", [0.1, 0.2], ids=["194-frames", "389-frames"])
def test_stft_kernel_ragged_block(cuda, cut):
    """K1 on shots whose frame count is not a multiple of the block's 16
    frames: its twin to 2e-3 in both layouts, the (T, F) output the (F, T)
    output transposed bit for bit."""
    sp = SpecParams(cut_shot=cut)
    assert sp.n_frames % 16 != 0
    x = torch.from_numpy(harness.example_shot(sp, 2, seed=5)).to(cuda)
    ft, mn, mx = tsf.stft_ft_log(x, sp)
    ref, rmn, rmx = tsf.stft_ft_log_plain(x, sp)
    torch.testing.assert_close(ft, ref, rtol=0, atol=2e-3)
    torch.testing.assert_close(mn, rmn, rtol=0, atol=2e-3)
    torch.testing.assert_close(mx, rmx, rtol=0, atol=2e-3)
    tf, tmn, tmx = tsf.stft_tf_log(x, sp)
    assert torch.equal(tf, ft.transpose(1, 2)) and torch.equal(tmn, mn) and torch.equal(tmx, mx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cfg", WGRAD_GEOMETRIES, ids=WGRAD_IDS)
def test_dgrad_convt_kernel_matches_twin(cuda, cfg, dtype):
    """The transposed convs' input-gradient kernel, every transposed-conv
    layer of the geometry (the first gated by random pool routing bits,
    the others by their relu'd input), against its twin on the same inputs:
    the output within one ulp of the dtype (bf16 2^-7, f32 1e-5 of the
    scale, as chip_smoke.py's stage checks), the bias sums to 1e-4 of their
    scale; two runs bit-identical."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    tw = ttk.build_train_weights(model, dtype)
    w, g = tw.fwd, torch.Generator().manual_seed(4)
    before = ttk.DGRAD_CONVT.launches
    for i, (inp, dz, _) in _wgrad_inputs(cuda, tw, 3).items():
        if not w.is_convt(i):
            continue
        gate = (torch.randint(0, 16, inp.shape, generator=g, dtype=torch.uint8).to(cuda)
                if i == w.depth else inp)
        out, db = ttk.ae_train_dgrad_convt(tw, i, dz, gate)
        rout, rdb = ttk.ae_train_dgrad_convt_plain(tw, i, dz, gate)
        d, ref = (out.float() - rout.float()).abs(), rout.float().abs()
        if dtype == torch.bfloat16:
            assert float((d - 2.0 ** -7 * ref - 1e-5).max()) <= 0, i
        else:
            assert float(d.max()) <= 1e-5 * max(float(ref.max()), 1e-6), i
        assert float((db - rdb).abs().max()) <= 1e-4 * max(float(rdb.abs().max()), 1e-6), i
        again = ttk.ae_train_dgrad_convt(tw, i, dz, gate)
        assert torch.equal(out, again[0]) and torch.equal(db, again[1]), i
    assert ttk.DGRAD_CONVT.launches == before + 2 * w.depth


def test_module_route_service_passes_the_gate(traces):
    """A geometry no kernel family covers, (16, 32, 128)/k5, served with
    ``use_kernel="auto"`` in bf16: the module route, no serving kernel
    launched, enhanced SSIM >= 0.999 per channel against the plain float32
    service (TF32 off)."""
    cfg = ModelConfig(filters=(16, 32, 128), kernels=((5, 5),) * 3, out_kernel=(5, 5))
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=traces.device).eval()
    fn = harness.make_enhance_shot_fn(cfg, SP, device=traces.device)
    counted = (tsf.STFT_KERNEL, tak.TILE_IN, tak.CONV_POOL, tak.CONVT, tak.TILE_OUT)
    before = [k.launches for k in counted]
    specs, enhanced = fn(model, traces)
    assert [k.launches for k in counted] == before
    want_specs, want = harness.enhance_shot_plain(model, traces, SP)
    assert torch.equal(specs, want_specs)
    e, w = enhanced.cpu().numpy(), want.cpu().numpy()
    for c in range(traces.shape[0]):
        assert ssim(e[c], w[c]) >= 0.999, c


# the encoder convs the tensor-core kernel runs: Cout 16 to 64, K 3 to 7,
# grids 128 x 64 and 64 x 32
IGEMM_GEOMETRIES = [
    ModelConfig(),
    MODEL_PRESETS["deep3"],
    ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
    ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    ModelConfig(filters=(48, 48, 64), kernels=((3, 3),) * 3, out_kernel=(3, 3)),
]
IGEMM_IDS = ["k3", "deep3", "k7", "64-32k5", "48-48-64k3"]


def _templates():
    """The per-template conv launch counts of each library with conv templates."""
    return {lib: _build.conv_template_launches(lib) for lib in ("ae", "ae_train")}


def _took(before):
    """Each library's launches per conv template since ``before``."""
    after = _templates()
    return {lib: {t: after[lib][t] - before[lib][t] for t in after[lib]} for lib in after}


@pytest.mark.parametrize("cfg", IGEMM_GEOMETRIES, ids=IGEMM_IDS)
def test_conv_igemm_kernel_matches_twins(cuda, cfg):
    """The tensor-core conv (``conv_igemm_kernel``) with each epilogue, for
    every encoder conv after conv 0, bf16, on 3 tiles of random inputs,
    against the twin of its entry point: ``ae_conv_pool`` and
    ``ae_train_conv_pool`` within one bf16 ulp (routing bits equal but on
    ties, <= 1e-4), the two bit for bit each other; the routed input
    gradient within one ulp, its bias sums to 1e-4 of their scale; two runs
    bit for bit; every launch on the tensor-core template."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    tw = ttk.build_train_weights(model, torch.bfloat16)
    g = torch.Generator().manual_seed(5)

    def ulp(name, a, b):
        excess = float(((a.float() - b.float()).abs() - 2.0 ** -7 * b.float().abs() - 1e-5).max())
        assert excess <= 0, f"{name}: beyond one ulp by {excess:.3g}"

    for i in range(1, tw.fwd.depth):
        shape = ttk._act_shape(tw, i, 3)
        pooled = (3, tw.fwd.cout(i), shape[2] // 2, shape[3] // 2)
        x = torch.randn(shape, generator=g).clamp_min(0).to(cuda, torch.bfloat16)
        dz = torch.randn(pooled, generator=g).to(cuda, torch.bfloat16)
        dz_bits = torch.randint(0, 16, pooled, generator=g, dtype=torch.uint8).to(cuda)
        gate = torch.randint(0, 16, shape, generator=g, dtype=torch.uint8).to(cuda)
        before = _templates()
        got = tak.ae_conv_pool(tw.fwd, x, i)
        ulp(f"ae_conv_pool {i}", got, tak.ae_conv_pool_plain(tw.fwd, x, i))
        p, bits = ttk.ae_train_conv_pool(tw, x, i)
        want, wbits = ttk.ae_train_conv_pool_plain(tw, x, i)
        ulp(f"ae_train_conv_pool {i}", p, want)
        assert float((bits != wbits).float().mean()) <= 1e-4, i
        assert torch.equal(p, got), i
        out, db = ttk.ae_train_dgrad_conv(tw, i, dz, gate, dz_bits)
        rout, rdb = ttk.ae_train_dgrad_conv_plain(tw, i, dz, gate, dz_bits)
        ulp(f"ae_train_dgrad_conv {i}", out, rout)
        assert float((db - rdb).abs().max()) <= 1e-4 * max(float(rdb.abs().max()), 1e-6), i
        again = ttk.ae_train_dgrad_conv(tw, i, dz, gate, dz_bits)
        assert torch.equal(out, again[0]) and torch.equal(db, again[1]), i
        assert torch.equal(got, tak.ae_conv_pool(tw.fwd, x, i)), i
        after = _templates()
        assert after["ae"]["conv_igemm_kernel"] - before["ae"]["conv_igemm_kernel"] == 2
        assert after["ae_train"]["conv_igemm_kernel"] - before["ae_train"]["conv_igemm_kernel"] == 3
        assert all(after[lib][t] == before[lib][t] for lib in after
                   for t in ("conv_quad_kernel", "conv_out_mma_kernel", "conv_in_mma_kernel"))


@pytest.mark.parametrize("cfg", IGEMM_GEOMETRIES, ids=IGEMM_IDS)
def test_train_in_and_loss_kernels_match_twins(cuda, cfg):
    """Conv 0 (``ae_train_in``, ``_pre``) and the loss (``ae_train_loss``,
    ``_pre``) on 3 tiles (the last masked out) of random inputs: in bf16 on
    the tensor-core templates (``conv_in_mma_kernel``, ``conv_out_mma_kernel``),
    in float32 on ``conv_quad_kernel``, each launch counted on its
    template; p1 and dz5 within one ulp of the dtype of their twins, the
    routing bits equal the float64 bits but in the near ties
    ``route_bits64`` counts (and the twin's but on <= 1e-4 of them), the
    logits within 1e-5 of their scale (float32 sums in another order), the
    BCE sum within 1e-5 of the float64 twin's and db5 within 1e-4 of
    max(|db5|, 1) (a signed sum); the ``_pre`` entry points bit for bit
    theirs, two launches bit for bit."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(4), device=cuda)
    g = torch.Generator().manual_seed(11)
    x = torch.rand(3, 256, 128, generator=g).to(cuda)
    y = torch.rand(3, 256, 128, generator=g).to(cuda)
    mask = torch.tensor([1.0, 1.0, 0.0], device=cuda)
    for dt in (torch.bfloat16, torch.float32):
        tw = ttk.build_train_weights(model, dt)
        o, c1 = tw.fwd.out, tw.fwd.w[tw.fwd.out].shape[0]
        e = torch.rand(3, c1, 256, 128, generator=g).to(cuda, dt)
        ulp = 2.0 ** -7 if dt == torch.bfloat16 else 1e-6
        before = _templates()
        p, bits = ttk.ae_train_in(tw, x)
        q, qbits = ttk.ae_train_in(tw, x.to(dt), pre=True)
        loss = ttk.ae_train_loss(tw, e, y, mask)
        loss_pre = ttk.ae_train_loss(tw, e, y.to(dt), mask, pre=True)
        took = _took(before)
        bf = dt == torch.bfloat16
        want = {t: 0 for t in took["ae_train"]}
        want.update({"conv_in_mma_kernel": 2, "conv_out_mma_kernel": 2} if bf
                    else {"conv_quad_kernel": 4})
        assert took["ae_train"] == want and not any(took["ae"].values()), (dt, took)
        assert torch.equal(p, q) and torch.equal(bits, qbits), dt
        assert all(torch.equal(a, b) for a, b in zip(loss, loss_pre)), dt
        rp, rbits = ttk.ae_train_in_plain(tw, x)
        excess = float(((p.float() - rp.float()).abs() - ulp * rp.float().abs() - 1e-5).max())
        assert excess <= 0, f"{dt} ae_train_in: beyond one ulp by {excess:.3g}"
        bits64, near = ttk.route_bits64(x.to(dt).float(), tw.fwd.w[0].float(), tw.fwd.b[0])
        assert not bool(((bits != bits64) & ~near).any()), (dt, int(near.sum()))
        assert float((bits != rbits).float().mean()) <= 1e-4, dt
        logits, dz, bce, db = loss
        rl, rdz, rbce, rdb = ttk.ae_train_loss_plain(tw, e, y, mask)
        assert float((logits - rl).abs().max()) <= 1e-5 * float(rl.abs().max()), dt
        excess = float(((dz.float() - rdz.float()).abs() - ulp * rdz.float().abs() - 1e-5).max())
        assert excess <= 0, f"{dt} dz5: beyond one ulp by {excess:.3g}"
        assert not bool(dz[2].float().any()), dt
        assert float((bce - rbce).abs()) <= 1e-5 * float(rbce.abs()), dt
        assert float((db - rdb).abs()) <= 1e-4 * max(float(rdb.abs()), 1.0), dt
        again = ttk.ae_train_in(tw, x), ttk.ae_train_loss(tw, e, y, mask)
        assert torch.equal(again[0][0], p) and torch.equal(again[0][1], bits), dt
        assert all(torch.equal(a, b) for a, b in zip(again[1], loss)), dt


@pytest.mark.parametrize("shape", [(8192, 2), (4096, 64), (4096, 288), (512, 9216),
                                   (300, 2400), (1, 5)])
def test_train_sum_matches_sum64(cuda, shape):
    """The fixed-order sum of partial rows (one pass, or two over row slabs
    where the columns are few) against the twin's float64 sum, within
    float32 rounding (1e-6 of each column's sum of magnitudes); two runs bit
    for bit."""
    part = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape))).to(cuda)
    got = ttk.ae_train_sum(part)
    want = ttk._sum64(part.cpu(), 0)
    assert bool(((got.cpu() - want).abs() <= 1e-6 * part.abs().sum(0).cpu()).all())
    assert torch.equal(got, ttk.ae_train_sum(part))
    # in one plan beside another array, in either order: the same bits
    other = torch.rand(4096, 32, device=cuda)
    sums = ttk.StepSums(2 * (shape[1] + 32), cuda)
    views = [sums.add(part), sums.add(other), sums.add(other), sums.add(part)]
    sums.run()
    assert torch.equal(views[0], got) and torch.equal(views[3], got)
    assert torch.equal(views[1], ttk.ae_train_sum(other)) and torch.equal(views[2], views[1])


@pytest.mark.parametrize("cfg", [ModelConfig(), MODEL_PRESETS["deep3"]], ids=["k3", "deep3"])
def test_step_sums_match_per_call_sums(cuda, cfg):
    """A step's sums as one plan: its partial arrays (``step_partials``) in
    one ``ae_train_sum`` call, each bit for bit the per-call sum; and a
    whole bf16 step (``loss_grad_sums``, one plan) bit for bit the stages
    with their per-call sums (K5 and K7)."""
    model, x, y, mask = _train_setup(cuda, cfg)
    tw = ttk.build_train_weights(model, torch.bfloat16)
    g = torch.Generator().manual_seed(6)
    parts = [torch.randn(n, m, generator=g).to(cuda) for n, m in ttk.step_partials(tw, 3)]
    sums = ttk.step_sums(tw, cuda)
    views = [sums.add(p) for p in parts]
    before = ttk.TRAIN_SUM.launches
    sums.run()
    assert ttk.TRAIN_SUM.launches == before + 1
    assert all(torch.equal(v, ttk.ae_train_sum(p)) for v, p in zip(views, parts))
    bce, _, grads = ttk.loss_grad_sums(tw, x, y, mask)
    s, _, pbce = ttk._forward(tw, x, y, mask, False)
    per_call = ttk.grads_to_torch(*ttk._backward(tw, s, False))
    assert torch.equal(bce, pbce[0])
    assert all(torch.equal(grads[k], per_call[k]) for k in grads)


CONVT_GEOMETRIES = GEOMETRIES + DEPTH3 + [
    ModelConfig(filters=(48, 48, 64), kernels=((3, 3),) * 3, out_kernel=(3, 3))]
CONVT_IDS = ["k3", "k1", "k5", "k7", "manual", "64x64k7"] + DEPTH3_IDS + ["48-48-64k3"]


@pytest.mark.parametrize("cfg", CONVT_GEOMETRIES, ids=CONVT_IDS)
def test_convt_igemm_kernel_matches_twin(cuda, cfg):
    """The transposed convs (``ae_convt``) of every geometry on 3 tiles of
    random inputs: bf16 on the tensor-core template ``convt_igemm_kernel``
    within one bf16 ulp of the twin, two launches bit for bit; float32 on
    ``convt_relu_kernel`` within 1e-5 of the scale (float32 sums in another
    order); the libraries' per-template counts."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    w16 = tak.build_kernel_weights(model, torch.bfloat16)
    w32 = tak.build_kernel_weights(model, torch.float32)
    g = torch.Generator().manual_seed(8)
    for i in range(w16.depth, w16.out):
        h, w = 256 >> (w16.out - i), 128 >> (w16.out - i)
        x = torch.randn(3, w16.w[i].shape[0], h, w, generator=g).clamp_min(0).to(cuda)
        x16 = x.to(torch.bfloat16)
        before = _templates()
        got = tak.ae_convt(w16, x16, i)
        want = tak.ae_convt_plain(w16, x16, i)
        excess = float(((got.float() - want.float()).abs() - 2.0 ** -7 * want.float().abs()
                        - 1e-5).max())
        assert excess <= 0, f"layer {i}: beyond one ulp by {excess:.3g}"
        assert torch.equal(got, tak.ae_convt(w16, x16, i)), i
        got32 = tak.ae_convt(w32, x, i)
        want32 = tak.ae_convt_plain(w32, x, i)
        assert float((got32 - want32).abs().max()) <= 1e-5 * float(want32.abs().max()), i
        after = _templates()
        took = {t: after["ae"][t] - before["ae"][t] for t in after["ae"]}
        assert took == {"conv_quad_kernel": 0, "conv_igemm_kernel": 0, "convt_relu_kernel": 1,
                        "convt_igemm_kernel": 2, "conv_out_mma_kernel": 0,
                        "conv_in_mma_kernel": 0}, (i, took)
        assert after["ae_train"] == before["ae_train"]


# every out-conv geometry: Cin 16 to 64, k1 to k7, out_kernel apart from the
# encoder's k
OUT_GEOMETRIES = CONVT_GEOMETRIES + [
    ModelConfig(out_kernel=(7, 7)),
    ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3, out_kernel=(1, 1)),
]
OUT_IDS = CONVT_IDS + ["k3-out7", "deep3-out1"]


@pytest.mark.parametrize("cfg", OUT_GEOMETRIES, ids=OUT_IDS)
def test_conv_out_mma_kernel_matches_twin(cuda, cfg):
    """S4 (``ae_tile_out``) of every geometry on 6 tiles of random inputs,
    restitched 3 to a channel: bf16 on the tensor-core template
    ``conv_out_mma_kernel`` within TOL_F32 (1e-4) of the twin, two launches
    bit for bit; float32 on ``conv_quad_kernel`` within 1e-5 (float32 sums
    in another order); S1 (``ae_tile_in``) on ``conv_in_mma_kernel`` in
    bf16 and ``conv_quad_kernel`` in float32; the libraries' per-template
    counts."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    g = torch.Generator().manual_seed(9)
    specs = torch.rand(2, 256, 3 * 128, generator=g).to(cuda)
    for dt, tol, s4, s1 in ((torch.bfloat16, 1e-4, "conv_out_mma_kernel", "conv_in_mma_kernel"),
                            (torch.float32, 1e-5, "conv_quad_kernel", "conv_quad_kernel")):
        wts = tak.build_kernel_weights(model, dt)
        cin = wts.w[wts.out].shape[0]
        x = torch.rand(6, cin, 256, 128, generator=g).to(cuda, dt)
        before = _templates()
        got = tak.ae_tile_out(wts, x, 3)
        after = _templates()
        took = {t: after["ae"][t] - before["ae"][t] for t in after["ae"]}
        assert took == {t: int(t == s4) for t in took}, (dt, took)
        want = tak.ae_tile_out_plain(wts, x, 3)
        assert got.shape == want.shape == (2, 256, 3 * 128)
        assert float((got - want).abs().max()) <= tol, dt
        assert torch.equal(got, tak.ae_tile_out(wts, x, 3)), dt
        before = _templates()
        tak.ae_tile_in(wts, specs, 3)
        after = _templates()
        took = {t: after["ae"][t] - before["ae"][t] for t in after["ae"]}
        assert took == {t: int(t == s1) for t in took}, (dt, took)
        assert after["ae_train"] == before["ae_train"]


@pytest.mark.parametrize("cfg", OUT_GEOMETRIES, ids=OUT_IDS)
def test_conv_in_mma_kernel_matches_twins(cuda, cfg):
    """The one-channel-in convs of every geometry in bf16 on the tensor-core
    template ``conv_in_mma_kernel``: S1 (``ae_tile_in``) on 2 channels of 3
    tiles within one bf16 ulp of its twin, and the out-conv's input
    gradient (``ae_train_dgrad_conv``) on 6 tiles of random dz and e within
    one ulp, its bias sums to 1e-4 of their scale; two launches of each bit
    for bit; in float32 both on ``conv_quad_kernel``; the libraries'
    per-template counts."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    g = torch.Generator().manual_seed(10)
    specs = torch.rand(2, 256, 3 * 128, generator=g).to(cuda)
    for dt, kind in ((torch.bfloat16, "conv_in_mma_kernel"), (torch.float32, "conv_quad_kernel")):
        tw = ttk.build_train_weights(model, dt)
        o, c1 = tw.fwd.out, tw.fwd.w[tw.fwd.out].shape[0]
        dz = torch.randn(6, 1, 256, 128, generator=g).to(cuda, dt)
        e = torch.randn(6, c1, 256, 128, generator=g).to(cuda, dt)
        ulp = 2.0 ** -7 if dt == torch.bfloat16 else 1e-6
        before = _templates()
        got = tak.ae_tile_in(tw.fwd, specs, 3)
        out, db = ttk.ae_train_dgrad_conv(tw, o, dz, e)
        after = _templates()
        for lib in after:
            took = {t: after[lib][t] - before[lib][t] for t in after[lib]}
            assert took == {t: int(t == kind) for t in took}, (dt, lib, took)
        for name, a, b in (("ae_tile_in", got, tak.ae_tile_in_plain(tw.fwd, specs, 3)),
                           ("out-conv dgrad", out, ttk.ae_train_dgrad_conv_plain(tw, o, dz, e)[0])):
            excess = float(((a.float() - b.float()).abs() - ulp * b.float().abs() - 1e-5).max())
            assert excess <= 0, f"{dt} {name}: beyond one ulp by {excess:.3g}"
        rdb = ttk.ae_train_dgrad_conv_plain(tw, o, dz, e)[1]
        assert float((db - rdb).abs().max()) <= 1e-4 * max(float(rdb.abs().max()), 1e-6), dt
        assert torch.equal(got, tak.ae_tile_in(tw.fwd, specs, 3)), dt
        again = ttk.ae_train_dgrad_conv(tw, o, dz, e)
        assert torch.equal(out, again[0]) and torch.equal(db, again[1]), dt


SWEEP_GRID = [ModelConfig(), ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5))]


def _sweep_data(cuda, n=256):
    g = torch.Generator().manual_seed(4)
    x = torch.rand(n, 256, 128, generator=g).to(cuda)
    return x[:192], (0.8 * x[:192] + 0.1).clamp(0, 1), x[192:], (0.8 * x[192:] + 0.1).clamp(0, 1)


def _launches(fn, *args, **kw):
    """fn's result and each kernel's launches during it."""
    before = {k: k.launches for k in _build.KERNELS}
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, {k: k.launches - before[k] for k in _build.KERNELS if k.launches - before[k]}


def test_serial_sweep_trains_on_kernels(cuda):
    """A 2-config serial sweep (k3 and k5 at full width, 192 tiles, 1
    epoch, bf16): every config's steps on the training kernels (2 per
    config), finite val losses."""
    from specenh_torch import TrainConfig
    from specenh_torch.sweep import sweep_fit_serial

    res, took = _launches(sweep_fit_serial, SWEEP_GRID, *_sweep_data(cuda), TrainConfig(),
                          epochs=1, dtype=torch.bfloat16, device=cuda)
    assert took[ttk.TRAIN_LOSS] == took[ttk.TRAIN_IN] == took[ttk.TRAIN_SUM] == 4
    assert ttk.TRAIN_LOSS_PRE not in took
    assert np.isfinite(res.val_losses).all() and res.val_history.shape == (1, 2)


def test_envelope_matches_serial_kernels_f32(cuda):
    """The envelope engine (float32, TF32 off) against the serial engine on
    the float32 kernels, 2 epochs: per config and epoch within 1e-4
    relative (float32 sums in other orders), the same best config; the
    envelope launches no kernel."""
    from specenh_torch import TrainConfig
    from specenh_torch.sweep import sweep_fit, sweep_fit_serial

    data = _sweep_data(cuda)
    env, took = _launches(sweep_fit, SWEEP_GRID, *data, TrainConfig(), epochs=2, device=cuda)
    assert not took
    ser = sweep_fit_serial(SWEEP_GRID, *data, TrainConfig(), epochs=2, dtype=torch.float32,
                           device=cuda)
    np.testing.assert_allclose(env.train_history, ser.train_history, rtol=1e-4)
    np.testing.assert_allclose(env.val_history, ser.val_history, rtol=1e-4)
    assert env.best_index == ser.best_index


@pytest.mark.parametrize("cfg", [ModelConfig(), MODEL_PRESETS["deep3"]], ids=["k3", "deep3"])
def test_production_predict_fn_launches_serving_kernels(cuda, cfg):
    """make_production_predict_fn on 4 tiles: one launch of each serving
    stage (S2 and S3 once per layer), within 2e-2 of the module in float32
    in bf16, within 1e-4 in float32; the module route on an uncovered
    geometry launches none."""
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda)
    tiles = torch.rand(4, 256, 128, generator=torch.Generator().manual_seed(5)).to(cuda)
    with torch.no_grad():
        want = model(tiles)
    d = cfg.depth
    for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        fn = harness.make_production_predict_fn(cfg, dtype=dtype, device=cuda)
        w = fn.prepare(model)
        got, took = _launches(fn, w, tiles)
        assert took == {tak.TILE_IN: 1, tak.CONV_POOL: d - 1, tak.CONVT: d, tak.TILE_OUT: 1}
        assert float((got - want).abs().max()) < atol, dtype
    unc = ModelConfig(filters=(16, 32))
    m16 = make_model(unc, generator=torch.Generator().manual_seed(1), device=cuda)
    out, took = _launches(harness.make_production_predict_fn(unc, device=cuda), m16, tiles)
    assert not took and out.shape == tiles.shape


def _lowrank(shape=(2, 256, 500), rank=6, seed=0):
    """A batch of rank-6 matrices plus noise (tests/test_svd.py's)."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape)
    for b in range(shape[0]):
        for i in range(rank):
            m[b] += np.outer(rng.standard_normal(shape[1]),
                             rng.standard_normal(shape[2])) * (4.0 / (i + 1))
    return torch.from_numpy(m + 0.1 * rng.standard_normal(shape)).float()


def _norm(x):
    x = x.double().cpu().numpy()
    return (x - x.min()) / (x.max() - x.min())


def test_svd_on_the_card_matches_the_cpu(cuda):
    """ops.svd on the card (cuSOLVER) against the same functions on the
    CPU: the default band and the deflation within 1e-4 of max |x|, the
    use_optimal band and compute_signal (band edges in the noise spectrum)
    at SSIM >= 0.995 per matrix, as tests/test_svd.py holds float32 to
    float64."""
    from specenh_torch.ops import svd

    x = _lowrank()
    scale = float(x.abs().max())
    for name, fn in (("denoise", svd.denoise_signal), ("deflate", svd.deflate_top1)):
        got, want = fn(x.to(cuda)).cpu(), fn(x)
        assert float((got - want).abs().max()) / scale < 1e-4, name
    for name, fn in (("optimal", lambda a: svd.denoise_signal(a, use_optimal=True)),
                     ("gram", svd.compute_signal),
                     ("subspace", lambda a: svd.compute_signal(a, method="subspace")),
                     ("svd", lambda a: svd.compute_signal(a, method="svd"))):
        got, want = fn(x.to(cuda)).cpu(), fn(x)
        for b in range(x.shape[0]):
            assert ssim(_norm(got[b]), _norm(want[b])) > 0.995, (name, b)


def test_svd_ignores_the_callers_tf32(cuda):
    """With TF32 turned on by the caller, the SVD functions give the same
    bits as with it off, and the caller's setting is back afterwards."""
    from specenh_torch.ops import svd

    x = _lowrank(seed=3).to(cuda)
    fns = (svd.denoise_signal, lambda a: svd.denoise_signal(a, use_optimal=True),
           svd.compute_signal, svd.deflate_top1)
    want = [fn(x) for fn in fns]
    torch.set_float32_matmul_precision("high")
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        got = [fn(x) for fn in fns]
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_crosspower_on_the_card_matches_the_cpu(cuda):
    """ae_co2 on the card against the CPU: ampsp within 1e-4 of its largest
    value, the same axes."""
    from specenh_torch.ops.crosspower import ae_co2

    t = np.arange(1 << 16) / 1.667e6
    rng = np.random.default_rng(2)
    s1, s2 = (torch.from_numpy((np.sin(2 * np.pi * 8e4 * t + p) + rng.standard_normal(t.size))
                               .astype(np.float32)) for p in (0.0, 0.3))
    got, f, tm = ae_co2(s1.to(cuda), s2.to(cuda), t)
    want, wf, wt = ae_co2(s1, s2, t)
    assert got.is_cuda and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.max()))
    assert (f == wf).all() and (tm == wt).all()


def test_train_from_raw_on_the_kernels(cuda):
    """e2e.train_from_raw with the kernel engine, 3 channels of 0.2 s (9
    tiles, 5 trained): K1 once, every step on K5, finite losses."""
    from specenh_torch import Config, TrainConfig
    from specenh_torch.e2e import train_from_raw
    from specenh_torch.train import kernel_epoch_for

    x = np.random.default_rng(0).standard_normal((3, SP.n_samples)).astype(np.float32)
    tc = TrainConfig(epochs=2, batch_size=2)
    (_, hist), took = _launches(train_from_raw, x, Config(spec=SP), ModelConfig(), tc,
                                device=cuda, epoch_fn=kernel_epoch_for(ModelConfig(), tc))
    assert took[tsf.STFT_KERNEL] == 1
    assert took[ttk.TRAIN_LOSS] == took[ttk.TRAIN_SUM] == 2 * 3
    assert np.isfinite(hist["loss"]).all() and np.isfinite(hist["val_loss"]).all()


# the three ways a caller sets the float32 matmul precision
_PRECISION_SETTINGS = {
    "legacy": lambda: setattr(torch.backends.cuda.matmul, "allow_tf32", True),
    "current": lambda: setattr(torch.backends.cuda.matmul, "fp32_precision", "tf32"),
    "medium": lambda: torch.set_float32_matmul_precision("medium"),
}


def _precision_reads():
    reads = {}
    for name, get in (("allow_tf32", lambda: torch.backends.cuda.matmul.allow_tf32),
                      ("fp32_precision", lambda: torch.backends.cuda.matmul.fp32_precision),
                      ("cpu_fp32_precision", lambda: torch.backends.mkldnn.matmul.fp32_precision),
                      ("float32_matmul_precision", torch.get_float32_matmul_precision)):
        try:
            reads[name] = get()
        except RuntimeError as e:
            reads[name] = type(e).__name__
    return reads


@pytest.mark.parametrize("setting", sorted(_PRECISION_SETTINGS))
def test_svd_keeps_each_precision_api(cuda, setting):
    """After the caller set TF32 on through the legacy flag, the current
    API or ``set_float32_matmul_precision("medium")``, the SVD functions
    and the cross power give the bits they give with it off, and every
    API reads as the caller left it."""
    from specenh_torch.config import SpecParams as SPs
    from specenh_torch.ops import crosspower, svd

    x = _lowrank(seed=4).to(cuda)
    fns = (svd.denoise_signal, svd.compute_signal, svd.deflate_top1,
           lambda a: svd.top_k_svd(a, 6)[1],
           lambda a: crosspower.cross_power(a[0].flatten(), a[1].flatten(),
                                            SPs(nperseg=1024, noverlap=512)))
    want = [fn(x) for fn in fns]
    saved = (torch.backends.cuda.matmul.fp32_precision,
             torch.backends.mkldnn.matmul.fp32_precision)
    _PRECISION_SETTINGS[setting]()
    try:
        before = _precision_reads()
        got = [fn(x) for fn in fns]
        assert _precision_reads() == before
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision = saved
        torch.backends.cuda.matmul.allow_tf32 = False
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_denoise_from_zero_copies_on_the_card(cuda):
    from specenh_torch.ops import svd

    x = _lowrank(seed=5).to(cuda)
    keep = x.clone()
    y = svd.denoise_signal(x, start=0)
    assert y is not x and torch.equal(y, keep)
    y.zero_()
    assert torch.equal(x, keep)


class _Sink:
    """An in-memory store: what ``serve_once``'s writers persist."""

    def __init__(self, path):
        self.path = path
        self.channels = {}

    def write_channel(self, shot, chn, spec, f, t, out, prefix="ece"):
        self.channels[(f"{prefix}_{shot}", chn)] = (spec.copy(), out.copy())

    def flush(self):
        pass

    def close(self):
        pass


def test_serve_once_on_the_card_bit_for_bit(cuda, tmp_path):
    """``serve_once`` with two writer threads over four distinct 20-channel
    shots and a truncated one: 4 done, 1 quarantined; every persisted
    channel bit for bit the service called directly; per shot K1 and each
    serving stage once, the transposed conv twice."""
    from specenh_torch import Config
    from specenh_torch.io.binfmt import write_shot_bin
    from specenh_torch.io.store import CampaignManifest, StoreWriterPool
    from specenh_torch.serve import EnhanceService, serve_once

    cfg = Config(spec=SP)
    shots = {s: harness.example_shot(SP, 20, seed=s) for s in range(4)}
    for s, x in shots.items():  # 176052-176055: two shots on each shard
        write_shot_bin(str(tmp_path / f"shot_{176052 + s}.bin"), x)
    (tmp_path / "shot_176099.bin").write_bytes(b"x" * 64)
    service = EnhanceService(cfg, ModelConfig(), n_channels=20, device=cuda)
    sinks = [_Sink("a"), _Sink("b")]
    manifest = CampaignManifest(str(tmp_path / "m.jsonl"))
    counts, took = _launches(serve_once, service, str(tmp_path),
                             StoreWriterPool.from_stores(sinks), manifest, verbose=False)
    manifest.close()
    assert counts == {"done": 4, "failed": 1}
    assert all(s.channels for s in sinks)
    assert took[tsf.STFT_KERNEL] == took[tak.TILE_IN] == took[tak.CONV_POOL] == 4
    assert took[tak.CONVT] == 8 and took[tak.TILE_OUT] == 4
    persisted = {**sinks[0].channels, **sinks[1].channels}
    for s, x in shots.items():
        specs, enhanced = (t.cpu().numpy() for t in service.fn(service.params, x))
        for c in range(20):
            spec, out = persisted[(f"enhanced_{176052 + s}", c + 1)]
            assert np.array_equal(spec, specs[c]) and np.array_equal(out, enhanced[c])


class _MemStore:
    """Records of (256, k x 128) in host memory, with the read protocol of
    the streamed trainer."""

    path = None

    def __init__(self, n_shots=2, n_channels=2, tiles=4, seed=0):
        rng = np.random.default_rng(seed)
        self.recs = {(f"ece_{s}", c): rng.random((256, tiles * 128)).astype(np.float32)
                     for s in range(n_shots) for c in range(1, n_channels + 1)}

    def shots(self):
        return sorted({s for s, _ in self.recs})

    def channels_of(self, shot):
        return sorted(c for s, c in self.recs if s == shot)

    def iter_channels(self):
        return iter(sorted(self.recs))

    def spec_shape(self, shot, chn):
        return self.recs[shot, chn].shape

    def read_column_slice(self, shot, chn, lo, hi):
        x = self.recs[shot, chn][:, lo:hi]
        return x, np.clip(1.2 * x - 0.2, 0, 1)


@pytest.mark.parametrize("depth", [2, 3])
def test_streamed_fit_on_the_kernels_bit_for_bit(cuda, depth):
    """K5 (depth 2) and K7 (depth 3): with shuffle off and one chunk the
    streamed fit trains as the resident fit, losses and parameters bit for
    bit (val_loss, the float32 module's, to rtol 1e-6); shuffled in chunks
    of 4, bf16 chunks train to the float32 chunks' losses and parameters
    bit for bit, every step on the kernels."""
    from specenh_torch import TrainConfig, train as ttrain, train_stream as tts

    cfg = ModelConfig() if depth == 2 else MODEL_PRESETS["deep3"]
    store = _MemStore()
    runs = {}
    for tag, tc, kw in (("resident", TrainConfig(epochs=2, batch_size=4, shuffle=False), None),
                        ("one chunk", TrainConfig(epochs=2, batch_size=4, shuffle=False), {}),
                        ("f32", TrainConfig(epochs=2, batch_size=4), dict(chunk_tiles=4)),
                        ("bf16", TrainConfig(epochs=2, batch_size=4),
                         dict(chunk_tiles=4, cache_dtype="bf16"))):
        plan = tts.plan_stream_split(store, num_samples=2, cfg=tc, seed=0)
        state = ttrain.create_state(cfg, tc, generator=torch.Generator().manual_seed(0),
                                    device=cuda)
        epoch_fn = ttrain.kernel_epoch_for(cfg, tc)
        if kw is None:
            data = [a for split in ("train", "tune")
                    for a in tts._read_chunk(store, getattr(plan, split), tts.PatchSpec())]
            runs[tag] = ttrain.fit(state, *data, cfg=tc, epoch_fn=epoch_fn)
        else:
            before = ttk.TRAIN_LOSS.launches
            runs[tag] = tts.fit_streaming(state, store, plan, tc, epoch_fn=epoch_fn, **kw)
            assert ttk.TRAIN_LOSS.launches - before == 2 * -(-plan.n_tiles("train") // 4)

    def same(a, b, val=True):
        (sa, ha), (sb, hb) = runs[a], runs[b]
        assert ha["loss"] == hb["loss"]
        if val:  # the float32 module on cuDNN, whose algorithm may differ between runs
            np.testing.assert_allclose(ha["val_loss"], hb["val_loss"], rtol=1e-6)
        for u, v in zip(sa.model.state_dict().values(), sb.model.state_dict().values()):
            assert torch.equal(u, v)

    same("one chunk", "resident")
    same("bf16", "f32", val=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pinned_upload_path(cuda, dtype):
    """``_ChunkStream`` on the card: five host chunks through two pinned
    staging buffers (each refilled after its upload's event) come out on
    the card as float32, equal to the host chunks, in order; the reader
    thread has ended."""
    import threading

    from specenh_torch import train_stream as tts

    stream = tts._ChunkStream(cuda, 8, (256, 128), dtype)
    assert all(s.x.is_pinned() and s.y.is_pinned() for s in stream.slots)
    rng = np.random.default_rng(0)
    host = [tuple(torch.from_numpy(rng.random((k, 256, 128, 1)).astype(np.float32)).to(dtype)
                  for _ in range(2)) for k in (8, 8, 3, 8, 5)]
    got = [(tag, x.clone(), y.clone())
           for tag, x, y in stream.run((i, c) for i, c in enumerate(host))]
    assert [t for t, _, _ in got] == list(range(5))
    for (_, x, y), (hx, hy) in zip(got, host):
        assert x.is_cuda and x.dtype == torch.float32
        assert torch.equal(x.cpu(), hx[..., 0].float()) and torch.equal(y.cpu(), hy[..., 0].float())
    assert not [t for t in threading.enumerate() if t.name == "stream-reader"]


def _dp_tiles(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 256, 128)).astype(np.float32)
    return x, np.clip(0.8 * x + 0.1, 0, 1).astype(np.float32)


@pytest.mark.parametrize("depth", [2, 3])
def test_dp_world_of_one_over_nccl_bit_for_bit(cuda, depth):
    """``dp_fit`` with ``dp_kernel_epoch_for`` on an NCCL world of one is
    ``fit`` with ``kernel_epoch_for`` bit for bit (K5 at depth 2, K7 at
    depth 3), its steps on the kernels."""
    from specenh_torch import TrainConfig, train as ttrain
    from specenh_torch.parallel.data_parallel import dp_fit
    from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
    from specenh_torch.parallel.mesh import make_mesh

    cfg = ModelConfig() if depth == 2 else MODEL_PRESETS["deep3"]
    tc = TrainConfig(batch_size=8)
    x, y = _dp_tiles(20)

    def state():
        return ttrain.create_state(cfg, tc, generator=torch.Generator().manual_seed(0),
                                   device=cuda)

    s1, h1 = ttrain.fit(state(), x, y, cfg=tc, epochs=2, epoch_fn=ttrain.kernel_epoch_for(cfg, tc))
    mesh = make_mesh(1, device=cuda)
    try:
        assert mesh.backend == "nccl"
        before = ttk.TRAIN_LOSS.launches
        s2, h2 = dp_fit(state(), x, y, mesh, epochs=2, batch_size=8, seed=tc.seed,
                        epoch_fn=dp_kernel_epoch_for(cfg, tc, mesh))
        assert ttk.TRAIN_LOSS.launches - before == 2 * 3
    finally:
        mesh.close()
    assert h1["loss"] == h2["loss"]
    for u, v in zip(s1.model.state_dict().values(), s2.model.state_dict().values()):
        assert torch.equal(u, v)


def _gloo_rank(rank, port, x, y, out):
    """One of two gloo ranks on the one card: 2 epochs of ``dp_fit`` on K5
    from the seed's weights; puts (rank, losses, parameters) on ``out``."""
    import traceback

    try:
        from specenh_torch import TrainConfig, train as ttrain
        from specenh_torch.parallel.data_parallel import dp_fit
        from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
        from specenh_torch.parallel.mesh import make_mesh
        from specenh_torch.parallel.multihost import initialize_distributed

        initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout=60)
        mesh = make_mesh(2, device="cuda:0")
        cfg, tc = ModelConfig(), TrainConfig(batch_size=8)
        st = ttrain.create_state(cfg, tc, generator=torch.Generator().manual_seed(0),
                                 device=mesh.device)
        st, h = dp_fit(st, x, y, mesh, epochs=2, batch_size=8, seed=tc.seed,
                       epoch_fn=dp_kernel_epoch_for(cfg, tc, mesh))
        flat = torch.cat([p.detach().reshape(-1) for p in st.model.parameters()]).cpu().numpy()
        out.put((rank, h["loss"], flat))
        torch.distributed.destroy_process_group()
    except Exception:
        out.put((rank, "error", traceback.format_exc()))


def test_dp_two_gloo_ranks_on_one_card(cuda):
    """Two ranks on the one card over gloo (NCCL refuses a duplicate GPU):
    20 tiles in batches of 8, so rank 1's block of each epoch's last batch
    is all padding; both ranks end with the same parameters, the losses
    finite and within 1e-4 relative of the one-rank ``fit``."""
    import socket

    import torch.multiprocessing as mp

    from specenh_torch import TrainConfig, train as ttrain

    x, y = _dp_tiles(20)
    tc = TrainConfig(batch_size=8)
    _, ref = ttrain.fit(ttrain.create_state(ModelConfig(), tc,
                                            generator=torch.Generator().manual_seed(0),
                                            device=cuda), x, y, cfg=tc, epochs=2,
                        epoch_fn=ttrain.kernel_epoch_for(ModelConfig(), tc))
    torch.cuda.empty_cache()  # room for the children's contexts
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, x, y, q)) for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        got = sorted((q.get(timeout=120) for _ in procs), key=lambda r: r[0])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(r[1] != "error" for r in got), [r[-1] for r in got]
    (_, l0, p0), (_, l1, p1) = got
    assert l0 == l1 and np.array_equal(p0, p1)
    assert np.isfinite(l0).all() and np.isfinite(p0).all()
    np.testing.assert_allclose(l0, ref["loss"], rtol=1e-4)
