"""The service's other STFT fronts in the port (``stft_mode`` "fused",
"fused_ft", "xla"; plain twins on CPU) against the JAX package: K1's (T, F)
layout, ``normalized_specs``, ``ae_tile_in_norm`` (the route of K9 and K10)
and the services themselves, JAX's Pallas kernels in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh.bench import harness as jharness
from specenh.config import ModelConfig, SpecParams
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import stft_fused as jsf
from specenh.ops.parity_turn import specs_to_x16_2d
from specenh_torch.bench import harness
from specenh_torch.bench.reference import ssim
from specenh_torch.data.tiles import unpatch
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops import stft_fused as tsf

SP = SpecParams(cut_shot=0.2)  # 389 frames -> 3 tiles per channel
K = SP.n_frames // 128
CFG = ModelConfig()


@pytest.fixture(scope="module")
def traces():
    return np.random.default_rng(0).standard_normal((2, SP.n_samples)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_tf(traces):
    """JAX K1 in the (T, F) layout, float32 operands: (C, Tpad, 384), mn, mx."""
    a, mn, mx, _ = jsf.stft_tf_log(jnp.asarray(traces), SP, bf16=False, interpret=True)
    return np.array(a), np.array(mn), np.array(mx)  # writable copies


@pytest.fixture(scope="module")
def raw(traces):
    """The port's raw log-PSD in both layouts and its min/max (CPU twins)."""
    x = torch.from_numpy(traces)
    ft, mn, mx = tsf.stft_ft_log(x, SP)
    tf, tmn, tmx = tsf.stft_tf_log(x, SP)
    assert torch.equal(mn, tmn) and torch.equal(mx, tmx)
    return {"ft": ft, "tf": tf}, mn, mx


@pytest.fixture(scope="module")
def setup():
    params = flax_model(CFG).init(jax.random.PRNGKey(0),
                                  np.zeros((1, *CFG.input_shape), np.float32))
    model = make_model(CFG, generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(state_dict_from_flax(params, CFG))
    shot = harness.example_shot(SP, n_channels=1, seed=3)
    return params, model, shot


def test_stft_tf_log_plain_matches_jax_kernel(traces, jax_tf):
    """The (T, F) twin against JAX's kernel, and equal to the (F, T) twin
    transposed: the twins compute in float64 and cast, so two calls give
    the same bits whatever the float32 blocking of the CPU's BLAS."""
    a, mn, mx = jax_tf
    got, gmn, gmx = tsf.stft_tf_log_plain(torch.from_numpy(traces), SP)
    assert got.shape == (2, SP.n_frames, SP.n_freqs_onesided)
    np.testing.assert_allclose(got.numpy(), a[:, : SP.n_frames, :257], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gmn.numpy(), mn, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gmx.numpy(), mx, rtol=1e-5, atol=1e-4)
    ft, fmn, fmx = tsf.stft_ft_log_plain(torch.from_numpy(traces), SP)
    assert torch.equal(got, ft.transpose(1, 2))
    assert torch.equal(gmn, fmn) and torch.equal(gmx, fmx)


def test_stft_tf_log_on_cpu_runs_the_twin(traces):
    before = tsf.STFT_TF_KERNEL.launches
    x = torch.from_numpy(traces)
    for a, b in zip(tsf.stft_tf_log(x, SP), tsf.stft_tf_log_plain(x, SP)):
        assert torch.equal(a, b)
    assert tsf.STFT_TF_KERNEL.launches == before


def test_normalized_specs_matches_jax(jax_tf):
    a, mn, mx = jax_tf
    want = np.asarray(jsf.normalized_specs(jnp.asarray(a), jnp.asarray(mn), jnp.asarray(mx),
                                           SP.n_frames))
    got = tsf.normalized_specs(torch.from_numpy(a), torch.from_numpy(mn),
                               torch.from_numpy(mx), SP.n_frames)
    assert got.shape == want.shape == (2, 256, SP.n_frames) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_normalized_specs_equals_spectrogram_fused(traces, raw):
    """The "fused" front's specs are "auto"'s, bit for bit."""
    raws, mn, mx = raw
    got = tsf.normalized_specs(raws["tf"], mn, mx, SP.n_frames)
    assert torch.equal(got, tsf.spectrogram_fused(torch.from_numpy(traces), SP))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["tf", "ft"])
def test_tile_in_norm_equals_tile_in_on_the_specs(traces, raw, layout, dtype):
    """The twin of the normalize-on-load S1, in either layout, is exactly
    ``ae_tile_in_plain`` on the normalized spectrograms; on CPU the
    wrapper runs the twin."""
    raws, mn, mx = raw
    wts = tak.build_kernel_weights(make_model(CFG, generator=torch.Generator().manual_seed(1)),
                                   dtype)
    specs = tsf.spectrogram_fused(torch.from_numpy(traces), SP)
    want = tak.ae_tile_in_plain(wts, specs, K)
    got = tak.ae_tile_in_norm_plain(wts, raws[layout], mn, mx, K, layout)
    assert got.dtype == dtype and torch.equal(got, want)
    before = tak.TILE_IN_NORM.launches
    assert torch.equal(tak.ae_tile_in_norm(wts, raws[layout], mn, mx, K, layout), want)
    assert tak.TILE_IN_NORM.launches == before


@pytest.mark.parametrize("layout", ["tf", "ft"], ids=["K9", "K10"])
def test_normalized_tiles_match_jax_turn(jax_tf, layout):
    """The twin's normalized bf16 tiles against JAX's K9 (from the (T, F)
    log-PSD) and K10 (from the (F, T) one), on the same raw arrays: the
    port's tiles, unpatched, through JAX ``specs_to_x16_2d`` (lossless
    for bf16 values) within one bf16 ulp at |x| <= 1."""
    a, mn, mx = jax_tf
    src = a if layout == "tf" else np.ascontiguousarray(a.swapaxes(1, 2))
    tiles = tak.normalized_tiles(torch.from_numpy(src), torch.from_numpy(mn),
                                 torch.from_numpy(mx), K, layout)
    specs16 = unpatch(tiles.to(torch.bfloat16).float(), tiles_per_spec=K)
    got = specs_to_x16_2d(jnp.asarray(specs16.numpy()), K, interpret=True)
    turn = jsf.specs_tf_to_x16_2d if layout == "tf" else jsf.specs_ft_to_x16_2d
    want = turn(jnp.asarray(src), jnp.asarray(mn), jnp.asarray(mx), K, interpret=True)
    diff = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want.astype(jnp.float32))))
    assert diff <= 2 ** -7, diff


@pytest.fixture(scope="module")
def jax_modes(setup):
    params, _, shot = setup
    out = {}
    for mode in ("fused", "fused_ft", "xla"):
        fn = jharness.make_enhance_shot_fn(CFG, SP, use_kernel=True, interpret=True,
                                           stft_mode=mode)
        s, e = fn(params, jnp.asarray(shot))
        out[mode] = np.asarray(s), np.asarray(e)
    return out


@pytest.mark.parametrize("mode", ["fused", "fused_ft", "xla"])
def test_service_mode_matches_jax_service(setup, jax_modes, mode):
    """The bf16 service in each front against the JAX package's in the same
    mode: the bulk and the tail bounds of the JAX package's own front
    comparison (its STFT fronts run bf16 operands, the port's float32)."""
    _, model, shot = setup
    specs, enhanced = harness.make_enhance_shot_fn(CFG, SP, device="cpu",
                                                   stft_mode=mode)(model, shot)
    js, je = jax_modes[mode]
    assert specs.shape == js.shape and enhanced.shape == je.shape
    ds, de = np.abs(specs.numpy() - js), np.abs(enhanced.numpy() - je)
    assert ds.mean() < 1e-3 and ds.max() < 0.15, (ds.mean(), ds.max())
    assert (ds > 5e-3).mean() < 0.01
    assert de.mean() < 1e-3 and de.max() < 0.05, (de.mean(), de.max())


@pytest.mark.parametrize("mode", ["auto", "fused", "fused_ft", "xla"])
def test_bf16_mode_passes_the_enhanced_gate(setup, mode):
    """Each bf16 front against the float32 service: SSIM >= 0.999 per
    channel (headline.py:63-73)."""
    _, model, shot = setup
    _, e32 = harness.make_enhance_shot_fn(CFG, SP, dtype=None, device="cpu")(model, shot)
    _, e16 = harness.make_enhance_shot_fn(CFG, SP, device="cpu", stft_mode=mode)(model, shot)
    for c in range(e16.shape[0]):
        assert ssim(e16[c].numpy(), e32[c].numpy()) >= 0.999


@pytest.mark.parametrize("mode", ["fused", "fused_ft"])
def test_fused_modes_equal_auto(setup, mode):
    """On the twins, "fused" and "fused_ft" give "auto"'s bits."""
    _, model, shot = setup
    fn = harness.make_enhance_shot_fn(CFG, SP, device="cpu", stft_mode=mode)
    wts = fn.prepare(model)
    auto = harness.make_enhance_shot_fn(CFG, SP, device="cpu")(wts, shot)
    for a, b in zip(fn(wts, shot), auto):
        assert torch.equal(a, b)


SP_HOP128 = SpecParams(cut_shot=0.2, noverlap=384)  # hop 128: no K1 geometry


def test_auto_falls_back_to_the_matmul_front(setup):
    """For a geometry K1 does not take, "auto" is the "xla" service, bit for
    bit, and matches the JAX service's "auto" (which falls back to its XLA
    front) at the bounds of ``test_service_mode_matches_jax_service``."""
    params, model, _ = setup
    assert not tsf.supported(SP_HOP128)
    shot = harness.example_shot(SP_HOP128, n_channels=1, seed=3)
    auto = harness.make_enhance_shot_fn(CFG, SP_HOP128, device="cpu")(model, shot)
    xla = harness.make_enhance_shot_fn(CFG, SP_HOP128, device="cpu",
                                       stft_mode="xla")(model, shot)
    for a, b in zip(auto, xla):
        assert torch.equal(a, b)
    fn = jharness.make_enhance_shot_fn(CFG, SP_HOP128, use_kernel=True, interpret=True,
                                       stft_mode="auto")
    js, je = (np.asarray(a) for a in fn(params, jnp.asarray(shot)))
    specs, enhanced = auto
    assert specs.shape == js.shape == (1, 256, SP_HOP128.n_frames)
    assert enhanced.shape == je.shape
    ds, de = np.abs(specs.numpy() - js), np.abs(enhanced.numpy() - je)
    assert ds.mean() < 1e-3 and ds.max() < 0.15, (ds.mean(), ds.max())
    assert (ds > 5e-3).mean() < 0.01
    assert de.mean() < 1e-3 and de.max() < 0.05, (de.mean(), de.max())


DEEP3 = ModelConfig(filters=(16, 32, 64), kernels=((3, 3),) * 3)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(cfg=DEEP3, stft_mode="fused"), NotImplementedError),
    (dict(dtype=None, stft_mode="fused"), NotImplementedError),
    (dict(dtype=None, stft_mode="fused_ft"), NotImplementedError),
    (dict(stft_mode="bogus"), ValueError),
], ids=["deep3-fused", "f32-fused", "f32-fused_ft", "bogus"])
def test_mode_guards_match_jax(kwargs, exc):
    """The JAX service's eligibility rules (tests/test_stft_fused.py's
    guards): the port raises where it raises, with the same exception."""
    jkw = dict(kwargs)
    cfg = jkw.pop("cfg", CFG)
    with pytest.raises(exc):
        jharness.make_enhance_shot_fn(cfg, SP, use_kernel=True, interpret=True, **jkw)
    with pytest.raises(exc):
        harness.make_enhance_shot_fn(cfg, SP, device="cpu", **jkw)


def test_deep3_fused_ft_serves():
    """"fused_ft" needs no depth-2 family: deep3 serves through it, as
    "auto"."""
    model = make_model(DEEP3, generator=torch.Generator().manual_seed(0)).eval()
    shot = harness.example_shot(SP, n_channels=1, seed=1)
    got = harness.make_enhance_shot_fn(DEEP3, SP, device="cpu", stft_mode="fused_ft")(model, shot)
    want = harness.make_enhance_shot_fn(DEEP3, SP, device="cpu")(model, shot)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
