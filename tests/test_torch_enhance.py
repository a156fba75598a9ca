"""The port's classical label pipeline (specenh_torch.ops.enhance, eager
torch on the CPU) against the JAX package's (specenh.ops.enhance), NumPy's
float64 quantile and OpenCV: the quantile, uint8, blur, morphology and
bilateral ops bit for bit, the composed pipeline within 1e-6 on the same
spectrograms, and SSIM >= 0.999 against the port's ``pipeline_ref``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from specenh.config import PipelineConfig as JPipelineConfig
from specenh.ops import enhance as je
from specenh_torch.bench.harness import example_shot
from specenh_torch.bench.reference import (HAS_CV2, pipeline_ref, quantfilt_ref,
                                           rescale_ref, ssim)
from specenh_torch.config import PipelineConfig, SpecParams
from specenh_torch.ops import enhance as te
from specenh_torch.ops.stft import spectrogram

if HAS_CV2:
    import cv2

SP = SpecParams(cut_shot=0.2)  # 256 x 389 spectrograms
SHAPES = {"one": (256, SP.n_frames), "batched": (2, 256, SP.n_frames)}
TOL = 1e-6  # composed float stages: a float32 mean's rounding apart


def _rand(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _u8(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def _both(name, x, *args):
    """(JAX's output, the port's) of ``name`` on the same numpy input."""
    want = np.asarray(getattr(je, name)(jnp.asarray(x), *args))
    got = getattr(te, name)(torch.from_numpy(x), *args).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    return want, got


def _per_image(x):
    return x.reshape(-1, *x.shape[-2:])


@pytest.fixture(scope="module")
def specs():
    """Two channels of a synthetic shot's spectrograms, (2, 256, 389)."""
    shot = example_shot(SP, n_channels=2, seed=0)
    return spectrogram(torch.from_numpy(shot), SP).numpy()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_quantile_filter_matches_jax_and_numpy(shape):
    x = _rand(SHAPES[shape])
    want, got = _both("quantile_filter", x, 0.9)
    np.testing.assert_array_equal(got, want)
    for g, img in zip(_per_image(got), _per_image(x)):
        ref = quantfilt_ref(img.astype(np.float64), 0.9).astype(np.float32)
        np.testing.assert_array_equal(g, ref)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("thr", [0.25, 0.5, 0.9])
def test_quantile_filter_exact_at_ties(thr, shape):
    """Tie-heavy quantised data, where a float32 interpolation flips pixels:
    bit for bit NumPy's float64 quantile and JAX's double-float one."""
    rng = np.random.default_rng(3)
    x = (np.round(rng.random(SHAPES[shape]) * 7) / 7).astype(np.float32)
    want, got = _both("quantile_filter", x, thr)
    np.testing.assert_array_equal(got, want)
    q = np.quantile(x.astype(np.float64), thr, axis=-2, keepdims=True)
    np.testing.assert_array_equal(got, np.where(x.astype(np.float64) < q, 0, x))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_to_uint8_matches_jax(shape):
    x = _rand(SHAPES[shape])
    want, got = _both("to_uint8", x)
    np.testing.assert_array_equal(got, want)
    for g, img in zip(_per_image(got), _per_image(x)):
        np.testing.assert_array_equal(g.astype(np.uint8), (rescale_ref(img) * 255).astype("uint8"))


def test_to_uint8_truncates():
    x = np.array([[0.0, 0.299999, 0.3], [0.9999, 0.5, 1.0]], np.float32)
    got = te.to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint8), (rescale_ref(x) * 255).astype("uint8"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_gaussian_blur_u8_bitexact(shape):
    u8 = _u8(SHAPES[shape])
    want, got = _both("gaussian_blur_u8", u8, (31, 3))
    np.testing.assert_array_equal(got, want)
    if HAS_CV2:
        for g, img in zip(_per_image(got), _per_image(u8)):
            np.testing.assert_array_equal(
                g.astype(np.uint8), cv2.GaussianBlur(img.astype(np.uint8), (31, 3), 0))


_CV_MORPH = {"dilate": ("dilate", None), "erode": ("erode", None),
             "morph_close": ("morphologyEx", "MORPH_CLOSE"),
             "morph_open": ("morphologyEx", "MORPH_OPEN")}


@pytest.mark.parametrize("se", [(4, 4), (3, 1)], ids=["4x4", "3x1"])
@pytest.mark.parametrize("op", sorted(_CV_MORPH))
def test_morphology_bitexact(op, se):
    u8 = _u8(SHAPES["batched"], seed=2)
    want, got = _both(op, u8, se)
    np.testing.assert_array_equal(got, want)
    if HAS_CV2:
        fn, kind = _CV_MORPH[op]
        k = cv2.getStructuringElement(cv2.MORPH_RECT, se)
        for g, img in zip(got, u8):
            args = (img.astype(np.uint8),) + ((getattr(cv2, kind),) if kind else ()) + (k,)
            np.testing.assert_array_equal(g.astype(np.uint8), getattr(cv2, fn)(*args))


@pytest.mark.parametrize("shape,args", [((64, 97), (15, 75, 75)), ((80, 120), (9, 40, 30))],
                         ids=["d15", "d9"])
def test_bilateral_u8_bitexact(shape, args):
    u8 = _u8(shape, seed=5)
    want, got = _both("bilateral_u8", u8, *args)
    np.testing.assert_array_equal(got, want)
    if HAS_CV2:
        np.testing.assert_array_equal(got.astype(np.uint8),
                                      cv2.bilateralFilter(u8.astype(np.uint8), *args))


def test_bilateral_matches_jax():
    x = _rand((64, 97), seed=6)
    want, got = _both("bilateral", x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("emulate", [True, False], ids=["u8", "float"])
def test_gaussian_blur_matches_jax(emulate, specs):
    want, got = _both("gaussian_blur", specs, (31, 3), emulate)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["rescale", "normalize", "mean_subtract", "morph"])
def test_float_stages_match_jax(name, specs):
    want, got = _both(name, specs)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL if name != "normalize" else 1e-5)


def test_pipeline_stages_match_jax(specs):
    """Each stage on JAX's own input to it: the uint8 stages bit for bit,
    the float stages within TOL."""
    want = je.pipeline_stages(jnp.asarray(specs))
    feed = {"quant": specs, "gauss": want["quant"], "mean": want["gauss"],
            "morph": want["mean"], "final": want["morph"]}
    cfg = PipelineConfig()
    stage = {"quant": lambda x: te.quantile_filter(x, cfg.quant_threshold),
             "gauss": lambda x: te.gaussian_blur(x, cfg.gauss_ksize),
             "mean": te.mean_subtract, "morph": te.morph, "final": te.mean_subtract}
    assert sorted(te.pipeline_stages(torch.from_numpy(specs))) == sorted(want)
    for k, fn in stage.items():
        got = fn(torch.from_numpy(np.array(feed[k]))).numpy()
        if k in ("quant", "morph"):
            np.testing.assert_array_equal(got, np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(got, np.asarray(want[k]), rtol=0, atol=TOL, err_msg=k)


def _assert_composed_matches(got: dict, want: dict):
    """The composed pipeline against JAX's.  The port's row mean is the
    float64 mean rounded once; JAX's is a float32 sum whose order is
    XLA's, one ulp apart in some rows.  Where that ulp moves a point of
    the morph stage's uint8 quantisation across an integer, the point
    differs by exactly one uint8 level, and the morph and final stages of
    the frequency rows the CLOSE window reaches from it (a dilate and an
    erode of a 4-row window: 4 rows either way) move with it.  Those flips
    must be rare; everything else within TOL."""
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("quant", "gauss", "mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
    u8_got = te.to_uint8(torch.from_numpy(got["mean"])).numpy()
    u8_want = np.asarray(je.to_uint8(jnp.asarray(want["mean"])))
    flips = u8_got != u8_want
    assert flips.mean() <= 1e-4, f"{flips.sum()} uint8 flips"
    np.testing.assert_array_equal(np.abs(u8_got - u8_want)[flips], 1.0)
    reach = PipelineConfig().close_se[1]
    rows = torch.from_numpy(flips.any(-1).astype(np.float32)).reshape(-1, 1, flips.shape[-2])
    rows = torch.nn.functional.max_pool1d(rows, 2 * reach + 1, 1, reach)
    rows = rows.reshape(flips.shape[:-1])[..., None].numpy() > 0
    for k in ("morph", "final"):
        d = np.abs(got[k] - want[k])
        assert float(np.where(rows, 0.0, d).max()) <= TOL, k
        assert float(d.max()) <= 2 / 255, k


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_classical_pipeline_matches_jax(shape, specs):
    x = specs if shape == "batched" else specs[0]
    want = je.pipeline_stages(jnp.asarray(x), JPipelineConfig())
    got = te.pipeline_stages(torch.from_numpy(x), PipelineConfig())
    _assert_composed_matches(got, want)
    final = te.classical_pipeline(torch.from_numpy(x), PipelineConfig()).numpy()
    assert final.shape == x.shape
    np.testing.assert_array_equal(final, got["final"].numpy())
    np.testing.assert_array_equal(
        np.asarray(je.classical_pipeline(jnp.asarray(x))), np.asarray(want["final"]))


def test_classical_pipeline_float_option_matches_jax(specs):
    cfg = dict(emulate_uint8=False, quant_threshold=0.8)
    want = np.asarray(je.classical_pipeline(jnp.asarray(specs[0]), JPipelineConfig(**cfg)))
    got = te.classical_pipeline(torch.from_numpy(specs[0]), PipelineConfig(**cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_classical_pipeline_matches_pipeline_ref(specs):
    got = te.classical_pipeline(torch.from_numpy(specs)).numpy()
    for c in range(2):
        ref = pipeline_ref(specs[c])
        assert ssim(got[c], ref) >= 0.999
        assert np.mean(np.abs(got[c] - ref) > 1e-4) <= 1e-4
