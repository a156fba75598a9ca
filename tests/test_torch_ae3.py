"""The port's depth-3 AE (specenh_torch.ops.ae3_kernel, the deep3 preset:
VAE/manual_scan_3layers.py:185-233) against the JAX package on the CPU: the
converted nn.Module vs Flax, ``supports3``, the whole AE's plain twin vs the
JAX depth-3 Pallas kernel with its tile turns (interpret mode), the stage
wrappers' CPU twins vs the module, and the service vs the JAX kernel
service.  Inputs from numpy seeds, Flax-initialised weights converted with
``state_dict_from_flax``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh.bench import harness as jharness
from specenh.config import MODEL_PRESETS as JPRESETS
from specenh.config import ModelConfig as JModelConfig
from specenh.config import SpecParams as JSpecParams
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import ae3_kernel as jak3
from specenh_torch import ModelConfig, SpecParams
from specenh_torch._build import KERNELS
from specenh_torch.bench import harness
from specenh_torch.config import MODEL_PRESETS
from specenh_torch.models.autoencoder import make_model, param_count
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae3_kernel as tak3
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops.stft import spectrogram

DEEP3 = MODEL_PRESETS["deep3"]
SP = SpecParams(cut_shot=0.2)  # 389 frames -> 3 tiles per channel
K_TILES = 3
# depth-3 geometries of the JAX kernel's tests (tests/test_ae3_kernel.py)
GEOMETRIES = {
    "deep3": DEEP3,
    "k3": ModelConfig(filters=(16, 32, 64), kernels=((3, 3),) * 3, out_kernel=(3, 3)),
    "k7_c32": ModelConfig(filters=(32, 32, 32), kernels=((7, 7),) * 3, out_kernel=(7, 7)),
    "mixed": ModelConfig(filters=(16, 16, 16), kernels=((5, 5), (3, 3), (7, 7)),
                         out_kernel=(5, 5)),
}


def _flax_and_torch(cfg, seed=0):
    jcfg = JModelConfig(**{f: getattr(cfg, f) for f in ("filters", "kernels", "out_kernel",
                                                         "input_shape")})
    fm = flax_model(jcfg)
    params = fm.init(jax.random.PRNGKey(seed), np.zeros((1, *cfg.input_shape), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return fm, params, model.eval()


@pytest.fixture(scope="module")
def deep3():
    fm, params, model = _flax_and_torch(DEEP3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SP.n_samples)).astype(np.float32)
    specs = spectrogram(torch.from_numpy(x), SP)
    return params, model, x, specs


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_module_matches_flax(name):
    cfg = GEOMETRIES[name]
    fm, params, model = _flax_and_torch(cfg, seed=3)
    tiles = np.random.default_rng(5).random((2, 256, 128, 1)).astype(np.float32)
    want = np.asarray(fm.apply(params, tiles))[..., 0]
    with torch.no_grad():
        got = model(torch.from_numpy(tiles[..., 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert param_count(model) == sum(p.size for p in jax.tree_util.tree_leaves(params))


def test_supports3_matches_jax():
    cfgs = [*GEOMETRIES.values(),
            ModelConfig(),
            ModelConfig(filters=(16, 32, 128), kernels=((5, 5),) * 3, out_kernel=(5, 5)),
            ModelConfig(filters=(16, 32, 64), kernels=((9, 9),) * 3, out_kernel=(9, 9)),
            ModelConfig(filters=(48, 48, 64), kernels=((1, 1),) * 3, out_kernel=(1, 1)),
            ModelConfig(filters=(16, 24, 64), kernels=((5, 5),) * 3, out_kernel=(5, 5)),
            ModelConfig(filters=(16, 32, 64), kernels=((5, 5), (5, 3), (5, 5)), out_kernel=(5, 5)),
            ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3, out_kernel=(5, 5),
                        input_shape=(128, 128, 1))]
    for cfg in cfgs:
        jcfg = JModelConfig(filters=cfg.filters, kernels=cfg.kernels,
                            out_kernel=cfg.out_kernel, input_shape=cfg.input_shape)
        assert tak3.supports3(cfg) == jak3.supports3(jcfg), cfg
    assert MODEL_PRESETS["deep3"] == ModelConfig(**vars(JPRESETS["deep3"]))


def test_enhance_specs_plain_matches_jax_kernel(deep3):
    """patch -> module -> unpatch vs the depth-3 Pallas kernel with its
    tile turns (bf16 operands, interpret mode): the bounds of
    tests/test_ae3_kernel.py."""
    params, model, _, specs = deep3
    wts = jak3.build_kernel3_weights(params, JPRESETS["deep3"])
    want = np.asarray(jak3.ae3_kernel_enhance_specs(wts, jnp.asarray(specs.numpy()), K_TILES,
                                                    interpret=True))
    with torch.no_grad():
        got = tak3.ae3_kernel_enhance_specs_plain(model, specs, K_TILES).numpy()
    assert got.shape == want.shape == (2, 256, K_TILES * 128)
    assert np.abs(got - want).max() < 5e-3
    assert np.abs(got - want).mean() < 2e-4


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, 5e-3)],
                         ids=["f32", "bf16"])
def test_stage_twins_match_module(deep3, dtype, atol):
    """On CPU the seven-layer stage chain runs its twins; composed they are
    the module (float32 up to summation order; bf16 rounds activations
    where the kernels do), and no kernel launches."""
    _, model, _, specs = deep3
    launches = [k.launches for k in KERNELS]
    wts = tak3.build_kernel3_weights(model, dtype)
    assert (wts.depth, wts.out, len(wts.w)) == (3, 6, 7)
    assert [wts.is_convt(i) for i in range(7)] == [False] * 3 + [True] * 3 + [False]
    with torch.no_grad():
        got = tak3.ae3_kernel_enhance_specs(wts, specs, K_TILES)
        want = tak3.ae3_kernel_enhance_specs_plain(model, specs, K_TILES)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert [k.launches for k in KERNELS] == launches


@pytest.mark.parametrize("name", ["k3", "k7_c32", "mixed"])
def test_kernel3_weight_layout_other_geometries(name):
    """build_kernel3_weights' layouts reproduce the module for the JAX
    kernel's other depth-3 geometries (float32 twins)."""
    _, _, model = _flax_and_torch(GEOMETRIES[name], seed=3)
    tiles = torch.from_numpy(np.random.default_rng(5).random((1, 256, 128)).astype(np.float32))
    with torch.no_grad():
        got = tak3.ae3_kernel_apply(tak3.build_kernel3_weights(model, torch.float32), tiles)
        want = model(tiles)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_service_matches_jax_kernel_service(deep3):
    """The CPU service against the JAX service on its depth-3 kernel
    (interpret mode), both bf16, with tests/test_ae3_kernel.py's bounds;
    the port runs no kernel on the CPU."""
    params, model, x, _ = deep3
    jsp = JSpecParams(cut_shot=0.2)
    js, je = jharness.make_enhance_shot_fn(JPRESETS["deep3"], jsp, use_kernel=True,
                                           interpret=True)(params, jnp.asarray(x))
    launches = [k.launches for k in KERNELS]
    fn = harness.make_enhance_shot_fn(DEEP3, SP, device="cpu")
    specs, enhanced = fn(model, x)
    assert [k.launches for k in KERNELS] == launches
    assert enhanced.shape == je.shape == (2, 256, K_TILES * 128)
    np.testing.assert_allclose(specs.numpy(), np.asarray(js), rtol=0, atol=2e-2)
    err = np.abs(enhanced.numpy() - np.asarray(je))
    assert err.max() < 5e-2 and err.mean() < 2e-3


def test_kernel_family_and_prepare(deep3):
    """kernel_depth picks depth 2 or 3 as the JAX harness's _kernel_family
    does, and raises for a geometry outside both, as does the service with
    the kernel route forced (``use_kernel=True``; "auto" serves such a
    geometry on the module route); the deep3 service's prepare gives
    depth-3 weights and is idempotent."""
    _, model, x, _ = deep3
    assert tak.kernel_depth(DEEP3) == 3 and tak.kernel_depth(ModelConfig()) == 2
    wide = ModelConfig(filters=(16, 32, 128), kernels=((5, 5),) * 3, out_kernel=(5, 5))
    for cfg in (wide, ModelConfig(filters=(16, 32))):
        with pytest.raises(NotImplementedError):
            tak.kernel_depth(cfg)
        with pytest.raises(NotImplementedError):
            harness.make_enhance_shot_fn(cfg, SP, device="cpu", use_kernel=True)
    fn = harness.make_enhance_shot_fn(DEEP3, SP, dtype=None, device="cpu")
    wts = fn.prepare(model)
    assert wts.depth == 3 and wts.dtype == torch.float32 and fn.prepare(wts) is wts
    got = fn(wts, torch.from_numpy(x))
    want = harness.enhance_shot_plain(model, torch.from_numpy(x), SP)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_depth3_wrappers_check_layers(deep3):
    _, model, _, _ = deep3
    wts = tak3.build_kernel3_weights(model, torch.float32)
    x = torch.zeros(1, 64, 32, 16)
    with pytest.raises(ValueError):
        tak.ae_convt(wts, x, 2)  # an encoder layer at depth 3
    with pytest.raises(ValueError):
        tak.ae_conv_pool(wts, torch.zeros(1, 64, 32, 16), 3)
    with pytest.raises(ValueError):
        tak.ae_tile_out(wts, torch.zeros(1, 32, 256, 128), 1)  # the out-conv reads 16


def test_prepare_rejects_weights_of_another_depth(deep3):
    """A service takes prepared weights of its own depth only, both ways."""
    _, model, _, _ = deep3
    flagship = make_model(ModelConfig(), generator=torch.Generator())
    for cfg, other in ((DEEP3, flagship), (ModelConfig(), model)):
        fn = harness.make_enhance_shot_fn(cfg, SP, device="cpu")
        with pytest.raises(ValueError):
            fn.prepare(tak.build_kernel_weights(other))
        with pytest.raises(ValueError):
            fn(tak.build_kernel_weights(other), np.zeros((1, SP.n_samples), np.float32))
