"""The port's conv-AE (specenh_torch.models, specenh_torch.ops.ae_kernel)
against the JAX package: the converted nn.Module vs Flax for every
reference depth-2 geometry, the whole AE's plain twin vs the JAX Pallas AE
kernel (interpret mode), and the stage wrappers' CPU twins vs the module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh.config import ModelConfig, SpecParams
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import ae_kernel as jak
from specenh_torch._build import KERNELS
from specenh_torch.models.autoencoder import (convt_pad_before, make_model,
                                              param_count)
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops.stft import spectrogram

SP = SpecParams(cut_shot=0.2)  # 389 frames -> 3 tiles per channel
K_TILES = 3
# every reference depth-2 geometry: the array sweep's k3/k5/k7
# (hyperparam_scan.py:123) and the manual (64, 32)/k5 config
GEOMETRIES = [
    ModelConfig(),
    ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
    ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
]
IDS = ["k3", "k5", "k7", "manual"]


def _flax_and_torch(cfg, seed=3):
    fm = flax_model(cfg)
    params = fm.init(jax.random.PRNGKey(seed),
                     np.zeros((1, *cfg.input_shape), np.float32))
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return fm, params, model.eval()


@pytest.fixture(scope="module")
def flagship():
    fm, params, model = _flax_and_torch(ModelConfig(), seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SP.n_samples)).astype(np.float32)
    specs = spectrogram(torch.from_numpy(x), SP)
    return params, model, specs


@pytest.mark.parametrize("cfg", GEOMETRIES, ids=IDS)
def test_module_matches_flax(cfg):
    fm, params, model = _flax_and_torch(cfg)
    tiles = np.random.default_rng(5).random((2, 256, 128, 1)).astype(np.float32)
    want = np.asarray(fm.apply(params, tiles))[..., 0]
    with torch.no_grad():
        got = model(torch.from_numpy(tiles[..., 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert param_count(model) == sum(p.size for p in jax.tree_util.tree_leaves(params))


def test_convt_padding_is_jax_same_rule():
    """pad_a of jax.lax's SAME transposed conv: (2,1) k3, (3,2) k5, (4,3) k7."""
    from jax._src.lax.convolution import _conv_transpose_padding

    for k, want in ((1, 0), (3, 2), (5, 3), (7, 4)):
        assert convt_pad_before(k) == want == _conv_transpose_padding(k, 2, "SAME")[0]


def test_state_dict_layout():
    cfg = GEOMETRIES[3]
    _, params, model = _flax_and_torch(cfg)
    sd = state_dict_from_flax(params, cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    # Conv: HWIO -> OIHW; ConvTranspose: flipped HWIO -> (I, O, H, W)
    k0 = np.asarray(params["params"]["enc_conv0"]["kernel"])
    np.testing.assert_array_equal(sd["enc_convs.0.weight"].numpy(), k0.transpose(3, 2, 0, 1))
    kt = np.asarray(params["params"]["dec_deconv1"]["kernel"])
    np.testing.assert_array_equal(sd["dec_deconvs.1.weight"].numpy(),
                                  kt[::-1, ::-1].transpose(2, 3, 0, 1))


def test_glorot_init_is_seeded_and_bounded():
    cfg = ModelConfig()
    a = make_model(cfg, generator=torch.Generator().manual_seed(7))
    b = make_model(cfg, generator=torch.Generator().manual_seed(7))
    c = make_model(cfg, generator=torch.Generator().manual_seed(8))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        if name.endswith("bias"):
            assert not pa.any()
        else:
            assert not torch.equal(pa, pc)
            o, i = (pa.shape[0], pa.shape[1]) if "dec_" not in name else (pa.shape[1], pa.shape[0])
            kk = pa.shape[2] * pa.shape[3]
            assert pa.abs().max() <= (6.0 / (kk * (i + o))) ** 0.5


def test_enhance_specs_plain_matches_jax_kernel(flagship):
    """patch -> module -> unpatch vs the Pallas AE kernel with its parity
    turns (bf16 operands, interpret mode): bf16-class tolerance as
    tests/test_ae_kernel.py."""
    params, model, specs = flagship
    wts = jak.build_kernel_weights(params, ModelConfig())
    want = np.asarray(jak.ae_kernel_enhance_specs(wts, jnp.asarray(specs.numpy()),
                                                  K_TILES, interpret=True))
    with torch.no_grad():
        got = tak.ae_kernel_enhance_specs_plain(model, specs, K_TILES).numpy()
    assert got.shape == want.shape == (2, 256, K_TILES * 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, 5e-3)],
                         ids=["f32", "bf16"])
def test_stage_twins_match_module(flagship, dtype, atol):
    """On CPU the stage wrappers run their twins; composed they are the
    module (float32 exactly up to summation order; bf16 rounds activations
    where the kernels do)."""
    _, model, specs = flagship
    launches = [k.launches for k in KERNELS]
    wts = tak.build_kernel_weights(model, dtype)
    with torch.no_grad():
        got = tak.ae_kernel_enhance_specs(wts, specs, K_TILES)
        want = tak.ae_kernel_enhance_specs_plain(model, specs, K_TILES)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert [k.launches for k in KERNELS] == launches


@pytest.mark.parametrize("cfg", GEOMETRIES[1:], ids=IDS[1:])
def test_kernel_weight_layout_all_geometries(cfg):
    """build_kernel_weights' layouts (incl. the unflipped transposed-conv
    kernels) reproduce the module for every supported geometry."""
    _, _, model = _flax_and_torch(cfg)
    tiles = torch.from_numpy(np.random.default_rng(2).random((1, 256, 128)).astype(np.float32))
    with torch.no_grad():
        got = tak.ae_kernel_apply(tak.build_kernel_weights(model, torch.float32), tiles)
        want = model(tiles)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_supports_matches_jax():
    cfgs = GEOMETRIES + [
        ModelConfig(filters=(16, 32)),
        ModelConfig(kernels=((9, 9), (3, 3))),
        ModelConfig(filters=(16, 32, 64), kernels=((3, 3),) * 3),
        ModelConfig(kernels=((1, 1), (1, 1)), out_kernel=(1, 1)),
    ]
    for cfg in cfgs:
        assert tak.supports(cfg) == jak.supports(cfg), cfg


def test_build_kernel_weights_rejects():
    deep3 = ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3, out_kernel=(5, 5))
    with pytest.raises(NotImplementedError):
        tak.build_kernel_weights(make_model(deep3, generator=torch.Generator()))
    with pytest.raises(TypeError):
        tak.build_kernel_weights(make_model(ModelConfig(), generator=torch.Generator()),
                                 torch.float16)
