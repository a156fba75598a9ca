"""The port's serving slice (specenh_torch.bench.harness) against the JAX
package's service on CPU: the same shot and the same (converted) weights
through both ``make_enhance_shot_fn(dtype=None)``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh.bench import harness as jharness
from specenh.config import ModelConfig, SpecParams
from specenh.models.autoencoder import make_model as flax_model
from specenh_torch.bench import harness
from specenh_torch.bench.reference import ssim
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax

SP = SpecParams(cut_shot=0.2)
CFG = ModelConfig()


@pytest.fixture(scope="module")
def setup():
    fm = flax_model(CFG)
    params = fm.init(jax.random.PRNGKey(0), np.zeros((1, *CFG.input_shape), np.float32))
    model = make_model(CFG, generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(state_dict_from_flax(params, CFG))
    shot = harness.example_shot(SP, n_channels=2, seed=0)
    return params, model, shot


def test_example_shot_matches_jax():
    np.testing.assert_array_equal(harness.example_shot(SP, 3, seed=4),
                                  jharness.example_shot(SP, 3, seed=4))


def test_service_matches_jax_service(setup):
    params, model, shot = setup
    js, je = jharness.make_enhance_shot_fn(CFG, SP, dtype=None)(params, jnp.asarray(shot))
    fn = harness.make_enhance_shot_fn(CFG, SP, dtype=None, device="cpu")
    specs, enhanced = fn(model, shot)
    assert specs.shape == js.shape == (2, 256, SP.n_frames)
    assert enhanced.shape == je.shape == (2, 256, 3 * 128)
    np.testing.assert_allclose(specs.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(enhanced.numpy(), np.asarray(je), rtol=0, atol=1e-4)


def test_service_matches_plain_service(setup):
    _, model, shot = setup
    fn = harness.make_enhance_shot_fn(CFG, SP, dtype=None, device="cpu")
    wts = fn.prepare(model)
    assert fn.prepare(wts) is wts
    got = fn(wts, torch.from_numpy(shot))
    want = harness.enhance_shot_plain(model, torch.from_numpy(shot), SP)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_bf16_service_passes_the_enhanced_gate(setup):
    """The bf16 service against the float32 one: SSIM >= 0.999 per channel,
    the repo's enhanced-output gate (headline.py:63-73)."""
    _, model, shot = setup
    _, e32 = harness.make_enhance_shot_fn(CFG, SP, dtype=None, device="cpu")(model, shot)
    _, e16 = harness.make_enhance_shot_fn(CFG, SP, device="cpu")(model, shot)
    assert e16.dtype == torch.float32
    for c in range(2):
        assert ssim(e16[c].numpy(), e32[c].numpy()) >= 0.999


@pytest.mark.parametrize("kwargs,exc", [
    (dict(cfg=ModelConfig(filters=(16, 32, 128), kernels=((5, 5),) * 3,
                          out_kernel=(5, 5)), use_kernel=True), NotImplementedError),
    (dict(sp=SpecParams(nperseg=256, noverlap=128)), ValueError),
    (dict(sp=SpecParams(cut_shot=0.05)), ValueError),
], ids=["depth3", "nperseg256", "too-short"])
def test_service_rejects(kwargs, exc):
    """A geometry no kernel family covers, with the kernel route forced
    (``use_kernel=True``, as JAX's raises; "auto" serves it on the module,
    tests/test_torch_module_route.py), and a shot too short to tile raise
    when the service is built.  nperseg 256 gives 129 one-sided rows: the
    JAX service builds ("auto" falls back to its matmul front) and its call
    leaves the 256-row tiles' rows past the 128 kept ones unfilled (NaN in
    interpret mode); the port's service builds too, and its call raises
    where the first AE stage finds 128-row spectrograms."""
    sp = kwargs.get("sp", SpecParams())
    with pytest.raises(exc):
        fn = harness.make_enhance_shot_fn(device="cpu", **kwargs)
        model = make_model(CFG, generator=torch.Generator().manual_seed(0)).eval()
        fn(model, harness.example_shot(sp, n_channels=1, seed=0))
