"""The port's module route and bf16 module against the JAX package on the
CPU: the service's ``use_kernel`` (False, and "auto" for a geometry no
kernel family covers) against JAX's Flax-route service, the module's
``dtype`` (bf16 computation, float32 parameters) against Flax's
``make_model(cfg, dtype=jnp.bfloat16)``, and three bf16 autograd steps
against JAX's ``create_state(dtype=jnp.bfloat16)`` steps.  Weights come
from one Flax init, carried over with ``state_dict_from_flax``; inputs are
made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh import train as jtrain
from specenh.bench import harness as jharness
from specenh.config import (MODEL_PRESETS as JPRESETS, ModelConfig as JModelConfig,
                            SpecParams, TrainConfig as JTrainConfig)
from specenh.models.autoencoder import make_model as flax_model
from specenh_torch import ModelConfig, TrainConfig
from specenh_torch import train as ttrain
from specenh_torch.bench import harness
from specenh_torch.bench.reference import ssim
from specenh_torch.config import MODEL_PRESETS
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel as tak

SP = SpecParams(cut_shot=0.2)
# a depth-3 geometry no kernel family covers (128 filters): JAX serves it
# on Flax
UNCOVERED = dict(filters=(16, 32, 128), kernels=((5, 5),) * 3, out_kernel=(5, 5))
CFG, JCFG = ModelConfig(**UNCOVERED), JModelConfig(**UNCOVERED)


def _params(jcfg, seed=0):
    return flax_model(jcfg).init(jax.random.PRNGKey(seed),
                                 np.zeros((1, *jcfg.input_shape), np.float32))


def _module(cfg, params, dtype=None):
    model = make_model(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype).eval()
    model.load_state_dict(state_dict_from_flax(params, cfg))
    return model


@pytest.fixture(scope="module")
def served():
    """JAX's Flax-route service in float32 and bf16 on a 2-channel shot."""
    params = _params(JCFG)
    shot = harness.example_shot(SP, n_channels=2, seed=0)
    out = {dt: jharness.make_enhance_shot_fn(JCFG, SP, dtype=dt, use_kernel=False)(
        params, jnp.asarray(shot)) for dt in (None, jnp.bfloat16)}
    return _module(CFG, params), shot, out


@pytest.mark.parametrize("use_kernel", [False, "auto"], ids=["module", "auto"])
def test_module_route_matches_jax_flax_service(served, use_kernel):
    """float32: specs and enhanced outputs within 1e-4 max |err| of JAX's
    Flax route (the float64-then-float32 matmul STFT against JAX's
    HIGHEST one; float32 convs in other orders)."""
    model, shot, out = served
    fn = harness.make_enhance_shot_fn(CFG, SP, dtype=None, device="cpu", use_kernel=use_kernel)
    assert fn.prepare(model) is model
    specs, enhanced = fn(model, shot)
    js, je = out[None]
    assert specs.shape == js.shape and enhanced.shape == je.shape == (2, 256, 3 * 128)
    np.testing.assert_allclose(specs.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_allclose(enhanced.numpy(), np.asarray(je), rtol=0, atol=1e-4)


@pytest.mark.parametrize("use_kernel", [False, "auto"], ids=["module", "auto"])
def test_bf16_module_route_passes_the_gate_against_jax(served, use_kernel):
    """bf16: enhanced SSIM >= 0.999 per channel against JAX's bf16 Flax
    route (whose STFT is a single-pass bf16 dot; the port's stays
    float64 -> float32), and against the port's own float32 route."""
    model, shot, out = served
    _, e16 = harness.make_enhance_shot_fn(CFG, SP, device="cpu", use_kernel=use_kernel)(
        model, shot)
    _, e32 = harness.make_enhance_shot_fn(CFG, SP, dtype=None, device="cpu",
                                          use_kernel=use_kernel)(model, shot)
    assert e16.dtype == torch.float32
    je = np.asarray(out[jnp.bfloat16][1], np.float32)
    for c in range(2):
        assert ssim(e16[c].numpy(), je[c]) >= 0.999
        assert ssim(e16[c].numpy(), e32[c].numpy()) >= 0.999


def test_module_route_ignores_the_modules_own_dtype(served):
    """The module route computes in the service dtype whatever the module
    was built with; ``enhance_shot_plain`` in the module's own."""
    model, shot, _ = served
    m16 = _module(CFG, _params(JCFG), dtype=torch.bfloat16)
    fn = harness.make_enhance_shot_fn(CFG, SP, dtype=None, device="cpu", use_kernel=False)
    a, b = fn(model, shot), fn(m16, shot)
    assert torch.equal(a[1], b[1])
    _, plain16 = harness.enhance_shot_plain(m16, torch.from_numpy(shot), SP)
    assert not torch.equal(plain16, a[1])


def test_use_kernel_true_raises_where_no_family_covers():
    with pytest.raises(NotImplementedError):
        harness.make_enhance_shot_fn(CFG, SP, device="cpu", use_kernel=True)
    with pytest.raises(NotImplementedError):
        jharness.make_enhance_shot_fn(JCFG, SP, use_kernel=True)


@pytest.mark.parametrize("mode", ["fused", "fused_ft"])
@pytest.mark.parametrize("cfg", [ModelConfig(), CFG], ids=["flagship", "uncovered"])
def test_fused_fronts_need_the_kernel_route(mode, cfg):
    """"fused" and "fused_ft" raise unless the kernel route is on, as
    JAX's do: with ``use_kernel=False``, and with "auto" where no family
    covers the geometry."""
    kw = dict(use_kernel=False) if cfg == ModelConfig() else {}
    with pytest.raises(NotImplementedError):
        harness.make_enhance_shot_fn(cfg, SP, device="cpu", stft_mode=mode, **kw)


def test_module_route_rejects_kernel_weights(served):
    model, shot, _ = served
    flagship = make_model(ModelConfig(), generator=torch.Generator().manual_seed(0))
    wts = tak.build_kernel_weights(flagship, torch.bfloat16)
    fn = harness.make_enhance_shot_fn(ModelConfig(), SP, device="cpu", use_kernel=False)
    with pytest.raises(TypeError):
        fn(wts, shot)
    with pytest.raises(TypeError):
        fn.prepare(wts)
    with pytest.raises(ValueError):
        harness.make_enhance_shot_fn(ModelConfig(), SP, device="cpu", use_kernel="yes")


def test_use_kernel_false_serves_a_covered_geometry_on_the_module():
    """A covered geometry with ``use_kernel=False``: the module route, the
    same numbers as the plain float32 service."""
    model = make_model(ModelConfig(), generator=torch.Generator().manual_seed(0)).eval()
    shot = torch.from_numpy(harness.example_shot(SP, n_channels=1, seed=1))
    got = harness.make_enhance_shot_fn(ModelConfig(), SP, dtype=None, device="cpu",
                                       use_kernel=False)(model, shot)
    want = harness.enhance_shot_plain(model, shot, SP)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the bf16 module
# ---------------------------------------------------------------------------

PRESETS = ["flagship", "deep3"]


def _cfgs(name):
    if name == "flagship":
        return ModelConfig(), JModelConfig()
    return MODEL_PRESETS[name], JPRESETS[name]


@pytest.mark.parametrize("name", PRESETS)
def test_bf16_forward_matches_flax(name):
    """The module with ``dtype=torch.bfloat16`` against Flax's
    ``make_model(cfg, dtype=jnp.bfloat16).apply`` on 3 random tiles: max
    |err| <= 1e-3 on the probabilities (bf16 rounds in other places in
    the two frameworks; 3.1e-5 measured on the CPU); the output is float32
    and the parameters stay float32."""
    cfg, jcfg = _cfgs(name)
    params = _params(jcfg, seed=1)
    x = np.random.default_rng(5).random((3, 256, 128, 1)).astype(np.float32)
    want = np.asarray(flax_model(jcfg, dtype=jnp.bfloat16).apply(params, jnp.asarray(x)))
    model = _module(cfg, params, dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-3


@pytest.mark.parametrize("name", PRESETS)
def test_bf16_autograd_steps_match_jax(name):
    """Three ``train_step``s of the bf16 autograd engine against JAX's
    ``create_state(dtype=jnp.bfloat16)`` steps on the same batches (one
    padded, masked): each loss within 5e-5 relative (5.3e-6 was the
    largest gap measured on the CPU, flagship and deep3); the parameters
    and Adam's state stay float32."""
    cfg, jcfg = _cfgs(name)
    jtc, tc = JTrainConfig(batch_size=2), TrainConfig(batch_size=2)
    jst = jtrain.create_state(jcfg, jtc, dtype=jnp.bfloat16)
    st = ttrain.create_state(cfg, tc, device="cpu", dtype=torch.bfloat16)
    st.model.load_state_dict(state_dict_from_flax(jst.params, cfg))
    rng = np.random.default_rng(6)
    for step in range(3):
        x = rng.random((2, 256, 128, 1)).astype(np.float32)
        y = np.clip(0.8 * x + 0.1 * rng.random(x.shape), 0, 1).astype(np.float32)
        m = np.array([1.0, 0.0 if step == 1 else 1.0], np.float32)
        jst, jloss = jtrain.train_step(jst, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
        st, loss = ttrain.train_step(st, torch.from_numpy(x), torch.from_numpy(y),
                                     torch.from_numpy(m))
        assert abs(float(loss) - float(jloss)) <= 5e-5 * float(jloss), step
    assert all(p.dtype == torch.float32 for p in st.model.parameters())
    assert all(t.dtype == torch.float32 for s in st.optimizer.state.values()
               for t in s.values() if torch.is_tensor(t) and t.is_floating_point())
