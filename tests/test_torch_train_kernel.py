"""The port's training kernels (specenh_torch.ops.ae_train_kernel) against
the JAX package, on the CPU, where every stage wrapper runs its plain twin:
gradients against jax.value_and_grad of the Flax model in float32, the bf16
twins against the Pallas training kernel in interpret mode, padding and
pre-rounded inputs, K5 against K5b, and one optimizer step.  Inputs: 2
tiles of (256, 128) from a numpy seed, Flax-initialised weights converted
to the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import ae_train_kernel as jtk
from specenh.train import bce_from_logits as jbce
from specenh.train import create_state as jcreate_state
from specenh.train import train_step as jtrain_step
from specenh_torch import ModelConfig, TrainConfig
from specenh_torch._build import KERNELS
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_train_kernel as ttk
from specenh_torch.train import create_state, train_step

GEOMETRIES = {
    "k3": dict(),
    "k5": dict(kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    "k7": dict(kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
    "manual": dict(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
}


def _setup(kw, seed=0):
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    fm = flax_model(jcfg)
    params = fm.init(jax.random.PRNGKey(seed), np.zeros((1, *jcfg.input_shape), np.float32))
    state = create_state(cfg, TrainConfig(), device="cpu")
    state.model.load_state_dict(state_dict_from_flax(params, cfg))
    rng = np.random.default_rng(2)
    x = rng.random((2, 256, 128, 1)).astype(np.float32)
    y = (rng.random((2, 256, 128, 1)) > 0.6).astype(np.float32)
    return fm, params, state, x, y


def _flax_value_and_grad(fm, params, x, y, mask):
    def loss_fn(p):
        return jbce(fm.apply(p, x, logits=True), y, mask)

    return jax.value_and_grad(loss_fn)(params)


def _torch_grads(g, cfg):
    """A Flax gradient tree in the port's layout (the converter is linear)."""
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g), cfg)


@pytest.fixture(scope="module")
def flagship():
    return _setup({})


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_f32_loss_and_grads_match_jax(name):
    """The twins in float32 against autodiff of the Flax model: loss to
    rtol 1e-5 and every gradient leaf within 2e-5 * max(scale, 1), the
    JAX kernel's own bound (f32 sums in another order)."""
    fm, params, state, x, y = _setup(GEOMETRIES[name])
    mask = np.ones(2, np.float32)
    ref_loss, ref_g = _flax_value_and_grad(fm, params, x, y, mask)
    loss, grads = ttk.kernel_value_and_grad(
        state.model, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask),
        dtype=torch.float32)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    want = _torch_grads(ref_g, state.model.cfg)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert err < 2e-5 * max(scale, 1.0), (err, scale)


def test_bf16_twins_match_jax_kernel(flagship):
    """bf16 twins against the Pallas training kernel in interpret mode.
    Both round x, y, weights, stored activations and each dz to bf16 at the
    same points; the float32 sums run in other orders, so a value near a
    rounding boundary may land one bf16 ulp apart: within 1e-2 of the
    largest gradient, and the loss to 1e-4."""
    fm, params, state, x, y = flagship
    mask = np.ones(2, np.float32)
    jl, jg = jtk.kernel_value_and_grad(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        jtk.build_train_maps(JModelConfig()), interpret=True, dtype=jnp.bfloat16)
    loss, grads = ttk.kernel_value_and_grad(
        state.model, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask),
        dtype=torch.bfloat16)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    want = _torch_grads(jg, state.model.cfg)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert err <= 1e-2 * scale, (err, scale)


def test_padded_batch_equals_one_tile(flagship):
    """A padded batch (mask 1, 0) gives the one-tile batch's loss and
    gradients: padded tiles run forward but add nothing (f32, rtol 2e-5
    for the other summation order)."""
    _, _, state, x, y = flagship
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    lp, gp = ttk.kernel_value_and_grad(state.model, xt, yt, torch.tensor([1.0, 0.0]),
                                       dtype=torch.float32)
    l1, g1 = ttk.kernel_value_and_grad(state.model, xt[:1], yt[:1], torch.ones(1),
                                       dtype=torch.float32)
    np.testing.assert_allclose(float(lp), float(l1), rtol=1e-6)
    for k in g1:
        torch.testing.assert_close(gp[k], g1[k], rtol=2e-5, atol=1e-8)


def test_prerounded_inputs_and_pre_layout_identical(flagship):
    """Tiles already rounded to bf16 give identical sums (the cast is
    value-exact), and so does the pre-layout form (K5b) on bf16 tiles."""
    _, _, state, x, y = flagship
    rng = np.random.default_rng(0)
    y = rng.random(y.shape).astype(np.float32)  # labels off the bf16 grid
    xt, yt, m = torch.from_numpy(x), torch.from_numpy(y), torch.ones(2)
    a = ttk.kernel_loss_grad_sums(state.model, xt, yt, m, torch.bfloat16)
    b = ttk.kernel_loss_grad_sums(state.model, xt.bfloat16().float(),
                                  yt.bfloat16().float(), m, torch.bfloat16)
    c = ttk.kernel_loss_grad_sums(state.model, xt, yt, m, torch.bfloat16, pre=True)
    for other in (b, c):
        assert float(a[0]) == float(other[0]) and float(a[1]) == float(other[1])
        for k in a[2]:
            assert torch.equal(a[2][k], other[2][k]), k


def test_autograd_function_writes_grads(flagship):
    """kernel_bce_sum's backward writes the same gradients into .grad as
    kernel_loss_grad_sums returns, scaled by the incoming gradient."""
    _, _, state, x, y = flagship
    xt, yt, m = torch.from_numpy(x), torch.from_numpy(y), torch.ones(2)
    _, grads = ttk.kernel_value_and_grad(state.model, xt, yt, m, dtype=torch.float32)
    state.model.zero_grad()
    (ttk.kernel_bce_sum(state.model, xt, yt, m, torch.float32) / (2 * 256 * 128)).backward()
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.grad, grads[name], rtol=1e-6, atol=0)


def test_one_step_matches_jax(flagship):
    """make_kernel_train_step(float32) and the port's train_step each
    match the JAX train_step after one Adam step (Keras eps): atol 2e-4,
    the JAX kernel test's bound (Adam's m/(sqrt(v)+eps) amplifies f32
    noise in near-zero gradients to a fraction of the 1e-3 step)."""
    fm, params, _, x, y = flagship
    mask = np.ones(2, np.float32)
    tc = JTrainConfig()
    jstate, jloss = jtrain_step(jcreate_state(JModelConfig(), tc).replace(params=params),
                                jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    want = state_dict_from_flax(jstate.params, ModelConfig())
    xt, yt, m = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    for step in (ttk.make_kernel_train_step(ModelConfig(), torch.float32), train_step):
        state = create_state(ModelConfig(), TrainConfig(), device="cpu")
        state.model.load_state_dict(state_dict_from_flax(params, ModelConfig()))
        state, loss = step(state, xt, yt, m)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert state.step == 1
        for k, v in state.model.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=2e-4)


def test_route_bits_all_maximal_phases():
    """Pool routing: every maximal phase of a window whose max is > 0, none
    where the max is 0; route_expand puts the gradient on exactly those."""
    r = torch.tensor([[[[1.0, 1.0], [0.5, 1.0]]], [[[0.0, 0.0], [0.0, 0.0]]]])
    p = torch.nn.functional.max_pool2d(r, 2)
    bits = ttk.route_bits(r, p)
    assert bits.tolist() == [[[[0b1011]]], [[[0]]]]
    g = ttk.route_expand(torch.tensor([[[[2.0]]], [[[3.0]]]]), bits)
    assert g.tolist() == [[[[2.0, 2.0], [0.0, 2.0]]], [[[0.0, 0.0], [0.0, 0.0]]]]


def test_cpu_runs_no_kernel(flagship):
    _, _, state, x, y = flagship
    before = [k.launches for k in KERNELS]
    ttk.kernel_loss_grad_sums(state.model, torch.from_numpy(x), torch.from_numpy(y),
                              torch.ones(2), torch.bfloat16)
    assert [k.launches for k in KERNELS] == before


def test_geometries_outside_the_family_raise():
    """(16, 32, 128)/k5 is in neither family: both steps raise; deep3 is
    not the depth-2 family's, and has no pre-cast step."""
    from specenh_torch.ops import ae3_train_kernel as ttk3

    deep3 = ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3, out_kernel=(5, 5))
    wide3 = ModelConfig(filters=(16, 32, 128), kernels=((5, 5),) * 3, out_kernel=(5, 5))
    for make in (ttk.make_kernel_train_step, ttk3.make_kernel_train_step3):
        with pytest.raises(NotImplementedError):
            make(wide3)
    with pytest.raises(NotImplementedError):
        ttk.make_kernel_train_step(deep3, depth=2)
    with pytest.raises(NotImplementedError):
        ttk.make_kernel_train_step(deep3, pre=True)
    wide = ModelConfig(filters=(16, 32))
    state = create_state(wide, TrainConfig(), device="cpu")
    with pytest.raises(NotImplementedError):
        ttk.kernel_loss_grad_sums(state.model, torch.zeros(1, 256, 128),
                                  torch.zeros(1, 256, 128), torch.ones(1))
