"""The port's depth-3 training (specenh_torch.ops.ae3_train_kernel, K7 on
the stage kernels) against the JAX package on the CPU, where every stage
wrapper runs its plain twin: gradients against jax.value_and_grad of the
Flax model in float32 (a small (16, 16, 16)/k3 geometry and the deep3
preset), the bf16 twins against the depth-3 Pallas training kernel in
interpret mode, a padded batch, the autograd Function, one Adam step and a
two-epoch ``fit``.  Inputs: tiles of (256, 128) from a numpy seed,
Flax-initialised weights converted to the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh import train as jtrain
from specenh.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops import ae3_train_kernel as jtk3
from specenh_torch import ModelConfig, TrainConfig
from specenh_torch import train as ttrain
from specenh_torch._build import KERNELS
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae3_train_kernel as ttk3

SMALL = dict(filters=(16, 16, 16), kernels=((3, 3),) * 3, out_kernel=(3, 3))
DEEP3 = dict(filters=(16, 32, 64), kernels=((5, 5),) * 3, out_kernel=(5, 5))


def _setup(kw, seed=0, n=2):
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    fm = flax_model(jcfg)
    params = fm.init(jax.random.PRNGKey(seed), np.zeros((1, *jcfg.input_shape), np.float32))
    state = ttrain.create_state(cfg, TrainConfig(), device="cpu")
    state.model.load_state_dict(state_dict_from_flax(params, cfg))
    rng = np.random.default_rng(2)
    x = rng.random((n, 256, 128, 1)).astype(np.float32)
    y = (rng.random((n, 256, 128, 1)) > 0.6).astype(np.float32)
    return fm, params, state, x, y


def _flax_value_and_grad(fm, params, x, y, mask):
    def loss_fn(p):
        return jtrain.bce_from_logits(fm.apply(p, x, logits=True), y, mask)

    return jax.value_and_grad(loss_fn)(params)


def _torch_grads(g, cfg):
    """A Flax gradient tree in the port's layout (the converter is linear)."""
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g), cfg)


def _tt(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def small():
    return _setup(SMALL)


@pytest.mark.parametrize("kw", [SMALL, DEEP3], ids=["small", "deep3"])
def test_f32_loss_and_grads_match_jax(kw):
    """The twins in float32 against autodiff of the Flax model: loss to
    rtol 1e-5 and every gradient within 2e-5 * max(scale, 1), the JAX
    depth-3 kernel's own bound (f32 sums in another order)."""
    fm, params, state, x, y = _setup(kw, seed=1)
    mask = np.ones(2, np.float32)
    ref_loss, ref_g = _flax_value_and_grad(fm, params, x, y, mask)
    loss, grads = ttk3.kernel_value_and_grad3(state.model, *_tt(x, y, mask),
                                              dtype=torch.float32)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    want = _torch_grads(ref_g, state.model.cfg)
    assert set(grads) == set(want)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert err < 2e-5 * max(scale, 1.0), (err, scale)


def test_bf16_twins_match_jax_kernel(small):
    """bf16 twins against the depth-3 Pallas training kernel in interpret
    mode: both round x, y, weights, stored activations and each dz to bf16
    at the same points, the float32 sums in other orders: within 1e-2 of
    the largest gradient, and the loss to 1e-4."""
    fm, params, state, x, y = small
    mask = np.ones(2, np.float32)
    jl, jg = jtk3.kernel_value_and_grad3(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        jtk3.build_train_maps3(JModelConfig(**SMALL)), interpret=True, dtype=jnp.bfloat16)
    loss, grads = ttk3.kernel_value_and_grad3(state.model, *_tt(x, y, mask),
                                              dtype=torch.bfloat16)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    want = _torch_grads(jg, state.model.cfg)
    scale = max(float(v.abs().max()) for v in want.values())
    err = max(float((grads[k] - want[k]).abs().max()) for k in want)
    assert err <= 1e-2 * scale, (err, scale)


def test_padded_batch_equals_one_tile(small):
    """A padded batch (mask 1, 0) gives the one-tile batch's loss and
    gradients (f32, rtol 2e-5 for the other summation order)."""
    _, _, state, x, y = small
    xt, yt = _tt(x, y)
    lp, gp = ttk3.kernel_value_and_grad3(state.model, xt, yt, torch.tensor([1.0, 0.0]),
                                         dtype=torch.float32)
    l1, g1 = ttk3.kernel_value_and_grad3(state.model, xt[:1], yt[:1], torch.ones(1),
                                         dtype=torch.float32)
    np.testing.assert_allclose(float(lp), float(l1), rtol=1e-6)
    for k in g1:
        torch.testing.assert_close(gp[k], g1[k], rtol=2e-5, atol=1e-8)


def test_autograd_function_writes_grads(small):
    """kernel_bce_sum3's backward writes the gradients kernel_value_and_grad3
    returns into .grad, scaled by the incoming gradient; the plain twin of
    the sums gives the same."""
    _, _, state, x, y = small
    xt, yt, m = *_tt(x, y), torch.ones(2)
    _, grads = ttk3.kernel_value_and_grad3(state.model, xt, yt, m, dtype=torch.float32)
    state.model.zero_grad()
    (ttk3.kernel_bce_sum3(state.model, xt, yt, m, torch.float32) / (2 * 256 * 128)).backward()
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.grad, grads[name], rtol=1e-6, atol=0)
    a = ttk3.kernel_loss_grad_sums3(state.model, xt, yt, m, torch.bfloat16)
    b = ttk3.kernel_loss_grad_sums3_plain(state.model, xt, yt, m, torch.bfloat16)
    assert float(a[0]) == float(b[0]) and all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def test_one_step_matches_jax(small):
    """make_kernel_train_step3(float32) matches the JAX train_step after one
    Adam step (Keras eps): atol 2e-4, the JAX kernel tests' bound."""
    fm, params, _, x, y = small
    mask = np.ones(2, np.float32)
    jstate, jloss = jtrain.train_step(
        jtrain.create_state(JModelConfig(**SMALL), JTrainConfig()).replace(params=params),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    want = state_dict_from_flax(jstate.params, ModelConfig(**SMALL))
    state = ttrain.create_state(ModelConfig(**SMALL), TrainConfig(), device="cpu")
    state.model.load_state_dict(state_dict_from_flax(params, ModelConfig(**SMALL)))
    state, loss = ttk3.make_kernel_train_step3(ModelConfig(**SMALL), torch.float32)(
        state, *_tt(x, y, mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == 1
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=2e-4)


def test_fit_trajectory_matches_jax():
    """Two shuffled epochs of ``fit`` on the depth-3 kernel engine (float32
    twins) against the JAX ``fit``, 3 training and 2 validation tiles at
    batch 2 (a padded last batch): loss and val_loss to rtol 1e-4 (f32
    sums in other orders, through 4 Adam steps)."""
    fm, params, _, x, y = _setup(SMALL, seed=4, n=5)
    y = np.clip(0.8 * x + 0.1, 0, 1).astype(np.float32)
    base = dict(batch_size=2, seed=3, shuffle=True)
    jtc, tc = JTrainConfig(**base), TrainConfig(**base)
    jst = jtrain.create_state(JModelConfig(**SMALL), jtc).replace(params=params)
    _, jh = jtrain.fit(jst, x[:3], y[:3], x[3:], y[3:], cfg=jtc, epochs=2)
    state = ttrain.create_state(ModelConfig(**SMALL), tc, device="cpu")
    state.model.load_state_dict(state_dict_from_flax(params, ModelConfig(**SMALL)))
    launches = [k.launches for k in KERNELS]
    state, th = ttrain.fit(state, x[:3], y[:3], x[3:], y[3:], cfg=tc, epochs=2,
                           epoch_fn=ttrain.kernel_epoch_for(ModelConfig(**SMALL), tc,
                                                            dtype=torch.float32))
    assert [k.launches for k in KERNELS] == launches
    assert state.step == 4 and th["new_epochs"] == 2
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    np.testing.assert_allclose(th["val_loss"], jh["val_loss"], rtol=1e-4)
