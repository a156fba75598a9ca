"""The port's training loop and dataset (specenh_torch.train,
specenh_torch.data.dataset) against the JAX package on the CPU: two-epoch
``fit`` trajectories on both engines, checkpoint and resume, early
stopping, the files ``fit`` writes, the run-meta guard, predict and
save/load, and the dataset helpers.  Inputs: 3 training and 2 validation
tiles from a numpy seed, batch 2 (so the last batch is padded), the same
Flax-initialised weights in both packages."""

import json

import numpy as np
import pytest
import torch

import jax

from specenh.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from specenh.data import dataset as jds
from specenh.models.autoencoder import make_model as flax_model
from specenh import train as jtrain
from specenh_torch import ModelConfig, TrainConfig
from specenh_torch import train as ttrain
from specenh_torch.data import dataset as tds
from specenh_torch.models.convert import state_dict_from_flax

CFG = ModelConfig()


@pytest.fixture(scope="module")
def data():
    params = flax_model(JModelConfig()).init(
        jax.random.PRNGKey(0), np.zeros((1, 256, 128, 1), np.float32))
    rng = np.random.default_rng(4)
    x = rng.random((5, 256, 128, 1)).astype(np.float32)
    y = np.clip(0.8 * x + 0.1 * rng.random(x.shape), 0, 1).astype(np.float32)
    return params, x[:3], y[:3], x[3:], y[3:]


def _tc(**kw):
    base = dict(batch_size=2, seed=3, shuffle=True)
    base.update(kw)
    return JTrainConfig(**base), TrainConfig(**base)


def _jfit(params, data_, jtc, **kw):
    st = jtrain.create_state(JModelConfig(), jtc).replace(params=params)
    _, x, y, xv, yv = data_
    return jtrain.fit(st, x, y, xv, yv, cfg=jtc, **kw)[1]


def _tstate(params, tc):
    st = ttrain.create_state(CFG, tc, device="cpu")
    st.model.load_state_dict(state_dict_from_flax(params, CFG))
    return st


def _tfit(params, data_, tc, **kw):
    _, x, y, xv, yv = data_
    return ttrain.fit(_tstate(params, tc), x, y, xv, yv, cfg=tc, **kw)


@pytest.fixture(scope="module")
def jax_history(data):
    return _jfit(data[0], data, _tc()[0], epochs=2)


@pytest.mark.parametrize("engine", ["autograd", "kernel-f32"])
def test_fit_trajectory_matches_jax(data, jax_history, engine):
    """Two shuffled epochs with a padded last batch and validation: the
    same batch order (the numpy shuffle stream) and the same Adam, so loss
    and val_loss agree to rtol 1e-4 (f32 sums in other orders, through 4
    Adam steps)."""
    _, tc = _tc()
    epoch_fn = (ttrain.kernel_epoch_for(CFG, tc, dtype=torch.float32)
                if engine == "kernel-f32" else None)
    _, hist = _tfit(data[0], data, tc, epochs=2, epoch_fn=epoch_fn)
    np.testing.assert_allclose(hist["loss"], jax_history["loss"], rtol=1e-4)
    np.testing.assert_allclose(hist["val_loss"], jax_history["val_loss"], rtol=1e-4)
    assert hist["new_epochs"] == 2


def test_resume_equals_uninterrupted(data, jax_history, tmp_path):
    """One epoch, checkpoint, then a resumed fit to two epochs: the same
    history as the uninterrupted run (bit for bit in the port; against JAX
    to rtol 1e-4), with the shuffle stream replayed."""
    _, tc = _tc()
    _, full = _tfit(data[0], data, tc, epochs=2)
    ck = str(tmp_path / "ck")
    _tfit(data[0], data, tc, epochs=1, checkpoint_dir=ck)
    assert ttrain.latest_checkpoint_epoch(ck) == 0
    state, resumed = _tfit(data[0], data, tc, epochs=2, checkpoint_dir=ck, resume=True)
    assert resumed["loss"] == full["loss"] and resumed["val_loss"] == full["val_loss"]
    assert resumed["new_epochs"] == 1 and state.step == 4
    np.testing.assert_allclose(resumed["loss"], jax_history["loss"], rtol=1e-4)
    _, again = _tfit(data[0], data, tc, epochs=2, checkpoint_dir=ck, resume=True)
    assert again["new_epochs"] == 0 and again["loss"] == full["loss"]


def test_patience_stops_where_jax_stops(data):
    """Validation on flipped labels worsens as training improves, so
    val_loss goes stale from the second epoch: patience 2 stops both
    packages at the same epoch with the same stopped_epoch."""
    jtc, tc = _tc(patience=2)
    params, x, y, xv, yv = data
    flipped = (data[0], x, y, xv, 1.0 - yv)
    jh = _jfit(params, flipped, jtc, epochs=6)
    _, th = _tfit(params, flipped, tc, epochs=6)
    assert th["stopped_epoch"] == jh["stopped_epoch"] == 2
    assert len(th["loss"]) == len(jh["loss"]) == 3
    np.testing.assert_allclose(th["val_loss"], jh["val_loss"], rtol=1e-4)


def test_files_and_run_meta_match_jax(data, tmp_path):
    """metrics.jsonl, history.json and run_meta.json carry the JAX
    package's keys; both packages refuse to resume with another seed."""
    jtc, tc = _tc()
    for pkg, fit in (("jax", lambda **kw: _jfit(data[0], data, jtc, **kw)),
                     ("torch", lambda **kw: _tfit(data[0], data, tc, **kw))):
        d = tmp_path / pkg
        d.mkdir()
        fit(epochs=1, checkpoint_dir=str(d / "ck"), metrics_path=str(d / "m.jsonl"))
    keys = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        with open(d / "m.jsonl") as fh:
            rows = [json.loads(line) for line in fh]
        with open(d / "ck" / "history.json") as fh:
            hist = json.load(fh)
        with open(d / "ck" / "run_meta.json") as fh:
            meta = json.load(fh)
        keys[pkg] = (len(rows), set(rows[0]), set(hist), meta)
    assert keys["jax"] == keys["torch"]
    meta = dict(keys["torch"][3], seed=4)
    for check in (jtrain.check_run_meta, ttrain.check_run_meta):
        for pkg in ("jax", "torch"):
            with pytest.raises(ValueError):
                check(str(tmp_path / pkg / "ck"), meta)
    with pytest.raises(ValueError):
        _tfit(data[0], data, TrainConfig(batch_size=2, seed=4), epochs=2,
              checkpoint_dir=str(tmp_path / "torch" / "ck"), resume=True)


def test_predict_save_load_and_layout(data, tmp_path):
    """predict gives the Flax model's probabilities in the JAX layout
    (B, 256, 128, 1) (f32 convs in other orders: atol 1e-5); save_model /
    load_model round-trip the weights and model_config.json as JAX writes
    it."""
    params, x, _, _, _ = data
    state = _tstate(params, TrainConfig())
    got = ttrain.predict(state, x, bs=2)
    want = np.asarray(flax_model(JModelConfig()).apply(params, x))
    assert got.shape == want.shape == (3, 256, 128, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    logits = state.model(torch.from_numpy(x[..., 0]), logits=True)
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(flax_model(JModelConfig()).apply(params, x, logits=True))[..., 0],
        rtol=0, atol=1e-5)
    ttrain.save_model(state, str(tmp_path / "m"), CFG)
    loaded, cfg = ttrain.load_model(str(tmp_path / "m"), device="cpu")
    assert cfg == CFG
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, loaded.model.state_dict()[k])
    with open(tmp_path / "m" / "model_config.json") as fh:
        assert json.load(fh) == {"filters": [32, 32], "kernels": [[3, 3], [3, 3]],
                                 "out_kernel": [3, 3], "input_shape": [256, 128, 1]}


def test_kernel_epoch_for_depth3_raises():
    """deep3 trains on K7; a depth-3 geometry outside the family (128
    filters) raises, and so does deep3 with the pre-cast layout, which the
    JAX package's depth-3 kernel does not have."""
    deep3 = ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3, out_kernel=(5, 5))
    assert callable(ttrain.kernel_epoch_for(deep3, TrainConfig()))
    with pytest.raises(NotImplementedError):
        ttrain.kernel_epoch_for(ModelConfig(filters=(16, 32, 128), kernels=((5, 5),) * 3,
                                            out_kernel=(5, 5)), TrainConfig())
    with pytest.raises(NotImplementedError):
        ttrain.kernel_epoch_for(deep3, TrainConfig(), pre_layout=True)


def test_batches_and_epoch_mean_match_jax():
    perm = np.random.default_rng(0).permutation(7)
    ji, jm = jtrain._epoch_batches(7, 3, perm)
    ti, tm = ttrain._epoch_batches(7, 3, perm)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jm, tm)
    losses = np.array([0.5, 0.25, 1.0], np.float32)
    assert float(ttrain.weighted_epoch_mean(torch.from_numpy(losses), tm)) == \
        pytest.approx(float(jtrain.weighted_epoch_mean(losses, jm)), rel=1e-7)


def test_dataset_matches_jax():
    """split_tiles, _patch_host and synthetic_shot_batch: exactly the JAX
    package's numbers (the same numpy code and stream)."""
    shots = tds.synthetic_shot_batch(2, 3, n_samples=40_000, seed=5)
    np.testing.assert_array_equal(shots, jds.synthetic_shot_batch(2, 3, n_samples=40_000, seed=5))
    specs = np.random.default_rng(1).random((3, 256, 400)).astype(np.float32)
    tiles = tds._patch_host(specs)
    np.testing.assert_array_equal(tiles, jds._patch_host(specs))
    assert tiles.shape == (9, 256, 128)
    labels = tiles * 0.5
    a, b = tds.split_tiles(tiles, labels), jds.split_tiles(tiles, labels)
    for f in ("x_train", "x_tune", "x_test", "y_train", "y_tune", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(getattr(a.reshaped(), f), getattr(b.reshaped(), f))
    assert [len(a.x_train), len(a.x_tune), len(a.x_test)] == [5, 2, 2]
