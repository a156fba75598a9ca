"""The Keras weight import (``specenh_torch.models.keras_import``, the
CLI's ``import-keras``) against TensorFlow and the JAX package on the CPU,
and ``utils.cv_probe`` against the port's baked OpenCV tables.

Keras models built here at depth 2 and 3 on (64, 32) tiles predict what the
port's module predicts on the imported weights (atol 1e-5, as
tests/test_models.py holds JAX's import); the port's route equals the JAX
route through ``models.convert.state_dict_from_flax`` bit for bit; bad
weight lists raise as JAX's; ``import-keras`` writes a model directory
that ``train.load_model`` serves, and exits naming TensorFlow where it is
missing."""

import json
import sys

import numpy as np
import pytest
import torch

from specenh.config import ModelConfig as JModelConfig
from specenh.models import keras_import as jki
from specenh_torch import cli as tcli
from specenh_torch import train as ttrain
from specenh_torch.models import keras_import as tki
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import enhance as tenhance

# depth -> (filters, kernels, out kernel)
GEOMETRIES = {2: ((8, 4), (3, 5), 3), 3: ((8, 4, 4), (3, 5, 3), 5)}


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _keras_model(tf, depth, input_shape=(64, 32, 1), seed=0):
    """The reference's autoencoder layout (hyperparam_scan.py:152-165) at
    ``depth``, its weights drawn from ``seed``."""
    from tensorflow.keras import layers
    from tensorflow.keras.models import Model

    tf.keras.utils.set_random_seed(seed)
    filters, kernels, out_k = GEOMETRIES[depth]
    inp = layers.Input(shape=input_shape)
    z = inp
    for f, k in zip(filters, kernels):
        z = layers.Conv2D(f, (k, k), activation="relu", padding="same")(z)
        z = layers.MaxPooling2D((2, 2), padding="same")(z)
    for f, k in zip(filters[::-1], kernels[::-1]):
        z = layers.Conv2DTranspose(f, (k, k), strides=2, activation="relu", padding="same")(z)
    z = layers.Conv2D(1, (out_k, out_k), activation="sigmoid", padding="same")(z)
    km = Model(inp, z)
    # non-zero biases, so their layout is checked too
    km.set_weights([w if w.ndim > 1 else np.random.default_rng(seed).normal(0, 0.1, w.shape)
                    .astype(np.float32) for w in km.get_weights()])
    return km


@pytest.mark.parametrize("depth", [2, 3])
def test_forward_parity_with_keras(tf, depth):
    """The imported weights predict Keras's probabilities within 1e-5; the
    config is JAX's; the state_dict equals JAX's import carried over by
    ``state_dict_from_flax`` bit for bit (no flip of its own)."""
    km = _keras_model(tf, depth)
    x = np.random.default_rng(0).standard_normal((2, 64, 32, 1)).astype(np.float32)
    want = km.predict(x, verbose=0)
    w = km.get_weights()
    cfg = tki.model_config_from_keras_weights(w, input_shape=(64, 32, 1))
    jcfg = jki.model_config_from_keras_weights(w, input_shape=(64, 32, 1))
    assert jcfg == JModelConfig(**{f: getattr(cfg, f) for f in
                                   ("filters", "kernels", "out_kernel", "input_shape")})
    filters, kernels, out_k = GEOMETRIES[depth]
    assert cfg.filters == filters and cfg.kernels == tuple((k, k) for k in kernels)
    sd = tki.params_from_keras_weights(w, cfg)
    via_jax = state_dict_from_flax(jki.params_from_keras_weights(w, jcfg), cfg)
    assert sorted(sd) == sorted(via_jax)
    for k in sd:
        assert torch.equal(sd[k], via_jax[k]), k
    model = make_model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_arrays,message", [(5, "expected alternating kernel/bias weights"),
                                              (4, "expected odd number of conv layers, got 2")])
def test_bad_weight_lists_raise_as_jax(n_arrays, message):
    w = [np.zeros((3, 3, 1, 4), np.float32), np.zeros(4, np.float32)] * 3
    for mod in (tki, jki):
        with pytest.raises(ValueError, match=f"^{message}$"):
            mod.model_config_from_keras_weights(w[:n_arrays])
    with pytest.raises(ValueError, match="^expected alternating kernel/bias weights$"):
        tki.params_from_keras_weights(w[:5], tki.model_config_from_keras_weights(w[:6]))


def test_import_keras_writes_a_model_the_port_serves(tf, tmp_path, capfd):
    """``import-keras`` on a saved Keras model of the tiles' full size: JAX's
    final line, ``model/`` with ``params.pt`` and ``model_config.json``;
    ``load_model`` on it predicts Keras's probabilities within 1e-5."""
    km = _keras_model(tf, 2, input_shape=(256, 128, 1), seed=1)
    path = str(tmp_path / "ref.keras")
    km.save(path)
    capfd.readouterr()
    tcli.main(["import-keras", "--saved-model", path, "--out-dir", str(tmp_path / "out")])
    line = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert line == {"filters": [8, 4], "kernels": [[3, 3], [5, 5]],
                    "out": str(tmp_path / "out" / "model")}
    state, cfg = ttrain.load_model(line["out"], device="cpu")
    assert cfg.input_shape == (256, 128, 1) and cfg.out_kernel == (3, 3)
    x = np.random.default_rng(2).random((2, 256, 128, 1)).astype(np.float32)
    np.testing.assert_allclose(ttrain.predict(state, x).numpy(), km.predict(x, verbose=0),
                               rtol=0, atol=1e-5)


def test_import_keras_without_tensorflow_exits(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(SystemExit, match="TensorFlow"):
        tcli.main(["import-keras", "--saved-model", str(tmp_path / "m.keras"),
                   "--out-dir", str(tmp_path)])


@pytest.mark.parametrize("ksize", [31, 3])
def test_cv_probe_recovers_the_baked_tables(ksize):
    """Probing this OpenCV build recovers the port's baked Q8.8 taps."""
    pytest.importorskip("cv2")
    from specenh_torch.utils.cv_probe import probe_gaussian_q88

    baked = {31: tenhance._CV_KX31_Q88, 3: tenhance._CV_K3_Q88}[ksize]
    assert tuple(probe_gaussian_q88(ksize).tolist()) == tuple(baked)
