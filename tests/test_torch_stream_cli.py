"""``train --stream always`` and ``sweep --stream always`` of the port's CLI
in process on the CPU, against the JAX package's commands on the same
store: 2 shots x 2 channels of (256, 3 x 128 + 5), 12 tiles (7 train, 3
tune, 2 test); a narrow (4, 4)/k3 preset from JAX's initial weights for
``train``, and a 2-config 2layer grid ((4, 4) and (8, 4) at k3) for ``sweep``.

- The same artifacts, the same metric keys (``"streamed"`` and
  ``"devices"`` on every line of ``metrics.jsonl``), val losses within rtol
  1e-4 (float32 sums in other orders through 2 Adam steps).
- ``--chunk-dtype bf16 --tile-cache``: the JAX package builds the test and
  bench tile caches, which feed ``t_pred.txt`` and the figures, in bf16;
  the port builds them in float32, whose tiles are the store's exactly.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import threadpoolctl
import torch

import specenh.cli as jcli
from specenh import train as jtrain
from specenh.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from specenh_torch import cli as tcli
from specenh_torch import train as ttrain
from specenh_torch.data.tilecache import TileCacheReader
from specenh_torch.io.store import SpectrogramStore
from specenh_torch.models.convert import state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream_cli") / "s.hdf5")
    rng = np.random.default_rng(0)
    with SpectrogramStore(path) as st:
        for shot in ("101", "102"):
            for chn in (1, 2):
                s = rng.random((256, 3 * 128 + 5)).astype(np.float32)
                st.write_channel(shot, chn, s, np.arange(256.0), np.arange(s.shape[1] * 1.0),
                                 np.clip(1.2 * s - 0.2, 0, 1))
    return path


NARROW = dict(filters=(4, 4), kernels=((3, 3), (3, 3)), out_kernel=(3, 3))


@pytest.fixture
def narrow(monkeypatch):
    """A 'narrow' preset in both CLIs; the port's ``create_state`` starts
    from the weights JAX's draws for it."""
    monkeypatch.setitem(jcli.MODEL_PRESETS, "narrow", JModelConfig(**NARROW))
    monkeypatch.setitem(tcli.MODEL_PRESETS, "narrow", tcli.ModelConfig(**NARROW))
    params = jtrain.create_state(JModelConfig(**NARROW), JTrainConfig(epochs=1)).params
    create_state = ttrain.create_state

    def from_jax(mc, tcfg, **kw):
        state = create_state(mc, tcfg, **kw)
        state.model.load_state_dict(state_dict_from_flax(params, mc))
        return state

    monkeypatch.setattr(ttrain, "create_state", from_jax)


def _run(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _metrics(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh]


@pytest.mark.parametrize("case", ["f32", "bf16-tile-cache"])
def test_train_stream_always_matches_jax(store, tmp_path, narrow, case):
    """The streamed run's artifacts, metric keys and val loss are JAX's;
    with bf16 chunks and a tile cache, the train and tune caches are bf16
    in both, the test and bench caches float32 in the port (bf16 in JAX),
    the bench tiles the store's bit for bit."""
    extra = [] if case == "f32" else ["--chunk-dtype", "bf16", "--tile-cache"]
    lines = {}
    for tag, main, dev in (("t", tcli.main, ["--device", "cpu"]), ("j", jcli.main, [])):
        tail = [str(tmp_path / f"tc_{tag}")] if extra else []
        lines[tag] = _run(main, ["train", "--dataset", store, "--out-dir", str(tmp_path / tag),
                                 "--model", "narrow", "--epochs", "2", "--num-shots", "2",
                                 "--stream", "always", "--quiet", *extra, *tail, *dev])
    assert sorted(lines["t"]) == sorted(lines["j"]) == ["t_pred", "val_loss"]
    assert lines["t"]["val_loss"] == pytest.approx(lines["j"]["val_loss"], rel=1e-4)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["metrics.jsonl", "model", "t_pred.txt", "val_loss.png", "val_loss.txt"]
    tm, jm = (_metrics(tmp_path / tag / "metrics.jsonl") for tag in ("t", "j"))
    assert [sorted(m) for m in tm] == [sorted(m) for m in jm] and len(tm) == 2
    assert all(m["streamed"] is True and m["devices"] == 1 for m in tm)
    np.testing.assert_allclose([m["loss"] for m in tm], [m["loss"] for m in jm], rtol=1e-4)
    if case == "f32":
        return
    dtypes = {}
    for tag in ("t", "j"):
        for split in ("train", "tune", "test", "bench"):
            with open(tmp_path / f"tc_{tag}.{split}.json") as fh:
                dtypes[tag, split] = json.load(fh)["dtype"]
    assert [dtypes["j", s] for s in ("train", "tune", "test", "bench")] == ["bf16"] * 4
    assert [dtypes["t", s] for s in ("train", "tune", "test", "bench")] == \
        ["bf16", "bf16", "f32", "f32"]
    bench = TileCacheReader(str(tmp_path / "tc_t.bench.tiles"))
    with SpectrogramStore(store, "r") as st:
        shot = st.shots()[0]
        want = np.concatenate([st.read_channel(shot, c)["spec"][:, :384].reshape(256, 3, 128)
                               .transpose(1, 0, 2) for c in st.channels_of(shot)])
    np.testing.assert_array_equal(bench.read_x(0, bench.n)[..., 0], want)


GRID = ["--grid", "2layer", "--ker1", "3", "--ker2", "3", "--ker3", "3",
        "--conv1", "4,8", "--conv2", "4"]


def test_sweep_stream_always_matches_jax(store, tmp_path):
    """``sweep --stream always --engine kernel`` (each config through
    ``fit_streaming``; these geometries on the module engine): JAX's
    artifacts, val losses within rtol 1e-4, the same best config.  The
    port times each config's predictor on one 30-tile tune chunk; JAX's
    run skips it (``--no-time-configs``: its compiles dominate a CPU
    test), its times are zeros."""
    lines = {}
    for tag, main, extra in (("t", tcli.main, ["--device", "cpu"]),
                             ("j", jcli.main, ["--no-time-configs"])):
        lines[tag] = _run(main, ["sweep", "--dataset", store, "--out-dir", str(tmp_path / tag),
                                 *GRID, "--epochs", "1", "--num-shots", "2", "--stream",
                                 "always", "--engine", "kernel", "--quiet", *extra])
    assert lines["t"]["best_index"] == lines["j"]["best_index"]
    assert lines["t"]["best_val_loss"] == pytest.approx(lines["j"]["best_val_loss"], rel=1e-4)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["best_model", "best_val_loss.png", "loss_comparisons.npz", "val_losses.npy"]
    np.testing.assert_allclose(np.load(tmp_path / "t" / "val_losses.npy"),
                               np.load(tmp_path / "j" / "val_losses.npy"), rtol=1e-4)
    with np.load(tmp_path / "j" / "loss_comparisons.npz") as j, \
            np.load(tmp_path / "t" / "loss_comparisons.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            assert t[k].shape == j[k].shape, k
            if k.endswith("_loss"):
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4)
            else:
                assert (t[k] > 0).all() and (j[k] == 0).all(), k
