"""The raw-to-model path (``specenh_torch.e2e``) and the ``train-raw``,
``synth-shots``, ``convert-bin``, ``denoise`` and ``crosspower`` commands
against the JAX package's on the CPU, on the same numpy-seeded inputs:

- ``train_from_raw`` (float32 autograd, 2 channels of 0.2 s, 1 epoch)
  against JAX's ``train_from_raw``: the epoch's loss and val loss within
  rtol 1e-4 (the fronts differ in the last float32 bits: K1's twin against
  XLA's matmul spectrogram); the split arithmetic and its ``ValueError``s;
- the CLI in process with ``--device cpu``: the same shots, binaries,
  artifacts, shapes and final JSON lines as JAX's commands (``train-raw``
  in float32 beside JAX's, ``--engine kernel`` on 2 training tiles, which
  runs the kernels' plain twins here), and the exits of what is not
  ported or not covered."""

import dataclasses
import json
import os

import numpy as np
import pytest
import threadpoolctl
import torch

from specenh import e2e as je2e
from specenh import train as jtrain
from specenh.cli import main as jmain
from specenh.config import Config as JConfig, ModelConfig as JModelConfig
from specenh.config import SpecParams as JSpecParams, TrainConfig as JTrainConfig
from specenh_torch import cli as tcli
from specenh_torch import e2e
from specenh_torch.config import Config, ModelConfig, SpecParams, TrainConfig
from specenh_torch.io.store import SpectrogramStore
from specenh_torch.models.convert import state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS/LAPACK thread in this module: the suite runs a
    worker per core, and these small factorisations and convolutions slow
    ten-fold when every worker's thread pools spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


SP = SpecParams(cut_shot=0.2)  # 389 frames: 3 tiles a trace


def _traces(n_ch, sp=SP):
    rng = np.random.default_rng(0)
    t = np.arange(sp.n_samples) / sp.fs
    return np.stack([np.sin(2 * np.pi * (5e4 + 2e4 * t) * t + k)
                     + 0.5 * rng.standard_normal(t.size) for k in range(n_ch)]).astype(np.float32)


def _jax_initial_weights(monkeypatch, model_cfg, **tc):
    """The port's ``create_state`` in ``e2e`` starts from the weights JAX's
    ``create_state`` draws (jax.random) for the same configuration."""
    params = jtrain.create_state(JModelConfig(**dataclasses.asdict(model_cfg)),
                                 JTrainConfig(**tc)).params
    create_state = e2e.create_state

    def from_jax(mc, tcfg, **kw):
        state = create_state(mc, tcfg, **kw)
        state.model.load_state_dict(state_dict_from_flax(params, mc))
        return state

    monkeypatch.setattr(e2e, "create_state", from_jax)


def test_train_from_raw_matches_jax(monkeypatch):
    """One float32 epoch on 2 channels (6 tiles, 3 trained, 2 validated)
    from JAX's initial weights: the same shuffle, split and Adam, so the
    same losses."""
    traces = _traces(2)
    tc = dict(epochs=1, batch_size=2)
    _jax_initial_weights(monkeypatch, ModelConfig(), **tc)
    _, hist = e2e.train_from_raw(traces, Config(spec=SP), ModelConfig(), TrainConfig(**tc),
                                 device="cpu")
    _, jhist = je2e.train_from_raw(traces, JConfig(spec=JSpecParams(cut_shot=0.2)),
                                   JModelConfig(), JTrainConfig(**tc))
    assert len(hist["loss"]) == len(hist["val_loss"]) == 1
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    np.testing.assert_allclose(hist["val_loss"], jhist["val_loss"], rtol=1e-4)


def test_prepare_tiles_matches_jax_layout():
    """(C * k, 256, 128, 1) channel-major tile pairs, as JAX's."""
    x, y = e2e.prepare_tiles_on_device(_traces(2), Config(spec=SP), device="cpu")
    jx, jy = je2e.prepare_tiles_on_device(_traces(2), JConfig(spec=JSpecParams(cut_shot=0.2)))
    assert tuple(x.shape) == tuple(y.shape) == jx.shape == jy.shape == (6, 256, 128, 1)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)


@pytest.mark.parametrize("n_ch,cps,split_by", [(3, 1, "tile"), (3, 1, "shot"), (10, 2, "shot")])
def test_split_matches_jax(monkeypatch, n_ch, cps, split_by):
    """The train and tune tile counts of JAX's split arithmetic, for the
    leaky tile split and the shot split with 1 and 2 channels a shot."""
    counts = {}

    def fake_fit(key):
        def fit(state, xt, yt, xv, yv, *a, **k):
            counts[key] = (xt.shape[0], xv.shape[0])
            return state, {"val_loss": [0.0]}
        return fit

    monkeypatch.setattr(e2e, "fit", fake_fit("torch"))
    monkeypatch.setattr(je2e, "fit", fake_fit("jax"))
    traces = _traces(n_ch)
    e2e.train_from_raw(traces, Config(spec=SP), ModelConfig(), TrainConfig(split_by=split_by),
                       channels_per_shot=cps, device="cpu")
    je2e.train_from_raw(traces, JConfig(spec=JSpecParams(cut_shot=0.2)), JModelConfig(),
                        JTrainConfig(split_by=split_by), channels_per_shot=cps)
    assert counts["torch"] == counts["jax"]
    assert counts["torch"] == {(3, "tile"): (5, 2), (3, "shot"): (3, 3),
                               (10, "shot"): (18, 6)}[(n_ch, split_by)]


@pytest.mark.parametrize("n_ch,cps,match", [(9, 2, "group into shots"),
                                            (2, 1, "too few for a shot-level")])
def test_shot_split_errors_match_jax(n_ch, cps, match):
    traces = _traces(n_ch)
    for fn, cfg, mc, tc in ((e2e.train_from_raw, Config(spec=SP), ModelConfig(),
                             TrainConfig(split_by="shot")),
                            (je2e.train_from_raw, JConfig(spec=JSpecParams(cut_shot=0.2)),
                             JModelConfig(), JTrainConfig(split_by="shot"))):
        kw = {"device": "cpu"} if fn is e2e.train_from_raw else {}
        with pytest.raises(ValueError, match=match):
            fn(traces, cfg, mc, tc, channels_per_shot=cps, **kw)


# ---------------------------------------------------------------------------
# the CLI, in process
# ---------------------------------------------------------------------------


def _last_json(capfd):
    return json.loads(capfd.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def shots(tmp_path_factory):
    """2 shots x 2 channels x 50 000 samples from each package's
    synth-shots, and each one's SPEC binaries."""
    d = tmp_path_factory.mktemp("raw")
    for tag, main in (("t", tcli.main), ("j", jmain)):
        main(["synth-shots", "--out", str(d / tag / "raw"), "--shots", "2", "--channels", "2",
              "--samples", "50000", "--seed", "1"])
        main(["convert-bin", "--data-dir", str(d / tag / "raw"), "--out-dir",
              str(d / tag / "bin"), "--channels", "2"])
    return d


def test_synth_shots_and_convert_bin_match_jax(shots):
    """The same files, pickled arrays and SPEC binaries, byte for byte."""
    import pickle

    for sub in ("raw", "bin"):
        names = sorted(os.listdir(shots / "t" / sub))
        assert names == sorted(os.listdir(shots / "j" / sub)) and len(names) == 2
        for name in names:
            a, b = ((shots / tag / sub / name).read_bytes() for tag in ("t", "j"))
            if sub == "bin":
                assert a == b, name
            else:
                pa, pb = pickle.loads(a), pickle.loads(b)
                assert sorted(pa) == sorted(pb)
                for k in pa:
                    np.testing.assert_array_equal(pa[k], pb[k])


RAW_ARGS = ["--channels", "2", "--cut-shot", "0.1", "--epochs", "1", "--quiet"]


def test_train_raw_matches_jax(shots, tmp_path, capfd, monkeypatch):
    """float32 from the pickles, from JAX's initial weights: 4 tiles (one a
    trace), the same val loss (rtol 1e-4) and JSON keys; the model
    directory."""
    _jax_initial_weights(monkeypatch, tcli.MODEL_PRESETS["scan_k3"], epochs=1)
    jmain(["train-raw", "--data-dir", str(shots / "j" / "raw"), "--out-dir",
           str(tmp_path / "j"), *RAW_ARGS])
    jline = _last_json(capfd)
    tcli.main(["train-raw", "--data-dir", str(shots / "t" / "raw"), "--out-dir",
               str(tmp_path / "t"), *RAW_ARGS, "--device", "cpu"])
    tline = _last_json(capfd)
    assert sorted(tline) == sorted(jline) == ["channels", "val_loss"]
    assert tline["channels"] == jline["channels"] == 4
    assert tline["val_loss"] == pytest.approx(jline["val_loss"], rel=1e-4)
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") == ["model"]
    assert sorted(os.listdir(tmp_path / "t" / "model")) == ["model_config.json", "params.pt"]


def test_train_raw_kernel_engine_from_binaries(shots, tmp_path, capfd):
    """--binary --engine kernel: the training kernels' path (their twins on
    the CPU) on 2 training tiles and 1 validation tile."""
    tcli.main(["train-raw", "--binary", "--data-dir", str(shots / "t" / "bin"), "--out-dir",
               str(tmp_path), *RAW_ARGS, "--engine", "kernel", "--device", "cpu"])
    line = _last_json(capfd)
    assert line["channels"] == 4 and np.isfinite(line["val_loss"])
    assert os.path.isdir(tmp_path / "model")


def test_train_raw_exits(shots, tmp_path, monkeypatch):
    """--devices 2 no longer exits: it starts two ranks of itself (recorded
    here; the ranks train in ``tests/test_torch_mesh_train.py``); --engine
    kernel on a geometry no kernel family covers exits with JAX's message;
    --device cuda where there is no card exits."""
    data = ["--data-dir", str(shots / "t" / "raw"), "--out-dir", str(tmp_path)]
    started = []
    monkeypatch.setattr(tcli, "_launch_workers", lambda a, n: started.append((a, n)))
    argv = ["train-raw", *data, "--devices", "2", "--device", "cpu"]
    tcli.main(argv)
    assert started == [(argv, 2)] and os.listdir(tmp_path) == []
    monkeypatch.setitem(tcli.MODEL_PRESETS, "narrow",
                        ModelConfig(filters=(8, 8), kernels=((3, 3), (3, 3)), out_kernel=(3, 3)))
    with pytest.raises(SystemExit, match="--engine kernel does not support the 'narrow' "
                                         "geometry; use f32/bf16"):
        tcli.main(["train-raw", *data, "--model", "narrow", "--engine", "kernel",
                   "--device", "cpu"])
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main(["train-raw", *data, *RAW_ARGS])


def test_denoise_matches_jax(tmp_path, capfd):
    """On a tiny store written by the port: svd_denoised.npy within 1e-4
    of JAX's (the default band, both on the subspace path),
    svd_compare.png, the same JSON line."""
    rng = np.random.default_rng(0)
    store = str(tmp_path / "s.hdf5")
    with SpectrogramStore(store) as st:
        for chn in (1, 2):
            spec = rng.random((256, 300)).astype(np.float32)
            st.write_channel("101", chn, spec, np.arange(256.0), np.arange(300.0),
                             np.clip(1.2 * spec - 0.2, 0, 1))
    jmain(["denoise", "--dataset", store, "--out-dir", str(tmp_path / "j"), "--channel", "2"])
    jline = _last_json(capfd)
    tcli.main(["denoise", "--dataset", store, "--out-dir", str(tmp_path / "t"), "--channel",
               "2", "--device", "cpu"])
    assert _last_json(capfd) == jline == {"shot": "ece_101", "channel": 2}
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["svd_compare.png", "svd_denoised.npy"]
    got, want = (np.load(tmp_path / d / "svd_denoised.npy") for d in ("t", "j"))
    assert got.shape == want.shape == (256, 300) and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_crosspower_matches_jax(tmp_path, capfd):
    """From .npy chords at the default 1.667 MHz: ampsp.npy within rtol
    1e-4 of the largest value of JAX's, crosspower.png, the same JSON
    keys and shape."""
    rng = np.random.default_rng(4)
    t = np.arange(20_000) / 1.667e6
    mode = np.sin(2 * np.pi * 1.5e5 * t)
    for i, a in enumerate((mode, 0.5 * mode)):
        np.save(tmp_path / f"s{i}.npy", (a + rng.standard_normal(t.size)).astype(np.float32))
    args = ["crosspower", "--signal1", str(tmp_path / "s0.npy"), "--signal2",
            str(tmp_path / "s1.npy")]
    jmain([*args, "--out-dir", str(tmp_path / "j")])
    jline = _last_json(capfd)
    tcli.main([*args, "--out-dir", str(tmp_path / "t"), "--device", "cpu"])
    tline = _last_json(capfd)
    assert sorted(tline) == sorted(jline) == ["ampsp", "plot"]
    assert tline["ampsp"] == jline["ampsp"] == [38, 513]
    assert tline["plot"] == str(tmp_path / "t" / "crosspower.png")
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["ampsp.npy", "crosspower.png"]
    got, want = (np.load(tmp_path / d / "ampsp.npy") for d in ("t", "j"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
