"""``python -m specenh_torch.cli sweep`` against the JAX package's
``specenh sweep`` on the CPU: on a tiny store written by the port (2 shots x
2 channels x 6 tiles of 256 x 128, 24 tiles), a 2-config grid for one
epoch on each engine: the same artifacts (names, shapes, keys), the same
val losses (rtol 1e-4: float32, 2 Adam steps) and best config; the
stray-axis and streaming-flag exits word for word, ``--devices 2``
starting two ranks, and ``--stream always`` streaming."""

import json
import os

import numpy as np
import pytest

from specenh.cli import main as jmain
from specenh_torch.cli import main as tmain
from specenh_torch.io.store import SpectrogramStore

GRID = ["--grid", "2layer", "--ker1", "3", "--ker2", "3", "--ker3", "3",
        "--conv1", "8,16", "--conv2", "8"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "tiny.hdf5")
    rng = np.random.default_rng(0)
    with SpectrogramStore(path) as st:
        for shot in ("101", "102"):
            for chn in (1, 2):
                s = rng.random((256, 6 * 128 + 5)).astype(np.float32)
                st.write_channel(shot, chn, s, np.arange(256.0), np.arange(s.shape[1] * 1.0),
                                 np.clip(1.2 * s - 0.2, 0, 1))
    return path


def _run(main, store, out, capfd, *extra):
    main(["sweep", "--dataset", store, "--out-dir", str(out), *GRID, "--epochs", "1",
          "--quiet", *extra])
    return json.loads(capfd.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("engine", ["envelope", "kernel"])
def test_sweep_artifacts_match_jax(store, tmp_path, capfd, engine):
    """The envelope run times each config's predictor (pred_times); the
    serial run skips it (--no-time-configs: zeros in both packages)."""
    extra = ["--engine", engine] + (["--no-time-configs"] if engine == "kernel" else [])
    jline = _run(jmain, store, tmp_path / "j", capfd, *extra)
    tline = _run(tmain, store, tmp_path / "t", capfd, *extra, "--device", "cpu")
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["best_model", "best_val_loss.png", "loss_comparisons.npz", "val_losses.npy"]
    assert tline["best_index"] == jline["best_index"] and tline["n_configs"] == 2
    assert tline["best_val_loss"] == pytest.approx(jline["best_val_loss"], rel=1e-4)
    jv, tv = (np.load(tmp_path / d / "val_losses.npy") for d in ("j", "t"))
    assert tv.shape == jv.shape == (1, 1, 1, 2, 1)
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    with np.load(tmp_path / "j" / "loss_comparisons.npz") as j, \
            np.load(tmp_path / "t" / "loss_comparisons.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape, k
            if k.endswith("_loss"):
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4)
            elif engine == "kernel":
                assert (t[k] == 0).all() and (j[k] == 0).all(), k
            else:
                assert (t[k] > 0).all() and (j[k] > 0).all(), k
    for d in ("j", "t"):
        with open(tmp_path / d / "best_model" / "model_config.json") as fh:
            cfg = json.load(fh)
        assert cfg["filters"] == [8 * (1 + tline["best_index"]), 8], d


STRAY = {
    "kernel-grid-ker1": ["--grid", "kernel", "--ker1", "3"],
    "2layer-conv3": ["--grid", "2layer", "--conv3", "8", "--ker", "3"],
    "3layer-kernel-vals": ["--grid", "3layer", "--kernel-vals", "3"],
}


@pytest.mark.parametrize("case", sorted(STRAY))
def test_stray_axis_exits_match_jax(store, tmp_path, case):
    msgs = []
    for main in (jmain, tmain):
        with pytest.raises(SystemExit) as e:
            main(["sweep", "--dataset", store, "--out-dir", str(tmp_path), *STRAY[case]])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "not an axis of --grid" in msgs[0]


_STRAY = ("--chunk-tiles/--chunk-dtype/--tile-cache apply to the streamed sweep only; this "
          "grid is resident — use --stream always to force streaming")
_ENVELOPE = ("this sweep's dataset exceeds the resident budget (or --stream always was given): "
             "streamed sweeps run per-config on the serial engine — add --engine kernel (the "
             "vmapped envelope needs the resident dataset)")
# case -> (flags, the exit's message, or "streams": the sweep streams)
UNPORTED = {
    "devices": (["--devices", "2"], "launches"),
    "stream-always": (["--stream", "always", "--engine", "kernel"], "streams"),
    "chunk-tiles": (["--chunk-tiles", "64"], _STRAY),
    "chunk-dtype": (["--chunk-dtype", "bf16"], _STRAY),
    "tile-cache": (["--tile-cache", "tc"], _STRAY),
    "auto-over-budget": ([], _ENVELOPE),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_flags_exit(store, tmp_path, monkeypatch, capfd, case):
    """``--devices 2`` starts two ranks of the command (recorded here; the
    ranks sweep in ``tests/test_torch_mesh_train.py``).  The streaming
    flags of a resident grid, and a grid over the resident budget on the
    envelope engine, exit with JAX's words.  ``--stream always --engine
    kernel`` streams each config and writes the artifacts, pred_times
    timed on one 30-tile tune chunk."""
    flags, message = UNPORTED[case]
    if case == "auto-over-budget":
        monkeypatch.setenv("SPECENH_HBM_BUDGET_GB", "0.001")
    argv = ["sweep", "--dataset", store, "--out-dir", str(tmp_path), *GRID, *flags]
    if message == "streams":
        line = _run(tmain, store, tmp_path, capfd, *flags, "--device", "cpu")
        assert line["n_configs"] == 2 and np.isfinite(line["best_val_loss"])
        with np.load(tmp_path / "loss_comparisons.npz") as lc:
            assert (lc["conv1_time"] > 0).all()
        return
    if message == "launches":
        from specenh_torch import cli as tcli

        started = []
        monkeypatch.setattr(tcli, "_launch_workers", lambda a, n: started.append((a, n)))
        tmain([*argv, "--device", "cpu"])
        assert started == [([*argv, "--device", "cpu"], 2)]
        assert os.listdir(tmp_path) == []
    else:
        for main, extra in ((tmain, ["--device", "cpu"]), (jmain, [])):
            with pytest.raises(SystemExit) as e:
                main([*argv, *extra])
            assert str(e.value) == message
    assert not os.path.exists(tmp_path / "val_losses.npy")
