"""The store commands of the port's CLI (``build-data``, ``merge-shards``,
``train``, ``serve``, ``movie``) in process with ``--device cpu``, against
the JAX package's commands on the same shots, on the JAX CLI tests'
workspace: 2 shots x 2 channels x 50 000 samples, ``--cut-shot 0.1`` (one
tile a channel).

- ``build-data``: the same summaries; the stores' specs within 1e-4, their
  labels as the label pipeline's comparison allows (the row-mean ulp,
  ``_labels_match_jax``); over SPEC binaries with 2 writers, and the
  shards merged by either package's ``merge-shards`` to the same store;
- ``train`` in float32 from JAX's initial weights: val loss within rtol
  1e-4 of JAX's, the same artifacts; the kernel engine (its plain twins
  here), ``--trace-dir``, ``--resume``;
- ``serve --once`` and ``movie``: JAX's counts, frames and JSON keys; the
  untrained-model warning word for word;
- every exit of JAX's own checks, word for word; ``--stream always`` and
  ``--stream auto`` over the resident budget train streamed, and with
  ``--devices 2`` start two ranks."""

import contextlib
import dataclasses
import glob
import io
import json
import os
import re

import numpy as np
import pytest
import threadpoolctl
import torch

from specenh import train as jtrain
from specenh.cli import main as jmain
from specenh.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from specenh_torch import cli as tcli
from specenh_torch import train as ttrain
from specenh_torch.io.store import SpectrogramStore
from specenh_torch.models.convert import state_dict_from_flax
from tests.test_torch_pipeline import _labels_match_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS thread in this module: the suite runs a worker
    per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


CPU = ["--device", "cpu"]
SHAPE = ["--channels", "2", "--cut-shot", "0.1"]


def _last_json(capfd):
    return json.loads(capfd.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The raw pickles (synth-shots seed 1), their SPEC binaries plus a
    third shot's (seed 3, which the writer pool routes to the other
    shard), the port's store of the pickles and JAX's."""
    d = tmp_path_factory.mktemp("cli_store")
    tcli.main(["synth-shots", "--out", str(d / "raw"), "--shots", "2", "--channels", "2",
               "--samples", "50000", "--seed", "1"])
    tcli.main(["synth-shots", "--out", str(d / "raw3"), "--shots", "1", "--channels", "2",
               "--samples", "50000", "--seed", "3"])
    for raw in ("raw", "raw3"):
        tcli.main(["convert-bin", "--data-dir", str(d / raw), "--out-dir", str(d / "bin"),
                   "--channels", "2"])
    tcli.main(["build-data", "--data-dir", str(d / "raw"), "--out", str(d / "t.hdf5"), *SHAPE,
               "--quiet", *CPU])
    jmain(["build-data", "--data-dir", str(d / "raw"), "--out", str(d / "j.hdf5"), *SHAPE,
           "--quiet"])
    return d


def _stores_match(port_path, jax_path):
    """The same shots and channels; specs within 1e-4, the same axes; the
    labels the port's pipeline on its specs, and JAX's up to the row-mean
    flips."""
    with SpectrogramStore(port_path, "r") as st, SpectrogramStore(jax_path, "r") as js:
        assert st.shots() == js.shots() and st.shots()
        for shot, chn in js.iter_channels():
            got, want = st.read_channel(shot, chn), js.read_channel(shot, chn)
            np.testing.assert_allclose(got["spec"], want["spec"], rtol=0, atol=1e-4)
            np.testing.assert_array_equal(got["f"], want["f"])
            np.testing.assert_array_equal(got["t"], want["t"])
            _labels_match_jax(got["spec"], got["pipeline_out"])


def test_build_data_matches_jax(ws, capfd):
    """The stores of the workspace, and a rerun that skips both shots, as
    JAX's (tests/test_cli.py)."""
    _stores_match(str(ws / "t.hdf5"), str(ws / "j.hdf5"))
    capfd.readouterr()
    tcli.main(["build-data", "--data-dir", str(ws / "raw"), "--out", str(ws / "t.hdf5"),
               *SHAPE, "--quiet", *CPU])
    assert _last_json(capfd) == {"done": 0, "skipped": 2, "failed": 0}


def test_build_data_binary_writers_and_merge_shards(ws, tmp_path, capfd):
    """``--binary --writers 2`` over three SPEC binaries: JAX's summary,
    the shots on both shards, the union store bit for bit the port's
    pickle campaign of the same shots, its specs within 1e-4 of JAX's
    pooled store; then each package's ``merge-shards --out`` of the port's
    shards: the same counts, and the same merged store."""
    pooled, jpooled = str(tmp_path / "pool.hdf5"), str(tmp_path / "jpool.hdf5")
    args = ["build-data", "--data-dir", str(ws / "bin"), *SHAPE, "--binary", "--writers", "2",
            "--quiet"]
    tcli.main([*args, "--out", pooled, *CPU])
    tline = _last_json(capfd)
    jmain([*args, "--out", jpooled])
    assert tline == _last_json(capfd) == {"done": 3, "skipped": 0, "failed": 0}
    for path in (pooled, pooled + ".shard1"):
        with SpectrogramStore(path, "r") as st:
            assert st.shots(), path
    in_memory = str(tmp_path / "pickles.hdf5")
    for raw in ("raw", "raw3"):
        tcli.main(["build-data", "--data-dir", str(ws / raw), "--out", in_memory, *SHAPE,
                   "--quiet", *CPU])
    with SpectrogramStore(pooled, "r") as st, SpectrogramStore(in_memory, "r") as mem, \
            SpectrogramStore(jpooled, "r") as js:
        assert st.shots() == mem.shots() == js.shots() and len(st.shots()) == 3
        for shot, chn in mem.iter_channels():
            got = st.read_channel(shot, chn)
            for k, v in mem.read_channel(shot, chn).items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            np.testing.assert_allclose(got["spec"], js.read_channel(shot, chn)["spec"],
                                       rtol=0, atol=1e-4)
    lines = {}
    for tag, main in (("t", tcli.main), ("j", jmain)):
        main(["merge-shards", "--store", pooled, "--out", str(tmp_path / f"merged_{tag}.hdf5")])
        lines[tag] = _last_json(capfd)
    assert lines["t"] == {"channels_merged": lines["j"]["channels_merged"],
                          "out": str(tmp_path / "merged_t.hdf5")}
    assert lines["t"]["channels_merged"] == 6
    with SpectrogramStore(str(tmp_path / "merged_t.hdf5"), "r") as a, \
            SpectrogramStore(str(tmp_path / "merged_j.hdf5"), "r") as b:
        assert a.shots() == b.shots() and len(a.shots()) == 3
        for shot, chn in b.iter_channels():
            for k, v in b.read_channel(shot, chn).items():
                np.testing.assert_array_equal(a.read_channel(shot, chn)[k], v, err_msg=k)


def _jax_initial_weights(monkeypatch, model_cfg, **tc):
    """The port's ``create_state`` starts from the weights JAX's
    ``create_state`` draws for the same configuration."""
    params = jtrain.create_state(JModelConfig(**dataclasses.asdict(model_cfg)),
                                 JTrainConfig(**tc)).params
    create_state = ttrain.create_state

    def from_jax(mc, tcfg, **kw):
        state = create_state(mc, tcfg, **kw)
        state.model.load_state_dict(state_dict_from_flax(params, mc))
        return state

    monkeypatch.setattr(ttrain, "create_state", from_jax)


TRAIN = ["--epochs", "1", "--num-shots", "2", "--quiet"]


def _run(main, argv) -> dict:
    """``main(argv)`` with its standard output captured: its final JSON
    line (the module fixtures run outside capfd)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(ws, tmp_path_factory):
    """The port's float32 ``train`` on its store, from JAX's initial
    weights, and JAX's ``train`` on the same store: their out dirs and
    final lines."""
    out = tmp_path_factory.mktemp("train")
    mp = pytest.MonkeyPatch()
    try:
        _jax_initial_weights(mp, tcli.MODEL_PRESETS["scan_k3"], epochs=1)
        lines = {tag: _run(main, ["train", "--dataset", str(ws / "t.hdf5"), "--out-dir",
                                  str(out / tag), *TRAIN, *extra])
                 for tag, main, extra in (("t", tcli.main, CPU), ("j", jmain, []))}
    finally:
        mp.undo()
    return out, lines


def test_train_matches_jax(trained):
    """float32 from JAX's initial weights on the same store: val loss within
    rtol 1e-4, ``t_pred`` timed, the same artifacts and epochs logged."""
    out, lines = trained
    assert sorted(lines["t"]) == sorted(lines["j"]) == ["t_pred", "val_loss"]
    assert lines["t"]["val_loss"] == pytest.approx(lines["j"]["val_loss"], rel=1e-4)
    assert lines["t"]["t_pred"] > 0
    assert sorted(os.listdir(out / "t")) == sorted(os.listdir(out / "j")) == \
        ["ex_specs.png", "metrics.jsonl", "model", "t_pred.txt", "val_loss.png", "val_loss.txt"]
    for tag in ("t", "j"):
        with open(out / tag / "metrics.jsonl") as fh:
            assert len(fh.read().strip().splitlines()) == 1
    np.testing.assert_allclose(np.loadtxt(out / "t" / "val_loss.txt"),
                               np.loadtxt(out / "j" / "val_loss.txt"), rtol=1e-4)
    assert sorted(os.listdir(out / "t" / "model")) == ["model_config.json", "params.pt"]


def test_train_kernel_engine_with_a_trace(ws, tmp_path, capfd):
    """``--engine kernel`` (the training kernels' twins on the CPU) with
    ``--trace-dir``: the run's artifacts and a torch.profiler trace."""
    tcli.main(["train", "--dataset", str(ws / "t.hdf5"), "--out-dir", str(tmp_path / "k"),
               *TRAIN, "--engine", "kernel", "--trace-dir", str(tmp_path / "trace"), *CPU])
    line = _last_json(capfd)
    assert np.isfinite(line["val_loss"]) and line["t_pred"] > 0
    assert "metrics.jsonl" in os.listdir(tmp_path / "k")
    assert glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))


def test_train_resume_of_a_finished_run(ws, tmp_path, capfd):
    """``--checkpoints``, then ``--resume`` of the finished run: no new
    epoch, JAX's report."""
    argv = ["train", "--dataset", str(ws / "t.hdf5"), "--out-dir", str(tmp_path), *TRAIN,
            "--checkpoints", *CPU]
    tcli.main(argv)
    assert np.isfinite(_last_json(capfd)["val_loss"])
    assert os.path.isdir(tmp_path / "checkpoints" / "epoch_0000")
    tcli.main(argv + ["--resume"])
    assert _last_json(capfd) == {"resumed": "already complete"}


def test_serve_once_matches_jax(ws, trained, tmp_path, capfd):
    """``serve --once`` over the SPEC binaries (a truncated one among
    them): JAX's counts and JSON line, with the trained model and with the
    untrained one, whose warning is JAX's word for word; a second drain
    does nothing."""
    watch = tmp_path / "in"
    watch.mkdir()
    for name in sorted(os.listdir(ws / "bin"))[:2]:
        (watch / name).write_bytes((ws / "bin" / name).read_bytes())
    (watch / "ece_100999.bin").write_bytes((ws / "bin" / name).read_bytes()[:4096])
    args = ["serve", "--watch-dir", str(watch), *SHAPE, "--once", "--quiet"]
    out, _ = trained
    tcli.main([*args, "--out", str(tmp_path / "t.hdf5"), "--model-dir", str(out / "t" / "model"),
               *CPU])
    assert _last_json(capfd) == {"done": 2, "failed": 1}
    tcli.main([*args, "--out", str(tmp_path / "t.hdf5"), *CPU])
    cap = capfd.readouterr()
    assert json.loads(cap.out.strip().splitlines()[-1]) == {"done": 0, "failed": 0}
    jmain([*args, "--out", str(tmp_path / "j.hdf5")])
    jcap = capfd.readouterr()
    assert json.loads(jcap.out.strip().splitlines()[-1]) == {"done": 2, "failed": 1}
    warning = [ln for ln in cap.err.splitlines() if ln.startswith("WARNING")]
    assert warning == [ln for ln in jcap.err.splitlines() if ln.startswith("WARNING")]
    assert warning == ["WARNING: no --model-dir given — serving an UNTRAINED randomly-initialised "
                       "'scan_k3' model; outputs are not meaningful denoisings"]
    with SpectrogramStore(str(tmp_path / "t.hdf5"), "r") as st:
        assert st.shots() == ["enhanced_101000", "enhanced_101001"]
        d = st.read_channel("enhanced_101000", 2)
        assert d["spec"].shape == (256, 194) and d["pipeline_out"].shape == (256, 128)
    with open(str(tmp_path / "t.hdf5") + ".metrics.jsonl") as fh:
        events = [json.loads(ln)["event"] for ln in fh]
    assert events == ["shot_enhanced", "shot_enhanced", "serve_batch"]


def test_movie_matches_jax(ws, trained, tmp_path, capfd):
    """Frames of the first shot, from the labels and from the trained
    model: JAX's frame count, file names and JSON keys, and an mp4."""
    out, _ = trained
    base = ["movie", "--dataset", str(ws / "t.hdf5"), "--channels", "2", "--stop", "2"]
    jmain([*base, "--out-dir", str(tmp_path / "j")])
    jline = _last_json(capfd)
    for sub, extra in (("t", []), ("tm", ["--model", str(out / "t" / "model")])):
        tcli.main([*base, "--out-dir", str(tmp_path / sub), *extra, *CPU])
        line = _last_json(capfd)
        assert line == {"frames": jline["frames"], "movie": str(tmp_path / sub / "101000.mp4")}
        assert sorted(os.listdir(tmp_path / sub)) == sorted(os.listdir(tmp_path / "j")) == \
            ["101000.mp4", "s101000-f00000.jpg", "s101000-f00001.jpg"]
    assert jline["frames"] == 2


_STRAY = ("--chunk-tiles/--chunk-dtype/--tile-cache apply to the streamed epoch only; this run "
          "is resident (dataset fits the HBM budget) — use --stream always to force streaming")
# case -> (extra argv, the exit's message; None: the command streams the epoch;
# "launches": it starts its ranks)
_EXITS = {
    "train-devices": (["--devices", "2", "--stream", "always"], "launches"),
    "train-stream-always": (["--stream", "always"], None),
    "train-chunk-tiles": (["--chunk-tiles", "8"], _STRAY),
    "train-chunk-dtype": (["--chunk-dtype", "bf16"], _STRAY),
    "train-tile-cache": (["--tile-cache", "tc"], _STRAY),
    "train-over-budget": (["SPECENH_HBM_BUDGET_GB=1e-9"], None),
    "train-kernel-geometry": (["--model", "narrow", "--engine", "kernel"],
                              "--engine kernel does not support the 'narrow' geometry; use "
                              "f32/bf16"),
    "serve-devices": (["--devices", "2"], "launches"),
    "build-data-writers": (["--writers", "4"],
                           "--writers applies to the streaming (--binary) campaign; the pickle "
                           "path is the reference-parity synchronous loop"),
}


@pytest.mark.parametrize("case", sorted(_EXITS))
def test_exits_word_for_word(ws, tmp_path, monkeypatch, case, capfd):
    """Each of JAX's own checks exits with JAX's words (the streaming
    flags of a resident run and ``build-data --writers`` without
    ``--binary`` are held against JAX's exits too).  ``--stream always``,
    and ``--stream auto`` over the resident budget, no longer exit: they
    stream the epoch and write the run's artifacts.  ``serve --devices 2``
    and ``train --stream always --devices 2`` no longer exit: they start
    two ranks of themselves (recorded here; the ranks serve in
    ``tests/test_torch_mesh_serve.py`` and train in
    ``tests/test_torch_mesh_train.py``)."""
    extra, message = _EXITS[case]
    cmd = case.split("-")[0] if not case.startswith("build-data") else "build-data"
    argv = {"train": ["train", "--dataset", str(ws / "t.hdf5"), "--out-dir", str(tmp_path),
                      *TRAIN],
            "serve": ["serve", "--watch-dir", str(ws / "bin"), "--out", str(tmp_path / "e.hdf5"),
                      *SHAPE, "--once"],
            "build-data": ["build-data", "--data-dir", str(ws / "raw"),
                           "--out", str(tmp_path / "d.hdf5")]}[cmd]
    if extra[0].startswith("SPECENH_"):
        monkeypatch.setenv(*extra[0].split("="))
        extra = []
    monkeypatch.setitem(tcli.MODEL_PRESETS, "narrow", tcli.ModelConfig(
        filters=(8, 8), kernels=((3, 3), (3, 3)), out_kernel=(3, 3)))
    if message == "launches":
        started = []
        monkeypatch.setattr(tcli, "_launch_workers", lambda a, n: started.append((a, n)))
        tcli.main([*argv, *extra, *CPU])
        assert started == [([*argv, *extra, *CPU], 2)]
        return
    if message is None:
        tcli.main([*argv, *extra, *CPU])
        assert np.isfinite(_last_json(capfd)["val_loss"])
        with open(tmp_path / "metrics.jsonl") as fh:
            assert [json.loads(ln)["streamed"] for ln in fh] == [True]
        assert {"model", "t_pred.txt", "val_loss.txt"} <= set(os.listdir(tmp_path))
        return
    with pytest.raises(SystemExit, match=f"^{re.escape(message)}$"):
        tcli.main([*argv, *extra, *CPU])
    if cmd == "build-data" or message == _STRAY:
        with pytest.raises(SystemExit, match=f"^{re.escape(message)}$"):
            jmain([*argv, *extra])


@pytest.mark.parametrize("cmd", ["build-data", "train", "serve"])
def test_cuda_without_a_card_exits(ws, tmp_path, cmd):
    """The default ``--device cuda`` where there is no card exits: no
    command falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CUDA path runs instead")
    argv = {"train": ["train", "--dataset", str(ws / "t.hdf5"), "--out-dir", str(tmp_path),
                      *TRAIN, "--engine", "kernel"],
            "serve": ["serve", "--watch-dir", str(ws / "bin"), "--out", str(tmp_path / "e.hdf5"),
                      *SHAPE, "--once"],
            "build-data": ["build-data", "--data-dir", str(ws / "raw"),
                           "--out", str(tmp_path / "d.hdf5"), *SHAPE]}[cmd]
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(argv)
