"""The port's multi-rank training paths on the CPU — ``sweep_fit`` on a
"sweep" mesh, ``sweep_fit_serial`` and ``fit_streaming`` on a "data" mesh,
``train_from_raw(mesh=)``, the ``--devices`` of ``train --stream``,
``train-raw`` and ``sweep`` — against the JAX package on a 2-device mesh of
the conftest's virtual CPU devices; and ``bench.reference
.time_reference_pipeline`` against JAX's.

Two gloo ranks run every two-rank scenario in one launch of
``tests/_torch_mesh_train_worker.py`` (a module fixture; the JAX side runs
here meanwhile), including three of the commands joined as under
``torchrun``; ``sweep --engine kernel --devices 2`` runs through the
command's own launcher beside it.  Tolerances: the envelope and the serial
engine rtol 1e-4 on histories (as ``tests/test_torch_sweep.py``); the
streamed fit rtol 1e-5 on histories and atol 1e-6 on parameters (as
``tests/test_torch_parallel.py``); the kernels' twins rtol 1e-5 on
histories, parameters rtol 1e-4 atol 5e-6; ``train_from_raw`` rtol 1e-4
(its tiles come from the port's own front, within 1e-5 of JAX's); a
resumed run, the tile cache's run and a world of one are the uninterrupted,
uncached and unsharded runs bit for bit."""

import contextlib
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch

import jax

from specenh import e2e as je2e
from specenh import sweep as jsweep
from specenh import train as jtrain
from specenh import train_stream as jts
from specenh.bench import reference_cpu as jref
from specenh.config import Config as JConfig
from specenh.config import ModelConfig as JModelConfig
from specenh.config import PatchSpec as JPatchSpec
from specenh.config import PipelineConfig as JPipelineConfig
from specenh.config import SpecParams as JSpecParams
from specenh.config import TrainConfig as JTrainConfig
from specenh.io.store import SpectrogramStore as JStore
from specenh.parallel.mesh import make_mesh as jmake_mesh
from specenh_torch import Config, ModelConfig, SpecParams, TrainConfig
from specenh_torch import cli as tcli
from specenh_torch import e2e
from specenh_torch import sweep as tsweep
from specenh_torch import train as ttrain
from specenh_torch import train_stream as tts
from specenh_torch.bench import reference as tref
from specenh_torch.config import PatchSpec, PipelineConfig
from specenh_torch.io.store import SpectrogramStore
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240  # seconds the spawned ranks and the launcher may take
SMALL = (64, 32, 1)
PS = dict(tile_freq=32, tile_time=16, step=16, tiles_per_spec=5)
TINY = dict(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(32, 16, 1))
STREAM_TC = dict(epochs=3, seed=0, shuffle=True, batch_size=8)
RAW_TC = dict(epochs=2, batch_size=4)
SWEEP_TC = dict(batch_size=8, seed=0)
GRID = ["--grid", "2layer", "--ker1", "3", "--ker2", "3", "--ker3", "3", "--conv1", "8,16",
        "--conv2", "8"]

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs 2 (virtual) devices")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS thread in this module: the suite runs a worker
    per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _data(n, seed=0, shape=SMALL):
    rng = np.random.default_rng(seed)
    x = rng.random((n, *shape)).astype(np.float32)
    return x, (x > 0.5).astype(np.float32)


def _cfgs(*specs):
    """[(filters, kernel, out_kernel)] -> (JAX configs, port configs)."""
    kws = [dict(filters=f, kernels=((k, k),) * len(f), out_kernel=(o, o), input_shape=SMALL)
           for f, k, o in specs]
    return [JModelConfig(**kw) for kw in kws], [ModelConfig(**kw) for kw in kws]


PAIR = (((4, 4), 3, 3), ((8, 8), 5, 5))
THREE = tuple(((4, 4), k, k) for k in (3, 5, 7))


def _sd(params, cfg) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_flax(params, cfg).items()}


def _traces(n_ch, sp):
    rng = np.random.default_rng(0)
    t = np.arange(sp.n_samples) / sp.fs
    return np.stack([np.sin(2 * np.pi * (5e4 + 2e4 * t) * t + k)
                     + 0.5 * rng.standard_normal(t.size) for k in range(n_ch)]).astype(np.float32)


def _stores(d: Path) -> None:
    """The streamed store (JAX's tests/test_train_stream.py layout: 3 shots
    x 2 channels of (32, 83), 5 tiles each) and the commands' store (2
    shots x 2 channels of (256, 389), 3 tiles each)."""
    rng = np.random.default_rng(7)
    with SpectrogramStore(str(d / "stream.hdf5")) as st:
        for shot in ("101", "102", "103"):
            for chn in (1, 2):
                s = rng.random((32, 83)).astype(np.float32)
                st.write_channel(shot, chn, s, np.arange(32.0), np.arange(83.0), s * 0.5)
    rng = np.random.default_rng(0)
    with SpectrogramStore(str(d / "cli.hdf5")) as st:
        for shot in ("ece_101", "ece_102"):
            for chn in (1, 2):
                s = rng.random((256, 3 * 128 + 5)).astype(np.float32)
                st.write_channel(shot, chn, s, np.arange(256.0), np.arange(s.shape[1] * 1.0),
                                 (s > 0.6).astype(np.float32))


def _inputs(d: Path) -> dict:
    x, y = _data(32)
    krng = np.random.default_rng(4)
    kx = krng.random((4, 256, 128)).astype(np.float32)
    ky = (krng.random((4, 256, 128)) > 0.6).astype(np.float32)
    tiny = JModelConfig(**TINY)
    raw_cfg = JModelConfig(filters=(4, 4))
    _stores(d)
    tcli.main(["synth-shots", "--out", str(d / "raw"), "--shots", "2", "--channels", "2",
               "--samples", "50000", "--seed", "1"])
    return {
        "sweep": (x[:24], y[:24], x[24:], y[24:]),
        "kernel": (kx, ky),
        "ck_sweep": str(d / "ck_sweep"),
        "stream_store": str(d / "stream.hdf5"),
        "tiny": _sd(jtrain.create_state(tiny, JTrainConfig(**STREAM_TC)).params,
                    ModelConfig(**TINY)),
        "tile_cache": str(d / "tc" / "t"),
        "ck_stream": str(d / "ck_stream"),
        "metrics": str(d / "m.jsonl"),
        "raw": _traces(4, SpecParams(cut_shot=0.2)),
        "raw_sd": _sd(jtrain.create_state(raw_cfg, JTrainConfig(**RAW_TC)).params,
                      ModelConfig(filters=(4, 4))),
        "cli": {"store": str(d / "cli.hdf5"), "raw": str(d / "raw"), "grid": GRID,
                "train": str(d / "o_train"), "train_raw": str(d / "o_raw"),
                "sweep": str(d / "o_sweep"), "ports": [_free_port(), _free_port()]},
    }


def _jax_side(inp: dict) -> dict:
    """JAX's runs of the worker's scenarios on 2-device meshes."""
    x, y, xv, yv = inp["sweep"]
    sweep2, data2 = jmake_mesh(2, ("sweep",)), jmake_mesh(2, ("data",))
    tc = JTrainConfig(**SWEEP_TC)
    out = {}
    for name, specs, epochs in (("sweep_pair", PAIR, 3), ("sweep_pad", THREE, 2)):
        r = jsweep.sweep_fit(_cfgs(*specs)[0], x, y, xv, yv, tc, epochs=epochs, mesh=sweep2)
        out[name] = (r.train_history, r.val_history, r.best_index)
    r = jsweep.sweep_fit_serial(_cfgs(*PAIR)[0], x, y, xv, yv, tc, epochs=2, engine="flax",
                                mesh=data2)
    out["serial"] = (r.train_history, r.val_history, r.best_index)
    scfg = JTrainConfig(**STREAM_TC)
    with JStore(inp["stream_store"], "r") as store:
        plan = jts.plan_stream_split(store, num_samples=3, ps=JPatchSpec(**PS), cfg=scfg, seed=3)
        st, h = jts.fit_streaming(jtrain.create_state(JModelConfig(**TINY), scfg), store, plan,
                                  scfg, chunk_tiles=8, ps=JPatchSpec(**PS), mesh=data2)
    out["stream"] = (h, _sd(st.params, ModelConfig(**TINY)))
    jcfg = JConfig(spec=JSpecParams(cut_shot=0.2))
    _, h = je2e.train_from_raw(inp["raw"], jcfg, JModelConfig(filters=(4, 4)),
                               JTrainConfig(**RAW_TC), mesh=data2)
    out["raw"] = h
    try:
        je2e.train_from_raw(inp["raw"][:3], jcfg, JModelConfig(filters=(4, 4)),
                            JTrainConfig(epochs=1, batch_size=4), mesh=data2)
    except ValueError as e:
        out["raw_uneven"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's], JAX's results, the launched
    sweep's output, work dir): one launch of two gloo ranks and one of
    ``sweep --engine kernel --devices 2``, JAX's side computed meanwhile."""
    d = tmp_path_factory.mktemp("mesh_train")
    inp = _inputs(d)
    with open(d / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    env = dict(os.environ, OMP_NUM_THREADS="1", SPECENH_STREAM_CACHE_GB="1",
               LOCAL_WORLD_SIZE="2", SPECENH_DIST_TIMEOUT_S="50",
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                                          if p))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_train_worker.py"), coordinator,
         str(pid), str(d / "inputs.pkl"), str(d / f"r{pid}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env={**env, "LOCAL_RANK": str(pid)},
        cwd=ROOT) for pid in (0, 1)]
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "specenh_torch.cli", "sweep", "--dataset", inp["cli"]["store"],
         "--out-dir", str(d / "o_sweep_kernel"), *GRID, "--engine", "kernel", "--epochs", "1",
         "--num-shots", "2", "--quiet", "--devices", "2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={k: v for k, v in env.items() if k != "LOCAL_WORLD_SIZE"}, cwd=ROOT))
    try:
        jax_out = _jax_side(inp)
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    res = []
    for pid in (0, 1):
        with open(d / f"r{pid}.pkl", "rb") as fh:
            res.append(pickle.load(fh))
    return inp, res, jax_out, outs[2][0].decode(), d


def _equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _close(got: dict, want: dict, **tol) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("case,n_cfg,epochs", [("sweep_pair", 2, 3), ("sweep_pad", 3, 2)])
def test_sweep_fit_on_a_sweep_mesh_matches_jax(runs, case, n_cfg, epochs):
    """The envelope with its configs sharded over two ranks: one config a
    rank; the reference kernel grid padded to 4 and trimmed.  Rank 0 holds
    the result, JAX's sweep_fit(mesh=) histories within rtol 1e-4 and its
    best config; rank 1 returns None."""
    _, (r0, r1), jx, _, _ = runs
    jtrain_h, jval_h, jbest = jx[case]
    got = r0[case]
    assert r1[case] is None
    assert got["n"] == n_cfg and got["val"].shape == jval_h.shape == (epochs, n_cfg)
    np.testing.assert_allclose(got["train"], jtrain_h, rtol=1e-4)
    np.testing.assert_allclose(got["val"], jval_h, rtol=1e-4)
    assert got["best"] == jbest
    assert all(v.shape[0] == n_cfg for v in got["stacked"].values())


def test_sweep_mesh_stops_when_every_config_is_stale(runs):
    """lr 0 and patience 1 on two ranks: the ranks' one decision stops the
    sweep after epoch 2, as the unsharded sweep stops (its histories
    within rtol 1e-4); rank 1 returns None."""
    inp, (r0, r1), _, _, _ = runs
    _, tc = _cfgs(*PAIR)
    want = tsweep.sweep_fit(tc, *inp["sweep"], TrainConfig(**SWEEP_TC, learning_rate=0.0,
                                                           patience=1), epochs=6, device="cpu")
    assert r1["sweep_stop"] is None
    assert r0["sweep_stop"]["val"].shape == want.val_history.shape == (2, 2)
    np.testing.assert_allclose(r0["sweep_stop"]["train"], want.train_history, rtol=1e-4)
    np.testing.assert_allclose(r0["sweep_stop"]["val"], want.val_history, rtol=1e-4)


def test_sweep_mesh_checkpoint_and_resume(runs):
    """The padded grid checkpointed at epoch 1 by rank 0 alone (the whole
    grid: 4 configs) and resumed to 2, each rank from its slice: the
    uninterrupted run bit for bit, and the unsharded padded grid's layout."""
    inp, (r0, r1), _, _, _ = runs
    assert r1["sweep_resume"] is None
    for key in ("train", "val"):
        np.testing.assert_array_equal(r0["sweep_resume"][key], r0["sweep_pad"][key])
        np.testing.assert_array_equal(r0["sweep_part"][key], r0["sweep_pad"][key][:1])
    _equal(r0["sweep_resume"]["stacked"], r0["sweep_pad"]["stacked"])
    ck = Path(inp["ck_sweep"])
    assert sorted(os.listdir(ck)) == ["epoch_0000", "epoch_0001", "run_meta.json"]
    with open(ck / "run_meta.json") as fh:
        meta = json.load(fh)
    assert meta["n_configs"] == 4 and len(meta["grid"]) == 4
    saved = torch.load(ck / "epoch_0001" / "state.pt", weights_only=True)
    assert saved["tr_hist"].shape == (2, 4)
    _, tc = _cfgs(*THREE)
    want, _ = tsweep.init_stacked_params(tc + tc[-1:], tsweep.envelope_config(tc))
    assert {k: v.shape for k, v in saved["params"].items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(s["exp_avg"].shape[0] == 4 for s in saved["optimizer"]["state"].values())


def test_serial_sweep_on_a_data_mesh_matches_jax(runs):
    """``sweep_fit_serial(mesh=)`` at the small geometry (the module's
    autograd engine through dp_fit) against JAX's on a 2-device "data"
    mesh: histories rtol 1e-4, the same best config; both ranks return the
    same result bit for bit."""
    _, (r0, r1), jx, _, _ = runs
    jtrain_h, jval_h, jbest = jx["serial"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["serial"]["train"], jtrain_h, rtol=1e-4)
        np.testing.assert_allclose(r["serial"]["val"], jval_h, rtol=1e-4)
        assert r["serial"]["best"] == jbest
    np.testing.assert_array_equal(r0["serial"]["train"], r1["serial"]["train"])
    _equal(r0["serial"]["stacked"], r1["serial"]["stacked"])


def test_serial_kernel_sweep_on_a_data_mesh(runs):
    """The flagship config through ``dp_kernel_epoch_for`` (float32 twins)
    on 4 tiles, a batch of 4, against the port's unsharded serial sweep on
    ``kernel_epoch_for``: histories rtol 1e-5, parameters rtol 1e-4 atol
    5e-6."""
    inp, (r0, r1), _, _, _ = runs
    kx, ky = inp["kernel"]
    want = tsweep.sweep_fit_serial([ModelConfig()], kx, ky, kx[:2], ky[:2],
                                   TrainConfig(batch_size=4, seed=0), epochs=1,
                                   dtype=torch.float32, device="cpu")
    for r in (r0, r1):
        got = r["serial_kernel"]
        np.testing.assert_allclose(got["train"], want.train_history, rtol=1e-5)
        np.testing.assert_allclose(got["val"], want.val_history, rtol=1e-5)
        _close(got["stacked"], {k: v.numpy() for k, v in want.stacked_params.items()},
               rtol=1e-4, atol=5e-6)


def test_fit_streaming_on_a_data_mesh_matches_jax(runs):
    """18 train tiles in chunks of 8 (a short final chunk whose batch pads
    to the ranks), batch 8 over 2 ranks, 3 epochs from JAX's weights:
    JAX's fit_streaming(mesh=) histories within rtol 1e-5 and parameters
    atol 1e-6; both ranks bit for bit alike."""
    _, (r0, r1), jx, _, _ = runs
    jh, jparams = jx["stream"]
    for r in (r0, r1):
        h = r["stream"]["history"]
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5)
        np.testing.assert_allclose(h["val_loss"], jh["val_loss"], rtol=1e-5)
        _close(r["stream"]["params"], jparams, rtol=0, atol=1e-6)
    assert r0["stream"]["history"] == r1["stream"]["history"]
    _equal(r0["stream"]["params"], r1["stream"]["params"])


def test_stream_tile_cache_built_once_and_resume(runs):
    """From a tile cache: rank 0 alone builds it (train and tune, once),
    rank 1 reads it; the 2 cached epochs are the plain run's bit for bit;
    resumed to 3 they are the plain 3 epochs bit for bit.  Rank 0 alone
    writes the metrics (``devices`` 2) and the checkpoints."""
    inp, (r0, r1), _, _, _ = runs
    assert r0["stream_part"]["builds"] == ["train", "tune"]
    assert r1["stream_part"]["builds"] == []
    for r in (r0, r1):
        part, full = r["stream_part"]["history"], r["stream"]["history"]
        assert part["loss"] == full["loss"][:2] and part["val_loss"] == full["val_loss"][:2]
        resumed = r["stream_resume"]
        assert resumed["history"]["loss"] == full["loss"]
        assert resumed["history"]["new_epochs"] == 1
        _equal(resumed["params"], r["stream"]["params"])
    with open(inp["metrics"]) as fh:
        recs = [json.loads(ln) for ln in fh]
    assert [(m["epoch"], m["devices"]) for m in recs] == [(0, 2), (1, 2)]
    ck = Path(inp["ck_stream"])
    assert sorted(os.listdir(ck)) == ["epoch_0000", "epoch_0001", "epoch_0002", "history.json",
                                      "run_meta.json"]
    with open(ck / "run_meta.json") as fh:
        assert json.load(fh)["devices"] == 2


def test_resume_with_another_device_count_raises(runs):
    """The two ranks' checkpoint resumed on one device raises, as JAX's
    (tests/test_train_stream.py)."""
    inp = runs[0]
    cfg = TrainConfig(**STREAM_TC)
    with SpectrogramStore(inp["stream_store"], "r") as store:
        plan = tts.plan_stream_split(store, num_samples=3, ps=PatchSpec(**PS), cfg=cfg, seed=3)
        with pytest.raises(ValueError, match="run parameters changed"):
            tts.fit_streaming(ttrain.create_state(ModelConfig(**TINY), cfg, device="cpu"), store,
                              plan, cfg, epochs=4, chunk_tiles=8, ps=PatchSpec(**PS),
                              checkpoint_dir=inp["ck_stream"], resume=True)


def test_each_rank_caches_within_its_share(runs):
    """SPECENH_STREAM_CACHE_GB=1 on a host of 2 ranks: each rank's chunk
    cache holds half a GiB; one process alone the whole; 'always' is
    unbounded."""
    for r in runs[1]:
        assert r["budget"] == (2**29, 2**30, float("inf"))


def test_train_from_raw_on_a_data_mesh_matches_jax(runs):
    """4 channels of 0.2 s, two a rank through the front, all-gathered
    (12 tiles: 7 trained, 3 validated), 2 epochs in batches of 4 from JAX's
    weights: JAX's train_from_raw(mesh=) histories within rtol 1e-4; the
    ranks' parameters bit for bit alike.  Three channels raise JAX's
    message."""
    _, (r0, r1), jx, _, _ = runs
    for r in (r0, r1):
        np.testing.assert_allclose(r["raw"]["history"]["loss"], jx["raw"]["loss"], rtol=1e-4)
        np.testing.assert_allclose(r["raw"]["history"]["val_loss"], jx["raw"]["val_loss"],
                                   rtol=1e-4)
        assert r["raw_uneven"] == jx["raw_uneven"]
    assert "3 channels do not divide over the 2-device mesh" in jx["raw_uneven"]
    _equal(r0["raw"]["params"], r1["raw"]["params"])


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("cmd", ["train", "train-raw", "sweep", "sweep-kernel"])
def test_devices_2_commands_write_once(runs, cmd):
    """``train --stream always``, ``train-raw`` and ``sweep`` (envelope,
    joined as under torchrun; ``--engine kernel`` through the command's
    launcher) with ``--devices 2 --device cpu``: rank 0 alone prints the
    final line and writes the artifacts (a streamed metrics line an epoch,
    ``devices`` 2)."""
    inp, (r0, r1), _, launched, d = runs
    if cmd == "sweep-kernel":
        lines, out = _json_lines(launched), d / "o_sweep_kernel"
    else:
        lines, out = _json_lines(r0["cli"][cmd]), Path(inp["cli"][cmd.replace("-", "_")])
        assert _json_lines(r1["cli"][cmd]) == []
    assert len(lines) == 1
    line = lines[0]
    if cmd == "train":
        assert np.isfinite(line["val_loss"])
        with open(out / "metrics.jsonl") as fh:
            recs = [json.loads(ln) for ln in fh]
        assert [(m["epoch"], m["devices"], m["streamed"]) for m in recs] == \
            [(0, 2, True), (1, 2, True)]
        assert {"model", "t_pred.txt", "val_loss.txt", "val_loss.png"} <= set(os.listdir(out))
    elif cmd == "train-raw":
        assert line["channels"] == 4 and np.isfinite(line["val_loss"])
        assert os.listdir(out) == ["model"]
    else:
        assert line["n_configs"] == 2 and np.isfinite(line["best_val_loss"])
        assert sorted(os.listdir(out)) == ["best_model", "best_val_loss.png",
                                           "loss_comparisons.npz", "val_losses.npy"]


@contextlib.contextmanager
def _world_of_one(axis="data"):
    mesh = make_mesh(axis_names=(axis,), device="cpu")
    try:
        yield mesh
    finally:
        mesh.close()


def test_world_of_one_is_the_unsharded_call_bit_for_bit(tmp_path):
    """A gloo world of one: ``fit_streaming(mesh=)``, ``sweep_fit`` on a
    "sweep" mesh, ``sweep_fit_serial(mesh=)`` and
    ``train_from_raw(mesh=)`` give the unsharded calls' losses and
    parameters bit for bit."""
    ps, cfg = PatchSpec(**PS), TrainConfig(**STREAM_TC)
    _stores(tmp_path)
    with SpectrogramStore(str(tmp_path / "stream.hdf5"), "r") as store:
        plan = tts.plan_stream_split(store, num_samples=3, ps=ps, cfg=cfg, seed=3)
        runs_ = []
        for use in (False, True):
            with _world_of_one() if use else contextlib.nullcontext() as mesh:
                st, h = tts.fit_streaming(
                    ttrain.create_state(ModelConfig(**TINY), cfg, device="cpu"), store, plan,
                    cfg, epochs=2, chunk_tiles=8, ps=ps, mesh=mesh)
            runs_.append((h, st.model.state_dict()))
    assert runs_[0][0] == runs_[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs_[0][1].values(), runs_[1][1].values()))

    x, y, xv, yv = (*_data(24), *_data(8, seed=1))
    _, tc = _cfgs(*PAIR)
    tcfg = TrainConfig(**SWEEP_TC)
    for fn, axis in ((tsweep.sweep_fit, "sweep"), (tsweep.sweep_fit_serial, "data")):
        one = fn(tc, x, y, xv, yv, tcfg, epochs=2, device="cpu")
        with _world_of_one(axis) as mesh:
            got = fn(tc, x, y, xv, yv, tcfg, epochs=2, mesh=mesh)
        np.testing.assert_array_equal(got.train_history, one.train_history)
        np.testing.assert_array_equal(got.val_history, one.val_history)
        for k, v in one.stacked_params.items():
            assert torch.equal(got.stacked_params[k], v), (fn.__name__, k)

    traces, rc = _traces(2, SpecParams(cut_shot=0.2)), Config(spec=SpecParams(cut_shot=0.2))
    st1, h1 = e2e.train_from_raw(traces, rc, ModelConfig(filters=(4, 4)),
                                 TrainConfig(**RAW_TC), device="cpu")
    with _world_of_one() as mesh:
        st2, h2 = e2e.train_from_raw(traces, rc, ModelConfig(filters=(4, 4)),
                                     TrainConfig(**RAW_TC), mesh=mesh)
    assert h1["loss"] == h2["loss"] and h1["val_loss"] == h2["val_loss"]
    assert all(torch.equal(a, b) for a, b in zip(st1.model.state_dict().values(),
                                                 st2.model.state_dict().values()))


def test_time_reference_pipeline_matches_jax():
    """JAX's keys and ``n_timed`` (channels x repeats), positive times."""
    sp = SpecParams(cut_shot=0.05)
    sig = np.random.default_rng(3).standard_normal((2, sp.n_samples)).astype(np.float32)
    got = tref.time_reference_pipeline(sig, sp, PipelineConfig(), repeats=2)
    want = jref.time_reference_pipeline(sig, JSpecParams(cut_shot=0.05), JPipelineConfig(),
                                        repeats=2)
    assert sorted(got) == sorted(want)
    assert got["n_timed"] == want["n_timed"] == 4
    assert all(v > 0 for v in got.values())
