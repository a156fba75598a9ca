"""The port's data-parallel training (``specenh_torch.parallel``) on the
CPU, against the JAX package on a 2-device mesh of the conftest's virtual
CPU devices.

Two gloo ranks run every scenario in one launch of
``tests/_torch_dp_worker.py`` (a module fixture; 60 s for the group, and
50 s a collective): one autograd step; ``dp_fit`` on TINY's (64, 32)
tiles with a batch that is not a multiple of the ranks and padded rows,
validation, interrupted at epoch 2 and resumed to 4, both placements, bf16
and early stopping; the kernel epoch (its plain twins here) with a rank
whose block of a batch is all padding.  Held to JAX's own tolerances (loss
1e-6, parameters atol 1e-6, histories rtol 1e-5; the kernel epoch rtol
1e-5, parameters rtol 1e-4 atol 5e-6), to each other and to the
single-process port.  Also: a world of one is ``fit`` bit for bit,
``initialize_distributed`` with ``host_shard`` and ``merge_stores``
against JAX's, the cluster guard, the mesh's refusals, the "data"
placement's bound, and ``train --devices 2 --device cpu`` end to end."""

import json
import math
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

from specenh import train as jtrain
from specenh.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from specenh.io.store import SpectrogramStore as JStore
from specenh.parallel import data_parallel as jdp
from specenh.parallel import multihost as jmh
from specenh.parallel.mesh import make_mesh as jmake_mesh
from specenh_torch import ModelConfig, TrainConfig
from specenh_torch import cli as tcli
from specenh_torch import train as ttrain
from specenh_torch.io.store import SpectrogramStore
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops.ae_train_kernel import kernel_train_epoch_fn
from specenh_torch.parallel import data_parallel as tdp
from specenh_torch.parallel import multihost as tmh
from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
from specenh_torch.parallel.mesh import check_visible, make_mesh

ROOT = Path(__file__).resolve().parents[1]
TINY = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(64, 32, 1))
TINY16 = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(32, 16, 1))
FLAGSHIP = ModelConfig()
TIMEOUT = 60  # seconds a spawned group may take

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


def _jcfg(cfg: ModelConfig) -> JModelConfig:
    return JModelConfig(filters=cfg.filters, kernels=cfg.kernels, out_kernel=cfg.out_kernel,
                        input_shape=cfg.input_shape)


def _jstate(cfg, seed, **tc):
    return jtrain.create_state(_jcfg(cfg), JTrainConfig(seed=seed, **tc))


def _sd(params, cfg) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_flax(params, cfg).items()}


def _tstate(cfg, sd, dtype=None, **tc):
    st = ttrain.create_state(cfg, TrainConfig(**tc), device="cpu", dtype=dtype)
    st.model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return st


def _params(st) -> dict:
    return {k: v.detach().numpy() for k, v in st.model.state_dict().items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(d: Path) -> dict:
    rng = np.random.default_rng(0)
    step = rng.random((16, 64, 32, 1)).astype(np.float32)
    fit = [np.random.default_rng(s).random((n, 64, 32, 1)).astype(np.float32)
           for s, n in ((1, 10), (2, 10), (3, 5), (4, 5))]
    stop = np.random.default_rng(0).random((16, 32, 16, 1)).astype(np.float32)
    krng = np.random.default_rng(4)
    kx = krng.random((6, 256, 128)).astype(np.float32)
    ky = (krng.random((6, 256, 128)) > 0.6).astype(np.float32)
    return {
        "tiny1": _sd(_jstate(TINY, 1).params, TINY),
        "tiny2": _sd(_jstate(TINY, 2).params, TINY),
        "tiny16": _sd(_jstate(TINY16, 0).params, TINY16),
        "flagship": _sd(_jstate(FLAGSHIP, 0).params, FLAGSHIP),
        "step": (step, np.random.default_rng(5).random(step.shape).astype(np.float32),
                 np.ones(16, np.float32)),
        "fit": tuple(fit),
        "stop": (stop, (stop * 0.5).astype(np.float32)),
        "kernel": (kx, ky),
        "store": str(d / "part%d.hdf5"),
        "ckpt": str(d / "ck"),
        "metrics": str(d / "m.jsonl"),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's], work dir): one launch of two
    gloo ranks."""
    d = tmp_path_factory.mktemp("dp")
    inp = _inputs(d)
    with open(d / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dp_worker.py"), coordinator, "2",
         str(pid), str(d / "inputs.pkl"), str(d / f"r{pid}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT) for pid in (0, 1)]
    try:
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
    return inp, res, d


@pytest.fixture(scope="module")
def mesh2():
    return jmake_mesh(2, ("data",))


@pytest.fixture(scope="module")
def jax_fit(runs, mesh2):
    """JAX's dp_fit on the worker's fit scenario: 4 epochs, batch 5."""
    inp = runs[0]
    x, y, xv, yv = inp["fit"]
    st, h = jdp.dp_fit(_jstate(TINY, 2), x, y, mesh2, xv, yv, epochs=4, batch_size=5, seed=3)
    return h, _sd(st.params, TINY)


def _close(got: dict, want: dict, **tol) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dp_step_matches_jax(runs, mesh2):
    """One step on two blocks of a 16-tile batch against JAX's SPMD step on
    a 2-device mesh, then the eval step on the updated weights: losses
    within 1e-6, parameters atol 1e-6."""
    inp, res, _ = runs
    x, y, m = inp["step"]
    step = jdp.make_dp_train_step(mesh2)
    batch = jdp.shard_batch(mesh2, x, y, m)
    st, loss = step(_jstate(TINY, 1), *batch)
    val = jdp.make_dp_eval_step(mesh2)(st, *batch)
    for r in res:
        assert abs(r["step"]["loss"] - float(loss)) < 1e-6
        assert abs(r["step"]["eval"] - float(val)) < 1e-6
        _close(r["step"]["params"], _sd(st.params, TINY), rtol=0, atol=1e-6)


@pytest.mark.parametrize("scenario", ["fit", "resume"])
def test_dp_fit_matches_jax(runs, jax_fit, scenario):
    """dp_fit with a batch of 5 (-> 6 over 2 ranks, the last batch padded)
    and validation, uninterrupted or stopped at epoch 2 and resumed to 4:
    JAX's history (rtol 1e-5) and parameters (atol 1e-6); the resumed run
    is the uninterrupted one bit for bit."""
    (jh, jparams), res = jax_fit, runs[1]
    for r in res:
        h = r[scenario]["history"]
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5)
        np.testing.assert_allclose(h["val_loss"], jh["val_loss"], rtol=1e-5)
        _close(r[scenario]["params"], jparams, rtol=0, atol=1e-6)
        assert h["new_epochs"] == (2 if scenario == "resume" else 4)
    for r in res:
        assert r["resume"]["history"]["loss"] == r["fit"]["history"]["loss"]
        _equal(r["resume"]["params"], r["fit"]["params"])


def test_rank0_writes_the_files(runs):
    """Only rank 0 writes: one metrics line an epoch (``devices`` 2), the
    checkpoints of 4 epochs, ``history.json`` and ``run_meta.json``."""
    _, _, d = runs
    with open(d / "m.jsonl") as fh:
        recs = [json.loads(ln) for ln in fh]
    assert [r["epoch"] for r in recs] == [0, 1]
    assert all(r["devices"] == 2 and r["sec"] > 0 for r in recs)
    assert sorted(os.listdir(d / "ck")) == ["epoch_0000", "epoch_0001", "epoch_0002",
                                            "epoch_0003", "history.json", "run_meta.json"]
    with open(d / "ck" / "run_meta.json") as fh:
        assert json.load(fh) == {"n": 10, "seed": 3, "batch_size": 6, "shuffle": True,
                                 "devices": 2}


def test_placements_give_the_same_run(runs):
    """"data" (the default, the checkpointed 2-epoch run) and "replicated"
    place data only: the same losses and parameters bit for bit, and the
    uninterrupted run's first two epochs."""
    for r in runs[1]:
        assert r["part"]["history"] == r["replicated"]["history"]
        _equal(r["part"]["params"], r["replicated"]["params"])
        assert r["part"]["history"]["loss"] == r["fit"]["history"]["loss"][:2]


@pytest.mark.parametrize("scenario", ["step", "fit", "part", "resume", "replicated", "bf16",
                                      "kernel"])
def test_ranks_hold_identical_parameters(runs, scenario):
    """Every rank ends every scenario with the same parameters, bit for
    bit, all finite."""
    a, b = (r[scenario]["params"] for r in runs[1])
    _equal(a, b)
    assert all(np.isfinite(v).all() for v in a.values())


def test_bf16_engine(runs):
    """The bf16 autograd engine on two ranks: finite losses within 1e-3 of
    the single-process bf16 ``fit`` on the same batches."""
    inp, res, _ = runs
    x, y, xv, yv = inp["fit"]
    tc = TrainConfig(batch_size=6, seed=3)
    _, h = ttrain.fit(_tstate(TINY, inp["tiny2"], dtype=torch.bfloat16), x, y, xv, yv, cfg=tc,
                      epochs=2)
    for r in res:
        got = r["bf16"]["history"]
        assert np.isfinite(got["loss"]).all()
        np.testing.assert_allclose(got["loss"], h["loss"], rtol=1e-3)
        np.testing.assert_allclose(got["val_loss"], h["val_loss"], rtol=1e-3)


def test_early_stopping_matches_jax(runs, mesh2):
    """patience=1 with lr 0: stops after epoch 2 (``stopped_epoch`` 1), as
    JAX's dp_fit."""
    inp = runs[0]
    x, y = inp["stop"]
    _, jh = jdp.dp_fit(_jstate(TINY16, 0, learning_rate=0.0), x, y, mesh2, x[:8], y[:8],
                       epochs=8, batch_size=8, seed=0, patience=1)
    for r in runs[1]:
        h = r["stop"]["history"]
        assert h["stopped_epoch"] == jh["stopped_epoch"] == 1
        assert len(h["loss"]) == len(jh["loss"]) == 2


def test_kernel_epoch_survives_an_all_padding_rank(runs, mesh2):
    """The kernel epoch (float32 twins) on 6 flagship tiles in batches of
    4: rank 1's block of batch 2 is all padding.  Per-batch losses within
    rtol 1e-5 and parameters rtol 1e-4 atol 5e-6 of the port's one-rank
    kernel epoch and of JAX's Flax SPMD epoch on the same batches."""
    inp, res, _ = runs
    x, y = inp["kernel"]
    bi, bm = tdp._epoch_batches(6, 4, np.arange(6))
    assert bm[1, 2:].sum() == 0  # rank 1's block of batch 2
    st, losses = kernel_train_epoch_fn(FLAGSHIP, dtype=torch.float32)(
        _tstate(FLAGSHIP, inp["flagship"]), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(bi), torch.from_numpy(bm))
    data = jax.sharding.NamedSharding(mesh2, jax.sharding.PartitionSpec("data"))
    jst, jlosses = jdp.make_dp_epoch_programs(mesh2)[0](
        _jstate(FLAGSHIP, 0), jdp._put_sharded(x[..., None], data, 2),
        jdp._put_sharded(y[..., None], data, 2), jax.numpy.asarray(bi), jax.numpy.asarray(bm))
    jparams = _sd(jst.params, FLAGSHIP)
    for r in res:
        for want_l, want_p in ((losses.numpy(), _params(st)), (np.asarray(jlosses), jparams)):
            np.testing.assert_allclose(r["kernel"]["losses"], want_l, rtol=1e-5)
            _close(r["kernel"]["params"], want_p, rtol=1e-4, atol=5e-6)


@pytest.mark.parametrize("engine", ["autograd", "kernel"])
def test_world_of_one_is_fit_bit_for_bit(engine):
    """A gloo world of one: ``dp_fit`` is ``fit`` bit for bit in losses,
    val losses and parameters (the kernel engine on its twins)."""
    rng = np.random.default_rng(7)
    cfg, shape, epochs, bs = ((TINY, (10, 64, 32), 2, 4) if engine == "autograd"
                              else (FLAGSHIP, (3, 256, 128), 1, 2))
    x, y = rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)
    tc = TrainConfig(batch_size=bs, seed=2)
    mesh = make_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.shape) == (0, 1, {"data": 1})
        fn1 = ttrain.kernel_epoch_for(cfg, tc) if engine == "kernel" else None
        fn2 = dp_kernel_epoch_for(cfg, tc, mesh) if engine == "kernel" else None
        s1, h1 = ttrain.fit(ttrain.create_state(cfg, tc, device="cpu"), x, y, x[:2], y[:2],
                            cfg=tc, epochs=epochs, epoch_fn=fn1)
        s2, h2 = tdp.dp_fit(ttrain.create_state(cfg, tc, device="cpu"), x, y, mesh, x[:2],
                            y[:2], epochs=epochs, batch_size=bs, seed=2, epoch_fn=fn2)
    finally:
        mesh.close()
    assert h1["loss"] == h2["loss"] and h1["val_loss"] == h2["val_loss"]
    _equal(_params(s2), _params(s1))


def test_initialize_distributed_host_shard_and_merge(runs, tmp_path):
    """Two processes joined through ``initialize_distributed``: (pid, 2);
    ``host_shard`` gives JAX's strided lists; each rank's store merged by
    the port's ``merge_stores`` equals JAX's merge of the same stores."""
    inp, res, _ = runs
    shots = [f"30{i}" for i in range(5)]
    assert [(r["pid"], r["n"]) for r in res] == [(0, 2), (1, 2)]
    assert [r["mesh"] for r in res] == [[0, 2, 2], [1, 2, 2]]
    assert [r["shard"] for r in res] == [jmh.host_shard(shots, p, 2) for p in (0, 1)]
    assert tmh.host_shard(shots, 1, 2) == jmh.host_shard(shots, 1, 2)
    assert tmh.host_shard(shots) == shots  # no group: standalone
    parts = [inp["store"] % p for p in (0, 1)]
    got, want = str(tmp_path / "t.hdf5"), str(tmp_path / "j.hdf5")
    assert tmh.merge_stores(got, parts) == jmh.merge_stores(want, parts) == 5
    with SpectrogramStore(got, "r") as a, JStore(want, "r") as b:
        assert a.shots() == b.shots() and len(b.shots()) == 5
        for shot in b.shots():
            ga, gb = a.read_channel(shot, 1), b.read_channel(shot, 1)
            for k in gb:
                np.testing.assert_array_equal(ga[k], gb[k])


_CLUSTER_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS",
                "TPU_WORKER_HOSTNAMES", "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE",
                "WORLD_SIZE", "RANK", "SLURM_NTASKS", "SLURM_PROCID", "MASTER_ADDR")


@pytest.mark.parametrize("env", [{}, {"SLURM_JOB_NUM_NODES": "2"}, {"WORLD_SIZE": "2"},
                                 {"TPU_WORKER_HOSTNAMES": "a"}])
def test_initialize_distributed_guard(monkeypatch, env):
    """No cluster named: standalone (0, 1).  A cluster named while the
    process comes up 1 of 1 raises, as JAX's guard (one TPU hostname is a
    standalone rig)."""
    for k in _CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if env in ({}, {"TPU_WORKER_HOSTNAMES": "a"}):
        assert tmh.initialize_distributed(backend="gloo") == (0, 1)
        return
    with pytest.raises(RuntimeError, match="came up single-process"):
        tmh.initialize_distributed(backend="gloo")


def test_mesh_refusals():
    """More GPUs than are visible: JAX's message (a mesh on ``cuda`` with
    no card too); more than one rank with no group, or a multi-axis mesh:
    refused."""
    with pytest.raises(ValueError, match="^requested 2 devices but only 0 available$"):
        check_visible(2, "cuda")
    with pytest.raises(ValueError, match="^requested 2 devices but only 0 available$"):
        make_mesh(2, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="^requested 1 devices but only 0 available$"):
            make_mesh(axis_names=("sweep",), device="cuda")
    with pytest.raises(ValueError, match="2 processes"):
        make_mesh(2, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-axis meshes are not ported"):
        make_mesh(axis_names=("data", "time"), device="cpu")


@pytest.mark.parametrize("cmd", ["train", "serve", "train-raw", "sweep"])
def test_devices_beyond_the_visible_exit_first(tmp_path, monkeypatch, cmd):
    """``train``/``serve``/``train-raw``/``sweep --devices 2`` where one
    GPU is visible exit with JAX's device-count message before they open a
    store or a directory (the dataset here does not exist)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = {"train": ["train", "--dataset", str(tmp_path / "none.hdf5"), "--out-dir",
                      str(tmp_path / "o"), "--engine", "kernel"],
            "serve": ["serve", "--watch-dir", str(tmp_path / "none"), "--out",
                      str(tmp_path / "e.hdf5")],
            "train-raw": ["train-raw", "--data-dir", str(tmp_path / "none"), "--out-dir",
                          str(tmp_path / "o")],
            "sweep": ["sweep", "--dataset", str(tmp_path / "none.hdf5"), "--out-dir",
                      str(tmp_path / "o")]}[cmd]
    with pytest.raises(SystemExit) as e:
        tcli.main([*argv, "--devices", "2", "--quiet"])
    assert str(e.value) == "--devices 2: requested 2 devices but only 1 available"
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("n,bs,size", [(10, 6, 2), (12, 4, 2), (7200, 128, 2), (40, 16, 4)])
def test_data_placement_bound(n, bs, size):
    """Under "data" a rank holds the rows its blocks read in an epoch: at
    most ceil(n / bs) blocks of bs / size rows, ceil(n / size) when bs
    divides n; the blocks read them through the local indices."""
    perm = np.random.default_rng(0).permutation(n)
    bi, bm = tdp._epoch_batches(n, bs, perm)
    blk = bs // size
    held = 0
    for r in range(size):
        li, lm = bi[:, r * blk:(r + 1) * blk], bm[:, r * blk:(r + 1) * blk]
        rows, local = tdp._local_rows(li, lm)
        assert len(rows) <= math.ceil(n / bs) * blk
        if n % bs == 0:
            assert len(rows) <= math.ceil(n / size)
        np.testing.assert_array_equal(rows[local][lm > 0], li[lm > 0])
        held += int(lm.sum())
    assert held == n


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The port's store of 2 synthetic shots x 2 channels (one tile a
    channel)."""
    d = tmp_path_factory.mktemp("dp_cli")
    tcli.main(["synth-shots", "--out", str(d / "raw"), "--shots", "2", "--channels", "2",
               "--samples", "50000", "--seed", "1"])
    tcli.main(["build-data", "--data-dir", str(d / "raw"), "--out", str(d / "t.hdf5"),
               "--channels", "2", "--cut-shot", "0.1", "--quiet", "--device", "cpu"])
    return str(d / "t.hdf5")


@pytest.mark.parametrize("engine", ["f32", "kernel"])
def test_train_devices_cli(store, tmp_path, monkeypatch, capfd, engine):
    """``train --devices 2 --device cpu``: two gloo workers (one torch
    thread each, a 60 s collective timeout); rank 0 alone prints the final
    line and writes the artifacts (one metrics line an epoch, ``devices``
    2; the checkpoints)."""
    monkeypatch.setenv("SPECENH_DIST_TIMEOUT_S", str(TIMEOUT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    capfd.readouterr()
    tcli.main(["train", "--dataset", store, "--epochs", "1", "--num-shots", "2", "--quiet",
               "--engine", engine, "--checkpoints", "--device", "cpu",
               "--out-dir", str(tmp_path), "--devices", "2"])
    lines = [json.loads(ln) for ln in capfd.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1 and np.isfinite(lines[0]["val_loss"])
    with open(tmp_path / "metrics.jsonl") as fh:
        assert [json.loads(ln)["devices"] for ln in fh] == [2]
    assert {"model", "t_pred.txt", "val_loss.txt", "checkpoints"} <= set(os.listdir(tmp_path))
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["epoch_0000", "history.json",
                                                            "run_meta.json"]
