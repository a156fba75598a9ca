"""The port's serving over a mesh on the CPU: the channel-sharded service
(``bench.harness.make_enhance_shot_fn(mesh=, n_channels=)``), the mesh
daemon (``serve.EnhanceService(mesh=)``: ``serve_once`` on rank 0,
``follow()`` on the others), ``serve --devices N`` and the time-sharded
shot across processes.

In process: a gloo world of one is the service without a mesh bit for
bit; 8 thread shards (``tests/_torch_exchange.py``) in float32 match the
JAX package's service on its 8-device "data" mesh within 1e-4 (the
port's tolerance against JAX's service) and the port's own single service
bit for bit, also over uneven blocks; ``use_kernel=True`` with an uneven
count raises JAX's "divisible" error, as JAX's does; two thread ranks run
``serve_once`` and ``follow()`` over a corrupt shot.

One launch of two gloo processes (``tests/_torch_mesh_worker.py``, a 50 s
collective timeout) holds: the time-sharded shot against the in-process
8- and 2-shard results (spectrogram 5e-5, labels 1e-5) and the enhanced
output bit for bit ``ae_kernel_enhance_specs`` of its gathered
spectrogram; the channel-sharded service within 1e-6 of the single one
(JAX's ``test_multichip_serving_kernel_matches_single``); ``serve_once``
over 3 shots, one corrupt, and ``serve --devices 2 --device cpu``: the
persisted channels equal the single-rank daemon's, the manifest records 2
done and 1 failed, both ranks exit 0; on a group with a 3 s collective
timeout, an idle ``serve_forever`` outlives twice the timeout and then
serves a shot, and a failure inside a shot on rank 0 sends no stop and
takes the follower down at the timeout."""

import json
import os
import pickle
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import threadpoolctl
import torch

import jax

from specenh.bench import harness as jharness
from specenh.config import ModelConfig as JModelConfig, SpecParams as JSpecParams
from specenh.models.autoencoder import make_model as flax_model
from specenh.parallel.mesh import make_mesh as jmake_mesh
from specenh_torch.bench.harness import make_enhance_shot_fn
from specenh_torch.config import MODEL_PRESETS, Config, ModelConfig, SpecParams
from specenh_torch.io.binfmt import write_shot_bin
from specenh_torch.io.store import CampaignManifest, SpectrogramStore
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel
from specenh_torch.parallel import timeshard as tts
from specenh_torch.parallel.mesh import make_mesh
from specenh_torch.serve import EnhanceService, serve_once
from tests._torch_exchange import run_shards
from tests.conftest import synth_trace

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

ROOT = Path(__file__).resolve().parents[1]
SP = SpecParams(cut_shot=0.1)  # 50 000 samples: one tile a channel
CFG = Config(spec=SP)
TINY = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)))
SHOT = SpecParams(cut_shot=0.6)
T_SHOT = tts.usable_samples_tiled(SHOT.n_samples, 8, SHOT)  # 262 144
TIMEOUT = 90  # seconds the launch may take
SHORT = 3  # seconds a collective of the idle daemon's group may wait
# (case, channels, use_kernel) of the channel-sharded service over two ranks
SERVICE_CASES = (("even", 4, True), ("uneven", 3, "auto"), ("uneven-module", 3, False))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS thread in this module: the suite runs a worker
    per core, and the shards run on threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _model(cfg=ModelConfig(), sd=None, seed=0):
    m = make_model(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    if sd is not None:
        m.load_state_dict(sd)
    return m.eval()


def _traces(c, seed=13, sp=SP):
    return np.random.default_rng(seed).standard_normal((c, sp.n_samples)).astype(np.float32)


def _write_watch(d: Path) -> str:
    """3 shots of 2 x 50 000 samples, the second one corrupt."""
    d.mkdir()
    rng = np.random.default_rng(0)
    for s in (100, 102):
        write_shot_bin(str(d / f"shot_{s}.bin"),
                       rng.standard_normal((2, SP.n_samples)).astype(np.float32))
    (d / "shot_101.bin").write_bytes(b"garbage")
    return str(d)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's], rank 0's stdout): one launch
    of two gloo ranks."""
    d = tmp_path_factory.mktemp("mesh")
    inp = {
        "flagship": _model(seed=3).state_dict(),
        "tiny": _model(TINY, seed=4).state_dict(),
        "shot": (synth_trace(JSpecParams(cut_shot=0.6), seed=12)[:T_SHOT],
                 SpecParams(cut_shot=T_SHOT / SHOT.fs)),
        "service": (_traces(4), SP),
        "service_cases": SERVICE_CASES,
        "watch": _write_watch(d / "in"),
        "out": str(d / "out.hdf5"),
        "cli_out": str(d / "cli.hdf5"),
        "short_timeout": SHORT,
        "late": _traces(2, seed=21),
        "late_path": str(d / "late" / "shot_200.bin"),
        "idle_out": str(d / "idle.hdf5"),
    }
    (d / "late").mkdir()
    with open(d / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"), coordinator, "2",
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
    return inp, res, outs[0][0].decode()


def _shot_shards(inp, n):
    """The time-sharded shot on n in-process thread shards, joined."""
    x, sp = inp["shot"]
    model = _model(sd=inp["flagship"])

    def body(ex):
        fn = tts.make_sharded_enhance_shot(ModelConfig(), sp, ex)
        return fn(fn.prepare(model), tts.shard_of(ex, torch.from_numpy(x)))

    outs = run_shards(n, body)
    return [torch.cat([o[i] for o in outs], -1) for i in range(3)]


def test_two_ranks_time_sharded_shot(runs):
    """Two gloo ranks, 4 tiles each: the gathered spectrogram within 5e-5 and
    the labels within 1e-5 of 8 and 2 in-process shards; the enhanced
    output bit for bit ``ae_kernel_enhance_specs`` (bf16 twins) of the
    gathered spectrogram; the other rank gets None."""
    inp, res, _ = runs
    spec, labels, enh = res[0]["shot"]
    assert res[1]["shot"] == (None, None, None)
    assert res[0]["mesh"] == [{"time": 2}, {"data": 2}]
    assert res[0]["shot_local"] == [torch.Size([256, 512])] * 3
    for n in (8, 2):
        s, lab, _ = _shot_shards(inp, n)
        np.testing.assert_allclose(spec, s, atol=5e-5)
        np.testing.assert_allclose(labels, lab, atol=1e-5)
    wts = ae_kernel.build_kernel_weights(_model(sd=inp["flagship"]), torch.bfloat16, 2)
    assert torch.equal(enh, ae_kernel.ae_kernel_enhance_specs(wts, spec[None], 8)[0])


@pytest.mark.parametrize("case,c,use_kernel", SERVICE_CASES, ids=[s[0] for s in SERVICE_CASES])
def test_two_ranks_channel_sharded_service(runs, case, c, use_kernel):
    """Two gloo ranks, 2 + 2 or 2 + 1 channels: rank 0's full (specs,
    enhanced) within 1e-6 of the single-process service (bf16), the other
    rank's None."""
    inp, res, _ = runs
    traces = inp["service"][0][:c]
    fn = make_enhance_shot_fn(ModelConfig(), SP, device="cpu", use_kernel=use_kernel)
    want = fn(fn.prepare(_model(sd=inp["flagship"])), traces)
    assert res[1]["service"][case] == (None, None)
    for got, w in zip(res[0]["service"][case], want):
        assert got.shape == w.shape
        assert (got - w).abs().max() <= 1e-6


def _single_daemon(watch, out, cfg, params):
    """The single-rank daemon's drain of ``watch`` into ``out``."""
    service = EnhanceService(CFG, cfg, params, n_channels=2, device="cpu")
    manifest = CampaignManifest(out + ".serve.jsonl")
    with SpectrogramStore(out) as store:
        counts = serve_once(service, watch, store, manifest, verbose=False)
    manifest.close()
    return counts


def _same_store(got: str, want: str) -> None:
    with SpectrogramStore(got, "r") as a, SpectrogramStore(want, "r") as b:
        assert sorted(a.shots()) == sorted(b.shots()) == ["enhanced_100", "enhanced_102"]
        for shot in b.shots():
            assert a.channels_of(shot) == b.channels_of(shot) == [1, 2]
            for c in (1, 2):
                ra, rb = a.read_channel(shot, c), b.read_channel(shot, c)
                for k in ("spec", "pipeline_out"):
                    np.testing.assert_array_equal(ra[k], rb[k], err_msg=f"{shot} {c} {k}")


def _manifest(out: str):
    """The (status, shot) records of the daemon's ledger."""
    with open(out + ".serve.jsonl") as fh:
        return sorted((r["status"], r["shot"]) for r in map(json.loads, fh))


def test_two_ranks_serve_once(runs, tmp_path):
    """``serve_once`` on rank 0 of two gloo ranks, ``follow()`` on rank 1,
    over 3 shots, one corrupt: counts 2 done and 1 failed, rank 1 took the
    2 good shots, the manifest records both and the failure, every
    persisted channel equals the single-rank daemon's."""
    inp, res, _ = runs
    assert res[0]["counts"] == {"done": 2, "failed": 1}
    assert res[1]["followed"] == 2
    want = str(tmp_path / "single.hdf5")
    assert _single_daemon(inp["watch"], want, TINY, inp["tiny"]) == {"done": 2, "failed": 1}
    _same_store(inp["out"], want)
    assert _manifest(inp["out"]) == _manifest(want) == [("done", "100"), ("done", "102"),
                                                        ("failed", "101")]


def test_two_ranks_cli_serve(runs, tmp_path):
    """``serve --devices 2 --device cpu --once`` joined as torchrun's ranks:
    rank 0 prints the totals, the store equals the single-rank daemon's
    (the untrained scan_k3 model)."""
    inp, _, stdout = runs
    assert json.loads(stdout.strip().splitlines()[-1]) == {"done": 2, "failed": 1}
    want = str(tmp_path / "single.hdf5")
    _single_daemon(inp["watch"], want, MODEL_PRESETS["scan_k3"], None)
    _same_store(inp["cli_out"], want)


def test_two_ranks_idle_daemon_outlives_the_timeout(runs, tmp_path):
    """``serve_forever`` on rank 0 of two gloo ranks whose collectives time
    out after 3 s polls an empty directory for 6 s (its keep-alives end
    rank 1's wait each poll), then serves the shot that arrives: 1 done,
    rank 1 took the warm-up and the shot, and the persisted channels equal
    the single-rank daemon's."""
    inp, res, _ = runs
    assert res[0]["idle"] == {"done": 1, "failed": 0}
    assert res[0]["idle_s"] >= 2 * SHORT
    assert res[1]["idle_followed"] == 2
    watch = tmp_path / "in"
    watch.mkdir()
    write_shot_bin(str(watch / "shot_200.bin"), inp["late"])
    want = str(tmp_path / "single.hdf5")
    assert _single_daemon(str(watch), want, TINY, inp["tiny"]) == {"done": 1, "failed": 0}
    with SpectrogramStore(inp["idle_out"], "r") as a, SpectrogramStore(want, "r") as b:
        assert a.shots() == b.shots() == ["enhanced_200"]
        for c in (1, 2):
            ra, rb = a.read_channel("enhanced_200", c), b.read_channel("enhanced_200", c)
            for k in ("spec", "pipeline_out"):
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=f"{c} {k}")


def test_two_ranks_failure_inside_a_shot(runs):
    """A shot that fails on rank 0 after its header went out: ``dispatch``
    raises, ``close()`` then sends no stop (it returns at once instead of
    waiting on a broadcast rank 1 never joins), and rank 1's ``follow()``
    fails within the group's 3 s timeout and a margin."""
    _, res, _ = runs
    assert res[0]["failed"] == "injected"
    assert res[0]["close_s"] < 1
    assert res[1]["follow_failed_s"] < SHORT + 10


@pytest.mark.parametrize("use_kernel,stft_mode", [("auto", "auto"), ("auto", "xla"),
                                                  (False, "auto")])
def test_world_of_one_is_the_service_bit_for_bit(use_kernel, stft_mode):
    """A gloo world of one on a "data" mesh: ``make_enhance_shot_fn(mesh=)``
    equals the service without a mesh bit for bit (bf16, 3 channels)."""
    model, traces = _model(), _traces(3)
    f1 = make_enhance_shot_fn(ModelConfig(), SP, device="cpu", use_kernel=use_kernel,
                              stft_mode=stft_mode)
    mesh = make_mesh(1, ("data",), device="cpu")
    try:
        fm = make_enhance_shot_fn(ModelConfig(), SP, device="cpu", use_kernel=use_kernel,
                                  stft_mode=stft_mode, mesh=mesh, n_channels=3)
        got = fm(fm.prepare(model), traces)
    finally:
        mesh.close()
    for a, b in zip(got, f1(f1.prepare(model), traces)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_service8():
    """JAX's float32 service (Flax) on its 8-device "data" mesh, 8 channels,
    and the weights."""
    jsp = JSpecParams(cut_shot=0.1)
    params = flax_model(JModelConfig()).init(jax.random.PRNGKey(0),
                                             np.zeros((1, 256, 128, 1), np.float32))
    fm = jharness.make_enhance_shot_fn(JModelConfig(), jsp, dtype=None,
                                       mesh=jmake_mesh(8, ("data",)), n_channels=8)
    traces = _traces(8, seed=12)
    return traces, state_dict_from_flax(params, ModelConfig()), \
        tuple(np.asarray(a) for a in fm(params, traces))


@pytest.mark.parametrize("use_kernel,c", [("auto", 8), (False, 8), ("auto", 5)])
def test_thread_shards_match_the_service(jax_service8, use_kernel, c):
    """The float32 service on 8 thread shards of a "data" mesh (5 channels
    on 4 shards: blocks of 2, 1, 1, 1): rank 0's arrays equal
    the port's single service bit for bit and, on 8 channels, JAX's
    8-device service within 1e-4; the other ranks get None."""
    traces, sd, want = jax_service8
    traces = traces[:c]
    model = _model(sd=sd)
    n = 8 if c == 8 else 4

    def body(ex):
        fn = make_enhance_shot_fn(ModelConfig(), SP, dtype=None, device="cpu",
                                  use_kernel=use_kernel, mesh=ex, n_channels=c)
        return fn(fn.prepare(model), traces)

    outs = run_shards(n, body, axis_names=("data",))
    assert all(o == (None, None) for o in outs[1:])
    f1 = make_enhance_shot_fn(ModelConfig(), SP, dtype=None, device="cpu", use_kernel=use_kernel)
    for got, single in zip(outs[0], f1(f1.prepare(model), traces)):
        assert torch.equal(got, single)
    if c == 8:
        for got, w in zip(outs[0], want):
            np.testing.assert_allclose(got.numpy(), w, atol=1e-4)


def test_forced_kernels_need_divisible_channels():
    """``use_kernel=True`` over 8 ranks with 20 channels raises at call
    time naming "divisible", as JAX's service does; a call with another
    channel count than ``n_channels``, fewer channels than ranks and a
    mesh of another axis raise."""
    jsp = JSpecParams(cut_shot=0.1)
    jfn = jharness.make_enhance_shot_fn(JModelConfig(), jsp, mesh=jmake_mesh(8, ("data",)),
                                        use_kernel=True, interpret=True)
    with pytest.raises(ValueError, match="divisible"):
        jfn(None, np.zeros((20, jsp.n_samples), np.float32))
    model = _model()

    def call(c, use_kernel=True, n_channels=None):
        def body(ex):
            fn = make_enhance_shot_fn(ModelConfig(), SP, device="cpu", use_kernel=use_kernel,
                                      mesh=ex, n_channels=n_channels)
            return fn(model, np.zeros((c, SP.n_samples), np.float32))
        return lambda: run_shards(8, body, axis_names=("data",))

    with pytest.raises(ValueError, match=r"channel count \(20\) divisible by the 'data' axis "
                                         r"size \(8\)"):
        call(20)()
    with pytest.raises(ValueError, match="the service takes 20 channels, got 16"):
        call(16, n_channels=20)()
    with pytest.raises(ValueError, match="4 channels cannot be sharded over 8 ranks"):
        call(4, use_kernel="auto")()
    with pytest.raises(ValueError, match="mesh's axis is 'time', not 'data'"):
        run_shards(2, lambda ex: make_enhance_shot_fn(TINY, SP, device="cpu", mesh=ex))


def test_thread_ranks_serve_and_follow(tmp_path):
    """``serve_once`` on thread rank 0 of a two-rank mesh service and
    ``follow()`` on rank 1, over 3 shots, one corrupt (quarantined on rank
    0, never dispatched): rank 1 follows 2 shots; the store equals the
    single-rank daemon's; ``close()`` a second time sends nothing; the
    wrong rank's calls raise."""
    watch = _write_watch(tmp_path / "in")
    out, want = str(tmp_path / "out.hdf5"), str(tmp_path / "single.hdf5")
    sd = _model(TINY, seed=4).state_dict()

    def body(ex):
        service = EnhanceService(CFG, TINY, sd, n_channels=2, device="cpu", mesh=ex)
        if not service.lead:
            with pytest.raises(RuntimeError, match="rank 0"):
                serve_once(service, watch, None, None)
            return service.follow()
        with pytest.raises(RuntimeError, match="other than 0"):
            service.follow()
        manifest = CampaignManifest(out + ".serve.jsonl")
        with SpectrogramStore(out) as store:
            counts = serve_once(service, watch, store, manifest, verbose=False)
        manifest.close()
        service.close()
        service.close()
        with pytest.raises(RuntimeError, match="not closed"):
            service.dispatch(np.zeros((2, SP.n_samples), np.float32))
        return counts

    counts, followed = run_shards(2, body, axis_names=("data",))
    assert counts == {"done": 2, "failed": 1} and followed == 2
    assert _single_daemon(watch, want, TINY, sd) == counts
    _same_store(out, want)


def test_mesh_service_raises_without_a_card():
    """``EnhanceService(mesh=)`` on ``cuda`` where there is no card raises
    (no CPU fallback); a mesh on another device type than ``device``
    raises; an object that is not a mesh raises."""
    mesh = make_mesh(1, ("data",), device="cpu")
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                EnhanceService(CFG, TINY, n_channels=2, mesh=mesh)
        with pytest.raises(TypeError, match="mesh must be"):
            EnhanceService(CFG, TINY, n_channels=2, device="cpu", mesh=object())
        mesh.device = torch.device("meta")
        with pytest.raises(ValueError, match="not a cpu device"):
            EnhanceService(CFG, TINY, n_channels=2, device="cpu", mesh=mesh)
    finally:
        mesh.close()


def test_serving_threads_never_call_collectives(tmp_path):
    """Every collective of a mesh drain runs on rank 0's dispatching thread
    (none on the reader or the writer threads)."""
    watch = _write_watch(tmp_path / "in")
    seen = set()

    def body(ex):
        for name in ("reduce", "all_gather", "gather", "broadcast"):
            prim = getattr(ex, name)

            def spy(*a, _prim=prim, **kw):
                seen.add((ex.rank, threading.current_thread().name))
                return _prim(*a, **kw)

            setattr(ex, name, spy)
        service = EnhanceService(CFG, TINY, n_channels=2, device="cpu", mesh=ex)
        if not service.lead:
            return service.follow()
        out = str(tmp_path / "out.hdf5")
        manifest = CampaignManifest(out + ".serve.jsonl")
        with SpectrogramStore(out) as store:
            serve_once(service, watch, store, manifest, verbose=False)
        manifest.close()
        service.close()
        return threading.current_thread().name

    main0, _ = run_shards(2, body, axis_names=("data",))
    assert {name for rank, name in seen if rank == 0} == {main0}


def test_serve_once_exception_stops_the_followers(tmp_path):
    """An exception in rank 0's ``serve_once`` (here: no store) sends the
    stop before it propagates: the other rank's ``follow()`` returns."""
    watch = _write_watch(tmp_path / "in")

    def body(ex):
        service = EnhanceService(CFG, TINY, n_channels=2, device="cpu", mesh=ex)
        if not service.lead:
            return service.follow()
        manifest = CampaignManifest(str(tmp_path / "m.jsonl"))
        try:
            with pytest.raises(AttributeError):
                serve_once(service, watch, None, manifest, verbose=False)
        finally:
            manifest.close()
        return "raised"

    assert run_shards(2, body, axis_names=("data",)) == ["raised", 0]
