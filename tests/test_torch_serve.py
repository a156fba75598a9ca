"""The port's enhancement service (``specenh_torch.serve``) on the CPU: the
counterparts of the JAX package's ``tests/test_serve.py`` (backlog,
idempotent restarts, quarantine, metrics, the writer pool, the shutdown
order), and ``serve_once`` against JAX's ``serve_once`` on the same SPEC
binaries and weights, in float32 and bf16, each package's store read by the
other's reader.

Tolerances are those of the port's service tests against JAX
(``tests/test_torch_slice.py``, ``tests/test_torch_module_route.py``):
float32 specs and enhanced outputs within 1e-4 max |err|; in bf16 the
enhanced outputs at SSIM >= 0.999 per channel (JAX's bf16 Flax route
computes its STFT as one bf16 dot, the port's stays float32), and the
specs at SSIM >= 0.999 (the golden-spectrogram gate of JAX's test)."""

import json
import threading

import numpy as np
import pytest
import threadpoolctl
import torch

import jax

from specenh import serve as jserve
from specenh.bench import harness as jharness
from specenh.config import Config as JConfig, ModelConfig as JModelConfig
from specenh.config import SpecParams as JSpecParams
from specenh.io.store import CampaignManifest as JManifest, SpectrogramStore as JStore
from specenh.models.autoencoder import make_model as flax_model
from specenh_torch.bench.reference import spectrogram_ref
from specenh_torch.config import Config, ModelConfig, SpecParams
from specenh_torch.io.binfmt import write_shot_bin
from specenh_torch.io.store import CampaignManifest, SpectrogramStore, StoreWriterPool
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.serve import EnhanceService, serve_forever, serve_once
from specenh_torch.utils.logging import MetricsLogger
from specenh_torch.utils.metrics import ssim

TINY = dict(filters=(4, 4), kernels=((3, 3), (3, 3)))
CFG = Config(spec=SpecParams(cut_shot=0.1))  # 50 000 samples: one tile a channel


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS thread in this module: the suite runs a worker
    per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _setup(tmp_path, n_shots=2, c=2):
    watch = tmp_path / "in"
    watch.mkdir()
    rng = np.random.default_rng(0)
    for s in range(n_shots):
        write_shot_bin(
            str(watch / f"shot_{100 + s}.bin"),
            rng.standard_normal((c, CFG.spec.n_samples)).astype(np.float32),
        )
    return str(watch)


def _service(n_channels=2, **kw):
    return EnhanceService(CFG, ModelConfig(**TINY), n_channels=n_channels, device="cpu", **kw)


def test_serve_processes_backlog_and_is_idempotent(tmp_path):
    watch = _setup(tmp_path)
    service = _service()
    out = str(tmp_path / "out.hdf5")
    manifest = CampaignManifest(out + ".serve.jsonl")
    with SpectrogramStore(out) as store:
        r1 = serve_once(service, watch, store, manifest, verbose=False)
        r2 = serve_once(service, watch, store, manifest, verbose=False)
    assert r1 == {"done": 2, "failed": 0}
    assert r2 == {"done": 0, "failed": 0}  # the ledger makes restarts idempotent
    manifest.close()
    with SpectrogramStore(out, "r") as store:
        assert sorted(store.shots()) == ["enhanced_100", "enhanced_101"]
        d = store.read_channel("enhanced_100", 1)
        assert d["spec"].shape == (256, CFG.spec.n_frames)
        assert 0.0 <= d["pipeline_out"].min() and d["pipeline_out"].max() <= 1.0


def test_serve_metrics_schema(tmp_path):
    """Per shot ``read_s`` and ``latency_s``, per drain ``serve_batch``
    with shots/s."""
    watch = _setup(tmp_path)
    service = _service()
    out = str(tmp_path / "out.hdf5")
    manifest = CampaignManifest(out + ".serve.jsonl")
    mpath = out + ".metrics.jsonl"
    with SpectrogramStore(out) as store, MetricsLogger(mpath) as metrics:
        serve_once(service, watch, store, manifest, metrics, verbose=False)
    manifest.close()
    events = [json.loads(line) for line in open(mpath)]
    shots = [e for e in events if e["event"] == "shot_enhanced"]
    batch = [e for e in events if e["event"] == "serve_batch"]
    assert len(shots) == 2 and len(batch) == 1
    for e in shots:
        assert e["read_s"] >= 0 and e["latency_s"] >= e["read_s"] and e["channels"] == 2
    assert batch[0]["done"] == 2 and batch[0]["writers"] == 1
    assert batch[0]["shots_per_sec"] > 0


def test_serve_quarantines_corrupt(tmp_path):
    watch = _setup(tmp_path, n_shots=1)
    (tmp_path / "in" / "shot_999.bin").write_bytes(b"garbage")
    service = _service()
    out = str(tmp_path / "out.hdf5")
    manifest = CampaignManifest(out + ".serve.jsonl")
    with SpectrogramStore(out) as store:
        r = serve_once(service, watch, store, manifest, verbose=False)
    assert r == {"done": 1, "failed": 1}
    assert "999" in manifest.failed_shots
    manifest.close()


def test_serve_overlap_with_corrupt_mid_stream(tmp_path):
    """A corrupt shot between two good ones: the result in flight from the
    shot before it is still persisted, and every good shot."""
    watch = _setup(tmp_path, n_shots=2)  # shot_100, shot_101
    (tmp_path / "in" / "shot_100a.bin").write_bytes(b"garbage")  # sorts between
    service = _service()
    out = str(tmp_path / "out.hdf5")
    manifest = CampaignManifest(out + ".serve.jsonl")
    with SpectrogramStore(out) as store:
        r = serve_once(service, watch, store, manifest, verbose=False)
        assert r == {"done": 2, "failed": 1}
        assert sorted(store.shots()) == ["enhanced_100", "enhanced_101"]
    manifest.close()


def test_serve_max_new_counts_inflight(tmp_path):
    """With 3 pending and max_new=2, exactly 2 are processed."""
    watch = _setup(tmp_path, n_shots=3)
    service = _service()
    out = str(tmp_path / "out.hdf5")
    manifest = CampaignManifest(out + ".serve.jsonl")
    with SpectrogramStore(out) as store:
        r = serve_once(service, watch, store, manifest, max_new=2, verbose=False)
        assert r == {"done": 2, "failed": 0}
        r2 = serve_once(service, watch, store, manifest, verbose=False)
        assert r2 == {"done": 1, "failed": 0}
    manifest.close()


def test_serve_writer_pool_shards_persist(tmp_path):
    """A ``StoreWriterPool``: each writer thread owns a shard file, the
    union view sees every shot, and a pooled restart is idempotent (a
    corrupt shot quarantined once)."""
    watch = _setup(tmp_path, n_shots=4)
    (tmp_path / "in" / "shot_50.bin").write_bytes(b"garbage")
    service = _service()
    out = str(tmp_path / "out.hdf5")
    manifest = CampaignManifest(out + ".serve.jsonl")
    with StoreWriterPool(out, writers=3) as pool:
        r1 = serve_once(service, watch, pool, manifest, verbose=False)
        r2 = serve_once(service, watch, pool, manifest, verbose=False)
        assert r1 == {"done": 4, "failed": 1}
        assert r2 == {"done": 0, "failed": 0}
        assert sum(1 for s in pool.stores if s.shots()) > 1  # sharded over > 1 file
    manifest.close()
    with SpectrogramStore(out, "r") as store:
        assert sorted(store.shots()) == [f"enhanced_{100 + s}" for s in range(4)]
        for s in range(4):
            assert store.channels_of(f"enhanced_{100 + s}") == [1, 2]


def test_serve_forever_writers_cli_path(tmp_path):
    """``serve_forever(writers=2)`` builds the pool, retires stale
    manifests through it and drains the backlog."""
    watch = _setup(tmp_path, n_shots=2)
    service = _service()
    out = str(tmp_path / "out.hdf5")
    totals = serve_forever(service, watch, out, once=True, writers=2, verbose=False)
    assert totals == {"done": 2, "failed": 0}
    with SpectrogramStore(out, "r") as store:
        assert sorted(store.shots()) == ["enhanced_100", "enhanced_101"]


def test_service_raises_without_its_device():
    """A mesh that is not a ``parallel.mesh.Mesh`` (or an ``Exchange``)
    raises (serving over a mesh: ``tests/test_torch_mesh_serve.py``); a
    CUDA device where there is none raises (no CPU fallback)."""
    with pytest.raises(TypeError, match="mesh must be a parallel.mesh.Mesh"):
        _service(mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EnhanceService(CFG, ModelConfig(**TINY), n_channels=2)


def test_service_spectrogram_is_golden():
    """The service's spectrogram at SSIM >= 0.999 against the CPU
    reference recipe."""
    service = _service(n_channels=1)
    rng = np.random.default_rng(1)
    traces = rng.standard_normal((1, CFG.spec.n_samples)).astype(np.float32)
    specs, enhanced = service.enhance(traces)
    assert isinstance(specs, np.ndarray) and enhanced.shape == (1, 256, 128)
    assert ssim(specs[0], spectrogram_ref(traces[0], CFG.spec)) > 0.999


def test_serve_dispatch_exception_retires_threads(tmp_path):
    """An exception on the dispatch path leaves serve_once only after its
    writer threads are joined and its reader retired (the caller's store
    closes next); the result dispatched before it is persisted."""
    watch = _setup(tmp_path, n_shots=4)
    service = _service()
    real_fn, calls = service.fn, []

    def boom(params, traces):
        calls.append(1)
        if len(calls) >= 2:
            raise RuntimeError("dispatch boom")
        return real_fn(params, traces)

    service.fn = boom
    out = str(tmp_path / "out.hdf5")
    manifest = CampaignManifest(out + ".serve.jsonl")
    with SpectrogramStore(out) as store:
        with pytest.raises(RuntimeError, match="dispatch boom"):
            serve_once(service, watch, store, manifest, verbose=False)
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("serve-", "store-writer-"))]
    manifest.close()
    with SpectrogramStore(out, "r") as store:
        assert store.shots() == ["enhanced_100"]  # the shot in flight landed


def test_service_takes_a_module_or_its_state_dict():
    """A module and its ``state_dict`` serve the same weights; the
    caller's module is left where it was; no params is the seed-0 draw."""
    model = make_model(ModelConfig(**TINY), generator=torch.Generator().manual_seed(3))
    traces = np.random.default_rng(2).standard_normal((2, CFG.spec.n_samples)).astype(np.float32)
    a = _service(params=model).enhance(traces)
    b = _service(params=model.state_dict()).enhance(traces)
    c = _service().enhance(traces)
    seed0 = make_model(ModelConfig(**TINY), generator=torch.Generator().manual_seed(0))
    d = _service(params=seed0).enhance(traces)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(c[1], d[1])
    assert not np.array_equal(a[1], c[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_once_matches_jax(tmp_path, dtype):
    """The same two 2-channel SPEC binaries through JAX's ``serve_once``
    and the port's, the same (4, 4)/k3 weights (JAX's ``PRNGKey(0)`` init,
    converted): the same counts, shots and channels; the outputs within
    the module docstring's tolerances; each store read by the other
    package's reader."""
    watch = _setup(tmp_path)
    jcfg = JConfig(spec=JSpecParams(cut_shot=0.1))
    jmodel_cfg = JModelConfig(**TINY)
    params = flax_model(jmodel_cfg).init(
        jax.random.PRNGKey(0), np.zeros((1, *jmodel_cfg.input_shape), np.float32))
    jservice = jserve.EnhanceService(jcfg, jmodel_cfg, params, n_channels=2)
    if dtype == "float32":
        jservice.fn = jharness.make_enhance_shot_fn(jmodel_cfg, jcfg.spec, jcfg.patch,
                                                    dtype=None, n_channels=2)
        jservice.params = jservice.fn.prepare(params)
    service = _service(params=state_dict_from_flax(params, ModelConfig(**TINY)),
                       dtype=getattr(torch, dtype) if dtype == "bfloat16" else None)
    paths = {}
    for tag, svc, serve, Store, Manifest in (("j", jservice, jserve.serve_once, JStore, JManifest),
                                             ("t", service, serve_once, SpectrogramStore,
                                              CampaignManifest)):
        paths[tag] = str(tmp_path / f"{tag}.hdf5")
        manifest = Manifest(paths[tag] + ".serve.jsonl")
        with Store(paths[tag]) as store:
            assert serve(svc, watch, store, manifest, verbose=False) == {"done": 2, "failed": 0}
        manifest.close()
    with SpectrogramStore(paths["j"], "r") as jst, JStore(paths["t"], "r") as tst:
        assert jst.shots() == tst.shots() == ["enhanced_100", "enhanced_101"]
        for shot, chn in jst.iter_channels():
            want, got = jst.read_channel(shot, chn), tst.read_channel(shot, chn)
            np.testing.assert_array_equal(got["f"], want["f"])
            np.testing.assert_array_equal(got["t"], want["t"])
            assert got["pipeline_out"].shape == want["pipeline_out"].shape == (256, 128)
            if dtype == "float32":
                np.testing.assert_allclose(got["spec"], want["spec"], rtol=0, atol=1e-4)
                np.testing.assert_allclose(got["pipeline_out"], want["pipeline_out"],
                                           rtol=0, atol=1e-4)
            else:
                assert ssim(got["spec"], want["spec"]) >= 0.999
                assert ssim(got["pipeline_out"], want["pipeline_out"]) >= 0.999
