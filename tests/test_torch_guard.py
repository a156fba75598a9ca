"""Guards of the port: it imports nothing of the JAX package and serves
and trains without jax, flax, h5py or ``specenh``, also from a tree that
has no ``specenh/``, where ``python -m specenh_torch.cli sweep`` runs too;
h5py is imported only inside the calls that open a store, matplotlib only
where a figure is drawn; the streamed trainer, the tile cache and the
record readers run with none of jax, flax, ``specenh``, h5py or
ml_dtypes loaded; its own copies of the JAX package's config,
references, Q8.8 tables, STFT axes, host IO, record pipeline, chunk
plans and reads, tile-cache lookup, plots,
frame movie, metrics and metrics logger equal the originals; the
watch-directory service and the multi-rank trainers (on a gloo world of
one) run with none of jax, flax, ``specenh``, h5py or matplotlib loaded;
the native reader builds outside ``native/``; the headline benchmark and
``cli bench`` load with none of jax, flax, ``specenh`` or h5py;
``chip_smoke.py`` fails where there is no GPU; the kernel wrappers check
their inputs before either path."""

import ast
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import specenh.config as jconfig
from specenh.bench import reference_cpu as jreference
from specenh.bench.reference_cpu import spectrogram_ref as jspectrogram_ref
from specenh.ops import enhance as jenhance
from specenh.ops import stft as jstft
from specenh.utils.metrics import ssim as jssim
from specenh_torch import config as tconfig
from specenh_torch.bench import reference as treference
from specenh_torch.bench.reference import spectrogram_ref, ssim
from specenh_torch.ops import enhance as tenhance
from specenh_torch.ops import stft as tstft
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops import ae_train_kernel as ttk
from specenh_torch.ops import stft_fused as tsf
from specenh_torch import ModelConfig, SpecParams
from specenh_torch.models.autoencoder import make_model

ROOT = Path(__file__).resolve().parents[1]
SP = SpecParams(cut_shot=0.2)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return env


def test_port_serves_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "flax", "h5py", "specenh"):
            sys.modules[name] = None
        import torch
        from specenh_torch import ModelConfig, SpecParams
        from specenh_torch.bench.harness import example_shot, make_enhance_shot_fn
        from specenh_torch.bench.reference import spectrogram_ref, ssim
        from specenh_torch.models.autoencoder import make_model
        sp = SpecParams(cut_shot=0.07)  # 135 frames, one tile
        fn = make_enhance_shot_fn(ModelConfig(), sp, dtype=None, device="cpu")
        model = make_model(ModelConfig(), generator=torch.Generator().manual_seed(0))
        shot = example_shot(sp, n_channels=2)
        specs, enhanced = fn(model, shot)
        assert enhanced.shape == (2, 256, 128), enhanced.shape
        assert torch.isfinite(enhanced).all()
        assert ssim(specs[0].numpy(), spectrogram_ref(shot[0], sp)[0]) > 0.99
        loaded = [m for m, v in sys.modules.items() if v is not None]
        assert not [m for m in loaded if m.split(".")[0] in ("jax", "flax", "h5py", "specenh")]
        print("served")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "served" in res.stdout


# a citation of the TPU kernel a CUDA kernel replaces, file:line
_CITATION = re.compile(r"specenh/[\w/]+\.py:\d+")


def _function_bodies(tree):
    """Nodes inside a function (run at call time, not at import)."""
    inner = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            inner.update(id(n) for n in ast.walk(node) if n is not node)
    return inner


def test_no_jax_imports_in_the_port():
    """No import of jax, flax or anything of ``specenh`` anywhere, no import
    of h5py at module level (only inside the calls that open a store), and
    no path into ``specenh/`` (a string naming it, other than a file:line
    citation), in the package or ``chip_smoke.py``."""
    files = sorted((ROOT / "specenh_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        tree = ast.parse(f.read_text())
        inner = _function_bodies(tree)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and not _CITATION.fullmatch(node.value)):
                assert re.search(r"(^|[/\\\s\"'])specenh([/\\\"'.]|$)", node.value) is None \
                    or "\n" in node.value, (f, node.value)  # docstrings may name it
            for n in names:
                assert n.split(".")[0] not in ("jax", "flax", "specenh"), (f, n)
                assert n.split(".")[0] != "h5py" or id(node) in inner, (f, n)


def test_port_runs_without_the_jax_package(tmp_path):
    """``specenh_torch/`` and ``chip_smoke.py`` copied into a tree without
    ``specenh/``: the port serves one short shot and trains one step (the
    kernel engine's twins and autograd) on the CPU."""
    shutil.copytree(ROOT / "specenh_torch", tmp_path / "specenh_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "flax", "h5py"):
            sys.modules[name] = None
        import importlib.util
        assert importlib.util.find_spec("specenh") is None
        import torch
        from specenh_torch import ModelConfig, SpecParams, TrainConfig
        from specenh_torch.bench.harness import example_shot, make_enhance_shot_fn
        from specenh_torch.train import create_state, fit, kernel_epoch_for
        sp = SpecParams(cut_shot=0.07)
        fn = make_enhance_shot_fn(ModelConfig(), sp, device="cpu")
        state = create_state(ModelConfig(), TrainConfig(), device="cpu")
        specs, enhanced = fn(state.model, example_shot(sp, n_channels=1))
        assert enhanced.shape == (1, 256, 128) and torch.isfinite(enhanced).all()
        x = specs[:, :, :128]
        tc = TrainConfig(batch_size=1, epochs=1)
        for engine in (None, kernel_epoch_for(ModelConfig(), tc)):
            state, hist = fit(state, x, x.clamp(0, 1), cfg=tc, epoch_fn=engine)
            assert hist["new_epochs"] == 1 and hist["loss"][0] > 0
        assert state.step == 2
        print("trained")
    """)
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "trained" in res.stdout


@pytest.mark.parametrize("name", ["SpecParams", "PatchSpec", "ModelConfig", "TrainConfig",
                                  "PipelineConfig", "SweepConfig", "PathConfig", "Config"])
def test_config_copy_equals_jax_config(name):
    """The port's copy has the JAX package's fields, defaults and derived
    properties."""
    a, b = getattr(tconfig, name), getattr(jconfig, name)
    assert [(f.name, f.default) for f in dataclasses.fields(a)] == \
        [(f.name, f.default) for f in dataclasses.fields(b)]
    assert dataclasses.asdict(a()) == dataclasses.asdict(b())
    props = [k for k, v in vars(b).items() if isinstance(v, property)]
    assert props == [k for k, v in vars(a).items() if isinstance(v, property)]
    for k in props:
        assert getattr(a(), k) == getattr(b(), k), k
    if name == "ModelConfig":
        assert {k: dataclasses.asdict(v) for k, v in tconfig.MODEL_PRESETS.items()} == \
            {k: dataclasses.asdict(v) for k, v in jconfig.MODEL_PRESETS.items()}
        assert [c.depth for c in tconfig.MODEL_PRESETS.values()] == \
            [c.depth for c in jconfig.MODEL_PRESETS.values()]


def test_reference_copies_equal_jax_references():
    """spectrogram_ref (the JAX package's function: its spectrogram, f and
    t) and ssim give exactly the JAX package's numbers."""
    import inspect

    port = textwrap.dedent(inspect.getsource(spectrogram_ref))
    orig = textwrap.dedent(inspect.getsource(jspectrogram_ref))
    assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False)
    sp = SpecParams(cut_shot=0.05)
    sig = np.random.default_rng(3).standard_normal(sp.n_samples + 11).astype(np.float32)
    got, want = spectrogram_ref(sig, sp), jspectrogram_ref(sig, sp)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(4)
    a, b = rng.random((40, 30)), rng.random((40, 30))
    assert ssim(a, b) == jssim(a, b)
    assert ssim(a, a) == jssim(a, a) == pytest.approx(1.0)


def _ast_without_docstrings(source: str, port: bool) -> str:
    """The module's AST with every docstring dropped, the port's package
    name read as the JAX package's."""
    if port:
        source = source.replace("specenh_torch", "specenh")
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["shots", "binfmt", "store"])
def test_io_copies_equal_jax_modules(module):
    """The port's host IO is the JAX package's code, docstrings aside: the
    same readers, the same SPEC format, the same store schema."""
    port = (ROOT / "specenh_torch" / "io" / f"{module}.py").read_text()
    orig = (ROOT / "specenh" / "io" / f"{module}.py").read_text()
    assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False)


def _top_level_source(path: Path, name: str) -> str:
    """The source of the module's top-level definition ``name``, decorators
    included."""
    lines = path.read_text().splitlines()
    for node in ast.parse("\n".join(lines)).body:
        if getattr(node, "name", None) == name:
            start = min([node.lineno] + [d.lineno for d in node.decorator_list])
            return "\n".join(lines[start - 1:node.end_lineno])
    raise AssertionError(f"{name} not in {path}")


# module -> the JAX package's definitions it copies, in its order
_COPIES = {"data/grain_pipeline": ["RecordSlice", "channel_records", "_patch_np",
                                   "_read_slice_tiles", "iter_record_slices", "tile_dataset",
                                   "iter_tile_batches"],
           "viz/plots": ["_axes", "display", "plt_spec_shot", "plot_stages", "plot_svd_compare",
                         "plot_frame_view", "plot_val_loss"],
           "viz/movie": ["dump_frames", "render_movie"],
           "utils/metrics": ["_uniform_filter", "ssim", "psnr"],
           "utils/logging": ["MetricsLogger"]}
# module -> its own definitions after the copies (where it has any)
_OWN = {"utils/logging": ["_cuda_devices", "SpanRecord", "_Thread", "SpanRecorder", "recording",
                          "_Span", "span", "profile_trace", "_trace_base_ns",
                          "_write_chrome_spans", "nan_guard"]}


@pytest.mark.parametrize("module,name", [(m, n) for m, names in _COPIES.items() for n in names])
def test_data_and_viz_copies_equal_jax_modules(module, name):
    """The streamed split plan's unit (``RecordSlice``), the figures, the
    frame movie, SSIM and PSNR, and the metrics logger are
    the JAX package's code, docstrings aside; each copy module holds the
    definitions it copies and, after them, its own listed in ``_OWN``."""
    port_path = ROOT / "specenh_torch" / f"{module}.py"
    port = _top_level_source(port_path, name)
    orig = _top_level_source(ROOT / "specenh" / f"{module}.py", name)
    assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False)
    defs = [n.name for n in ast.parse(port_path.read_text()).body if hasattr(n, "name")]
    assert defs == _COPIES[module] + _OWN.get(module, [])


# the streamed trainer's host-side definitions copied from the JAX package
# (their modules hold the port's own definitions around them)
_STREAM_COPIES = {"train_stream": ["_iter_chunks", "_chunk_plans", "_read_chunk",
                                   "_stream_cache_budget_bytes", "estimate_resident_bytes"],
                  "data/tilecache": ["_paths", "plan_fingerprint", "open_or_build",
                                     "open_tile_cache"]}


@pytest.mark.parametrize("module,name", [(m, n) for m, names in _STREAM_COPIES.items()
                                         for n in names])
def test_stream_copies_equal_jax_modules(module, name):
    """The chunk plans and reads, the cache budget, the resident estimate
    and the tile cache's paths, fingerprint and lookup are the JAX
    package's code, docstrings aside."""
    port = _top_level_source(ROOT / "specenh_torch" / f"{module}.py", name)
    orig = _top_level_source(ROOT / "specenh" / f"{module}.py", name)
    assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False)


def test_streamed_training_runs_without_jax(tmp_path):
    """``train_stream``, ``data.tilecache`` and the record readers import
    and run with jax, flax, ``specenh``, h5py and ml_dtypes blocked, on an
    in-memory store: the record readers, a bf16 tile-cache round trip and
    a streamed fit from bf16 chunks on the CPU."""
    code = textwrap.dedent("""
        import sys
        blocked = ("jax", "flax", "specenh", "h5py", "ml_dtypes", "matplotlib")
        for name in blocked:
            sys.modules[name] = None
        import numpy as np, torch
        from specenh_torch import ModelConfig, TrainConfig, train
        from specenh_torch.config import PatchSpec
        from specenh_torch.data import grain_pipeline as gp, tilecache as tc
        from specenh_torch import train_stream as ts

        class Store:
            path = None
            def __init__(self):
                rng = np.random.default_rng(0)
                self.recs = {(s, c): rng.random((32, 80)).astype(np.float32)
                             for s in ("ece_1", "ece_2") for c in (1, 2)}
            def shots(self):
                return sorted({s for s, _ in self.recs})
            def channels_of(self, shot):
                return sorted(c for s, c in self.recs if s == shot)
            def iter_channels(self):
                return iter(sorted(self.recs))
            def spec_shape(self, shot, chn):
                return self.recs[shot, chn].shape
            def read_column_slice(self, shot, chn, lo, hi):
                x = self.recs[shot, chn][:, lo:hi]
                return x, x * 0.5

        ps = PatchSpec(32, 16, 16, 5)
        st = Store()
        tiles = list(gp.tile_dataset(st, ps=ps, seed=1))
        assert len(tiles) == 4 and tiles[0][0].shape == (5, 32, 16, 1)
        plan = ts.plan_stream_split(st, num_samples=2, ps=ps, seed=0)
        r = tc.open_or_build(st, plan.train, "tc", "train", ps, "bf16", chunk_tiles=4)
        x, y = r.read(0, r.n)
        want = ts._read_chunk(st, plan.train, ps)
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, torch.from_numpy(want[0]).to(torch.bfloat16))
        cfg = TrainConfig(epochs=2, batch_size=4, seed=0)
        mc = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(32, 16, 1))
        state = train.create_state(mc, cfg, device="cpu")
        _, hist = ts.fit_streaming(state, st, plan, cfg, chunk_tiles=4, ps=ps,
                                   cache_dtype="bf16", tile_cache="tc")
        assert len(hist["loss"]) == 2 and np.isfinite(hist["val_loss"]).all()
        loaded = [m for m, v in sys.modules.items() if v is not None]
        assert not [m for m in loaded if m.split(".")[0] in blocked]
        print("streamed")
    """)
    env = {**_env(), "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "streamed" in res.stdout


def test_headline_and_cli_bench_load_without_jax():
    """``bench.headline`` imports, and ``cli bench --help`` runs, with jax,
    flax, ``specenh`` and h5py blocked; none of them is loaded after."""
    code = textwrap.dedent("""
        import sys
        blocked = ("jax", "flax", "specenh", "h5py")
        for name in blocked:
            sys.modules[name] = None
        import specenh_torch.bench.headline
        from specenh_torch import cli
        try:
            cli.main(["bench", "--help"])
        except SystemExit as e:
            assert e.code == 0, e.code
        loaded = [m for m, v in sys.modules.items() if v is not None]
        assert not [m for m in loaded if m.split(".")[0] in blocked]
        print("loaded")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "--trace-dir" in res.stdout and res.stdout.endswith("loaded\n")


def test_mesh_trainers_run_without_jax(tmp_path):
    """The multi-rank trainers — ``fit_streaming(mesh=)`` over an in-memory
    store with a tile cache, ``sweep_fit`` on a "sweep" mesh,
    ``sweep_fit_serial(mesh=)`` and ``train_from_raw(mesh=)`` — import and
    run on a gloo world of one with jax, flax, ``specenh`` and h5py
    blocked."""
    code = textwrap.dedent("""
        import sys
        blocked = ("jax", "flax", "specenh", "h5py", "ml_dtypes", "matplotlib")
        for name in blocked:
            sys.modules[name] = None
        import numpy as np, torch
        from specenh_torch import Config, ModelConfig, SpecParams, TrainConfig
        from specenh_torch import e2e, sweep, train, train_stream as ts
        from specenh_torch.config import PatchSpec
        from specenh_torch.parallel.mesh import make_mesh

        class Store:
            path = None
            def __init__(self):
                rng = np.random.default_rng(0)
                self.recs = {(s, c): rng.random((32, 80)).astype(np.float32)
                             for s in ("ece_1", "ece_2") for c in (1, 2)}
            def shots(self):
                return sorted({s for s, _ in self.recs})
            def channels_of(self, shot):
                return sorted(c for s, c in self.recs if s == shot)
            def iter_channels(self):
                return iter(sorted(self.recs))
            def spec_shape(self, shot, chn):
                return self.recs[shot, chn].shape
            def read_column_slice(self, shot, chn, lo, hi):
                x = self.recs[shot, chn][:, lo:hi]
                return x, x * 0.5

        ps = PatchSpec(32, 16, 16, 5)
        tc = TrainConfig(epochs=1, batch_size=4, seed=0)
        mc = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(32, 16, 1))
        mesh = make_mesh(device="cpu")
        st = Store()
        plan = ts.plan_stream_split(st, num_samples=2, ps=ps, seed=0)
        _, h = ts.fit_streaming(train.create_state(mc, tc, device="cpu"), st, plan, tc,
                                chunk_tiles=4, ps=ps, mesh=mesh, tile_cache="tc")
        assert np.isfinite(h["val_loss"]).all()
        x = np.random.default_rng(1).random((8, 32, 16, 1)).astype(np.float32)
        res = sweep.sweep_fit_serial([mc], x, x, x[:4], x[:4], tc, mesh=mesh)
        assert np.isfinite(res.val_losses).all()
        mesh.close()
        mesh = make_mesh(axis_names=("sweep",), device="cpu")
        res = sweep.sweep_fit([mc, mc], x, x, x[:4], x[:4], tc, mesh=mesh)
        assert res.val_history.shape == (1, 2)
        sp = SpecParams(cut_shot=0.07)
        traces = np.random.default_rng(2).standard_normal((2, sp.n_samples)).astype(np.float32)
        _, h = e2e.train_from_raw(traces, Config(spec=sp), ModelConfig(filters=(4, 4)), tc,
                                  mesh=mesh)
        assert np.isfinite(h["val_loss"]).all()
        mesh.close()
        loaded = [m for m, v in sys.modules.items() if v is not None]
        assert not [m for m in loaded if m.split(".")[0] in blocked]
        print("meshes")
    """)
    env = {**_env(), "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "meshes" in res.stdout


def test_metrics_copies_give_jax_numbers():
    """``utils.metrics`` gives the JAX package's SSIM and PSNR, and
    ``bench.reference.ssim`` is that function."""
    from specenh.utils.metrics import psnr as jpsnr
    from specenh_torch.utils import metrics

    rng = np.random.default_rng(5)
    a, b = rng.random((2, 30, 40)), rng.random((2, 30, 40))
    assert metrics.ssim(a, b) == jssim(a, b)
    assert metrics.psnr(a, b) == jpsnr(a, b) and metrics.psnr(a, a) == float("inf")
    assert ssim is metrics.ssim


def test_serving_and_store_commands_load_without_jax(tmp_path):
    """``serve``, ``utils`` and the store commands import with jax, flax,
    ``specenh``, h5py and matplotlib blocked and load none of them;
    ``serve_once`` runs on the CPU into an in-memory sink without h5py;
    ``serve --once`` loads h5py only to open its store, and no matplotlib."""
    code = textwrap.dedent("""
        import json, sys
        blocked = ("jax", "flax", "h5py", "specenh", "matplotlib")
        for name in blocked:
            sys.modules[name] = None
        import numpy as np, torch
        import specenh_torch.cli as cli, specenh_torch.serve as serve, specenh_torch.utils
        import specenh_torch.data.tiles, specenh_torch.viz
        from specenh_torch import Config, ModelConfig, SpecParams
        from specenh_torch.io.binfmt import write_shot_bin
        from specenh_torch.io.store import CampaignManifest, StoreWriterPool
        from specenh_torch.utils import MetricsLogger, span
        def loaded(names):
            return [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in names]
        assert not loaded(blocked)

        class Sink:
            path = "sink"
            def __init__(self):
                self.channels = {}
            def write_channel(self, shot, chn, spec, f, t, out, prefix="ece"):
                self.channels[(f"{prefix}_{shot}", chn)] = (spec, out)
            def flush(self):
                pass
            def close(self):
                pass

        cfg = Config(spec=SpecParams(cut_shot=0.1))
        rng = np.random.default_rng(0)
        import os
        os.makedirs("in")
        for s in (1, 2):
            write_shot_bin(f"in/shot_{s}.bin", rng.standard_normal((1, 50000)).astype(np.float32))
        svc = serve.EnhanceService(cfg, ModelConfig(filters=(4, 4)), n_channels=1, device="cpu")
        sink, manifest = Sink(), CampaignManifest("m.jsonl")
        with MetricsLogger("metrics.jsonl") as metrics, span("drain", metrics, sync=True):
            counts = serve.serve_once(svc, "in", StoreWriterPool.from_stores([sink]), manifest,
                                      metrics, verbose=False)
        assert counts == {"done": 2, "failed": 0}, counts
        assert sorted(sink.channels) == [("enhanced_1", 1), ("enhanced_2", 1)]
        assert not loaded(blocked)
        del sys.modules["h5py"]
        cli.main(["serve", "--watch-dir", "in", "--out", "e.hdf5", "--channels", "1",
                  "--cut-shot", "0.1", "--once", "--quiet", "--device", "cpu"])
        assert loaded(("h5py",)) and not loaded(("jax", "flax", "specenh", "matplotlib"))
        print("served")
    """)
    env = {**_env(), "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "served" in res.stdout


def test_cli_serve_help_runs_without_the_jax_package(tmp_path):
    """``python -m specenh_torch.cli serve --help`` in a tree without
    ``specenh/``: the port's flags, ``--device`` among them."""
    shutil.copytree(ROOT / "specenh_torch", tmp_path / "specenh_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "-m", "specenh_torch.cli", "serve", "--help"],
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(tmp_path)},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    for flag in ("--watch-dir", "--model-dir", "--once", "--writers", "--device"):
        assert flag in res.stdout, flag


def test_sweep_modules_load_without_jax():
    """The sweep, its CLI and the streamed split plan import without jax,
    flax, ``specenh``, h5py or matplotlib, and load none of them."""
    code = textwrap.dedent("""
        import sys
        blocked = ("jax", "flax", "specenh", "h5py", "matplotlib")
        for name in blocked:
            sys.modules[name] = None
        import specenh_torch.sweep, specenh_torch.cli, specenh_torch.train_stream
        import specenh_torch.data.grain_pipeline
        from specenh_torch.train import eval_loss
        from specenh_torch.bench.harness import make_production_predict_fn
        loaded = [m for m, v in sys.modules.items() if v is not None]
        assert not [m for m in loaded if m.split(".")[0] in blocked]
        print("loaded")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "loaded" in res.stdout


def test_cli_sweep_runs_without_the_jax_package(tmp_path):
    """``python -m specenh_torch.cli sweep --device cpu`` in a tree without
    ``specenh/``, on a store the port wrote: the artifacts and the final
    JSON line."""
    from specenh_torch.io.store import SpectrogramStore

    shutil.copytree(ROOT / "specenh_torch", tmp_path / "specenh_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    rng = np.random.default_rng(0)
    with SpectrogramStore(str(tmp_path / "s.hdf5")) as st:
        for chn in (1, 2):
            x = rng.random((256, 3 * 128)).astype(np.float32)
            st.write_channel("7", chn, x, np.arange(256.0), np.arange(384.0), x.round())
    cmd = [sys.executable, "-m", "specenh_torch.cli", "sweep", "--dataset", "s.hdf5",
           "--out-dir", "out", "--grid", "2layer", "--ker1", "3", "--ker2", "3", "--ker3",
           "3", "--conv1", "8", "--conv2", "8", "--epochs", "1", "--device", "cpu",
           "--no-time-configs", "--quiet"]
    res = subprocess.run(cmd, cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(tmp_path)},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["n_configs"] == 1 and line["best_index"] == 0
    assert sorted(os.listdir(tmp_path / "out")) == \
        ["best_model", "best_val_loss.png", "loss_comparisons.npz", "val_losses.npy"]


_PIPELINE_REFS = ("rescale_ref", "quantfilt_ref", "gaussblr_ref", "meansub_ref",
                  "_rect_minmax", "morph_ref", "pipeline_ref", "pipeline_stages_ref")


def test_pipeline_reference_copies_equal_jax_references():
    """The label pipeline's references are the JAX package's functions,
    and give its numbers, with OpenCV and with its emulation."""
    import inspect

    for name in _PIPELINE_REFS:
        port = textwrap.dedent(inspect.getsource(getattr(treference, name)))
        orig = textwrap.dedent(inspect.getsource(getattr(jreference, name)))
        assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False), name
    img = np.random.default_rng(8).random((96, 140)).astype(np.float32)
    for has_cv2 in sorted({False, treference.HAS_CV2}):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(treference, "HAS_CV2", has_cv2)
            mp.setattr(jreference, "HAS_CV2", has_cv2)
            got, want = treference.pipeline_stages_ref(img), jreference.pipeline_stages_ref(img)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k}, cv2 {has_cv2}")


@pytest.mark.parametrize("name", ["_omega_ref", "svd_denoise_ref", "svd_compute_signal_ref"])
def test_svd_reference_copies_equal_jax_references(name):
    """The SVD denoiser's float64 oracles are the JAX package's functions,
    and give its numbers (every band: default, explicit, use_optimal)."""
    import inspect

    port = textwrap.dedent(inspect.getsource(getattr(treference, name)))
    orig = textwrap.dedent(inspect.getsource(getattr(jreference, name)))
    assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False)
    m = np.random.default_rng(9).standard_normal((24, 40))
    if name == "_omega_ref":
        assert treference._omega_ref(0.6) == jreference._omega_ref(0.6)
    elif name == "svd_denoise_ref":
        for kw in ({}, {"start": 2, "stop": 5}, {"use_optimal": True}):
            np.testing.assert_array_equal(treference.svd_denoise_ref(m, **kw),
                                          jreference.svd_denoise_ref(m, **kw))
    else:
        np.testing.assert_array_equal(treference.svd_compute_signal_ref(m),
                                      jreference.svd_compute_signal_ref(m))


def test_analyses_and_raw_training_run_without_jax(tmp_path):
    """``ops.svd``, ``ops.crosspower``, ``e2e`` and the ``synth-shots``,
    ``convert-bin``, ``train-raw``, ``crosspower`` and ``denoise`` commands
    load and run on the CPU with jax, flax, h5py and ``specenh`` blocked;
    ``specenh_torch.cli`` imports without matplotlib; ``denoise`` loads
    h5py only to open its store."""
    code = textwrap.dedent("""
        import json, os, sys
        blocked = ("jax", "flax", "h5py", "specenh", "matplotlib")
        for name in blocked:
            sys.modules[name] = None
        import numpy as np, torch
        import specenh_torch.cli as cli
        from specenh_torch import Config, SpecParams, TrainConfig
        from specenh_torch.e2e import train_from_raw
        from specenh_torch.ops import svd
        from specenh_torch.ops.crosspower import ae_co2
        assert not [m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in blocked]
        del sys.modules["matplotlib"]
        m = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 70))).float()
        for out in (svd.denoise_signal(m), svd.denoise_signal(m, use_optimal=True),
                    svd.compute_signal(m), svd.deflate_top1(m)):
            assert out.shape == m.shape and torch.isfinite(out).all()
        x = torch.randn(3000)
        ampsp, f, t = ae_co2(x, x, np.arange(3000) / 1e6, nperseg=256)
        assert ampsp.shape == (len(t), 129) and (ampsp > 0).all()
        sp = SpecParams(cut_shot=0.07)
        traces = np.random.default_rng(1).standard_normal((2, sp.n_samples)).astype(np.float32)
        _, hist = train_from_raw(traces, Config(spec=sp), train_cfg=TrainConfig(epochs=1),
                                 device="cpu")
        assert np.isfinite(hist["val_loss"]).all()
        cli.main(["synth-shots", "--out", "raw", "--shots", "3", "--channels", "1",
                  "--samples", "40000"])
        cli.main(["convert-bin", "--data-dir", "raw", "--out-dir", "bin", "--channels", "1"])
        cli.main(["train-raw", "--binary", "--data-dir", "bin", "--out-dir", "tr",
                  "--channels", "1", "--cut-shot", "0.07", "--epochs", "1",
                  "--engine", "kernel", "--device", "cpu", "--quiet"])
        np.save("s.npy", np.random.default_rng(2).standard_normal(5000).astype(np.float32))
        cli.main(["crosspower", "--signal1", "s.npy", "--signal2", "s.npy", "--out-dir", "cp",
                  "--nperseg", "256", "--device", "cpu"])
        assert sorted(os.listdir("cp")) == ["ampsp.npy", "crosspower.png"]
        loaded = [m for m, v in sys.modules.items() if v is not None]
        assert not [m for m in loaded if m.split(".")[0] in ("jax", "flax", "h5py", "specenh")]
        del sys.modules["h5py"]
        from specenh_torch.io.store import SpectrogramStore
        with SpectrogramStore("s.hdf5") as st:
            spec = np.random.default_rng(3).random((256, 140)).astype(np.float32)
            st.write_channel("1", 1, spec, np.arange(256.0), np.arange(140.0), spec)
        cli.main(["denoise", "--dataset", "s.hdf5", "--out-dir", "den", "--device", "cpu"])
        assert sorted(os.listdir("den")) == ["svd_compare.png", "svd_denoised.npy"]
        assert "h5py" in sys.modules
        assert not [m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in ("jax", "flax", "specenh")]
        print("ran")
    """)
    # one BLAS and torch thread: the suite runs a worker per core
    env = {**_env(), "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "ran" in res.stdout


def test_q88_tables_and_stft_axes_equal_jax():
    """The baked OpenCV Q8.8 taps (and the rounding of other sizes), the
    auto sigma, and the spectrogram's frequency and time axes."""
    assert tenhance._CV_KX31_Q88 == jenhance._CV_KX31_Q88
    assert tenhance._CV_K3_Q88 == jenhance._CV_K3_Q88
    for k in (1, 3, 5, 7, 9, 15, 31):
        np.testing.assert_array_equal(tenhance.opencv_gauss_kernel_q88(k),
                                      jenhance.opencv_gauss_kernel_q88(k))
        assert tenhance.opencv_auto_sigma(k) == jenhance.opencv_auto_sigma(k)
    for sp in (SP, SpecParams(), SpecParams(nperseg=256, noverlap=128, cut_shot=0.05)):
        jsp = jconfig.SpecParams(**dataclasses.asdict(sp))
        for drop in (True, False):
            np.testing.assert_array_equal(tstft.spectrogram_freqs(sp, drop),
                                          jstft.spectrogram_freqs(jsp, drop))
        np.testing.assert_array_equal(tstft.spectrogram_times(sp), jstft.spectrogram_times(jsp))
        np.testing.assert_array_equal(tstft.spectrogram_times(sp, 30_000),
                                      jstft.spectrogram_times(jsp, 30_000))


def test_dataset_build_loads_no_h5py_until_a_store_opens():
    """Serving, training and the device half of the dataset build import
    and run without loading h5py (and without jax, flax or ``specenh``);
    opening a store loads it."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "flax", "specenh"):
            sys.modules[name] = None
        import numpy as np
        import specenh_torch.bench.harness, specenh_torch.train, specenh_torch.io
        import specenh_torch.io.native, specenh_torch.data.dataset
        from specenh_torch import Config, SpecParams
        from specenh_torch.bench.reference import pipeline_ref, ssim
        from specenh_torch.pipeline import process_shot_fn
        sp = SpecParams(cut_shot=0.05)
        x = np.random.default_rng(0).standard_normal((2, sp.n_samples)).astype(np.float32)
        specs, labels = process_shot_fn(Config(spec=sp), device="cpu")(x)
        assert labels.shape == (2, 256, sp.n_frames)
        assert ssim(labels[0].numpy(), pipeline_ref(specs[0].numpy())) > 0.999
        assert "h5py" not in sys.modules, "h5py loaded before a store opened"
        from specenh_torch.io.store import SpectrogramStore
        with SpectrogramStore(sys.argv[1]) as st:
            st.write_channel("1", 1, specs[0].numpy(), np.zeros(256), np.zeros(sp.n_frames),
                             labels[0].numpy())
        assert "h5py" in sys.modules
        print("built")
    """)
    with tempfile.TemporaryDirectory() as d:
        res = subprocess.run([sys.executable, "-c", code, os.path.join(d, "s.hdf5")],
                             cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "built" in res.stdout


def test_native_reader_builds_outside_native(tmp_path):
    """The port compiles ``native/specenh_native.cc`` into ``build/native/``
    and writes nothing into ``native/``: in a copy of the tree, the reader
    builds, reads a SPEC binary, and ``native/`` holds what it held."""
    shutil.copytree(ROOT / "specenh_torch", tmp_path / "specenh_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "native").mkdir()
    for name in ("specenh_native.cc", "Makefile"):
        shutil.copy(ROOT / "native" / name, tmp_path / "native")
    before = sorted((p.name, p.stat().st_mtime_ns) for p in (tmp_path / "native").iterdir())
    code = textwrap.dedent("""
        import numpy as np
        from specenh_torch.io import native
        from specenh_torch.io.binfmt import write_shot_bin
        assert native.native_available()
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        write_shot_bin("s.bin", x)
        assert (native.read_shot("s.bin", 2, 3) == x).all()
        print(native._library_path())
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    built = Path(res.stdout.split()[-1])
    assert built.parent == tmp_path / "build" / "native" and built.exists()
    after = sorted((p.name, p.stat().st_mtime_ns) for p in (tmp_path / "native").iterdir())
    assert after == before


def test_chip_smoke_fails_without_gpu(tmp_path):
    """No CUDA device here: non-zero exit and no result line; and alone in
    a directory without the port it fails too."""
    for cwd, env in ((ROOT, _env()), (tmp_path, {**os.environ, "PYTHONPATH": ""})):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


@pytest.fixture(scope="module")
def wts():
    return tak.build_kernel_weights(
        make_model(ModelConfig(), generator=torch.Generator().manual_seed(0)),
        torch.bfloat16)


def _specs(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


CASES = {
    "stft-dtype": (lambda w: tsf.stft_ft_log(torch.zeros(2, SP.n_samples, dtype=torch.float64), SP), TypeError),
    "stft-rank": (lambda w: tsf.stft_ft_log(torch.zeros(SP.n_samples), SP), ValueError),
    "stft-short": (lambda w: tsf.stft_ft_log(torch.zeros(2, SP.n_samples - 1), SP), ValueError),
    "stft-geometry": (lambda w: tsf.stft_ft_log(torch.zeros(2, 40000), SpecParams(nperseg=256, noverlap=128, cut_shot=0.05)), NotImplementedError),
    "tile-in-dtype": (lambda w: tak.ae_tile_in(w, _specs(2, 256, 384, dtype=torch.bfloat16), 3), TypeError),
    "tile-in-rows": (lambda w: tak.ae_tile_in(w, _specs(2, 128, 384), 3), ValueError),
    "tile-in-width": (lambda w: tak.ae_tile_in(w, _specs(2, 256, 383), 3), ValueError),
    "tile-in-strided": (lambda w: tak.ae_tile_in(w, _specs(2, 384, 256).transpose(1, 2), 3), ValueError),
    "conv-pool-dtype": (lambda w: tak.ae_conv_pool(w, _specs(6, 32, 128, 64)), TypeError),
    "conv-pool-channels": (lambda w: tak.ae_conv_pool(w, _specs(6, 16, 128, 64, dtype=torch.bfloat16)), ValueError),
    "convt-layer": (lambda w: tak.ae_convt(w, _specs(6, 32, 64, 32, dtype=torch.bfloat16), 1), ValueError),
    "convt-rank": (lambda w: tak.ae_convt(w, _specs(32, 64, 32, dtype=torch.bfloat16), 2), ValueError),
    "tile-out-shape": (lambda w: tak.ae_tile_out(w, _specs(6, 32, 128, 128, dtype=torch.bfloat16), 3), ValueError),
    "tile-out-batch": (lambda w: tak.ae_tile_out(w, _specs(5, 32, 256, 128, dtype=torch.bfloat16), 3), ValueError),
    "stft-tf-dtype": (lambda w: tsf.stft_tf_log(torch.zeros(2, SP.n_samples, dtype=torch.float64), SP), TypeError),
    "stft-tf-short": (lambda w: tsf.stft_tf_log(torch.zeros(2, SP.n_samples - 1), SP), ValueError),
    "tile-in-norm-layout": (lambda w: tak.ae_tile_in_norm(w, _specs(2, 257, 384), *_mm(2), 3, "ff"), ValueError),
    "tile-in-norm-dtype": (lambda w: tak.ae_tile_in_norm(w, _specs(2, 257, 384, dtype=torch.bfloat16), *_mm(2), 3, "ft"), TypeError),
    "tile-in-norm-frames": (lambda w: tak.ae_tile_in_norm(w, _specs(2, 383, 257), *_mm(2), 3, "tf"), ValueError),
    "tile-in-norm-freqs": (lambda w: tak.ae_tile_in_norm(w, _specs(2, 384, 255), *_mm(2), 3, "tf"), ValueError),
    "tile-in-norm-minmax": (lambda w: tak.ae_tile_in_norm(w, _specs(2, 257, 384), *_mm(3), 3, "ft"), ValueError),
    "train-in-dtype": (lambda w: ttk.ae_train_in(_tw(), _specs(2, 256, 128, dtype=torch.bfloat16)), TypeError),
    "train-in-pre-dtype": (lambda w: ttk.ae_train_in(_tw(), _specs(2, 256, 128), pre=True), TypeError),
    "train-in-shape": (lambda w: ttk.ae_train_in(_tw(), _specs(2, 128, 128)), ValueError),
    "train-conv-pool-channels": (lambda w: ttk.ae_train_conv_pool(_tw(), _specs(2, 16, 128, 64, dtype=torch.bfloat16)), ValueError),
    "train-loss-mask": (lambda w: ttk.ae_train_loss(_tw(), _bf(2, 32, 256, 128), _specs(2, 256, 128), _specs(3)), ValueError),
    "train-loss-labels-dtype": (lambda w: ttk.ae_train_loss(_tw(), _bf(2, 32, 256, 128), _bf(2, 256, 128), _specs(2)), TypeError),
    "train-dgrad-conv-layer": (lambda w: ttk.ae_train_dgrad_conv(_tw(), 2, _bf(2, 1, 256, 128), _bf(2, 32, 256, 128)), ValueError),
    "train-dgrad-conv-bits": (lambda w: ttk.ae_train_dgrad_conv(_tw(), 1, _bf(2, 32, 64, 32), _u8(2, 32, 128, 64)), ValueError),
    "train-dgrad-convt-gate": (lambda w: ttk.ae_train_dgrad_convt(_tw(), 2, _bf(2, 32, 128, 64), _bf(2, 32, 64, 32)), TypeError),
    "train-wgrad-layer": (lambda w: ttk.ae_train_wgrad(_tw(), 5, _bf(2, 32, 256, 128), _bf(2, 1, 256, 128)), ValueError),
    "train-wgrad-strided": (lambda w: ttk.ae_train_wgrad(_tw(), 4, _bf(2, 32, 128, 256).transpose(2, 3), _bf(2, 1, 256, 128)), ValueError),
    "train-sum-rank": (lambda w: ttk.ae_train_sum(_specs(8)), ValueError),
}


@functools.cache
def _tw():
    return ttk.build_train_weights(
        make_model(ModelConfig(), generator=torch.Generator().manual_seed(0)), torch.bfloat16)


def _mm(c):
    return torch.zeros(c, 1), torch.ones(c, 1)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrappers_check_inputs(wts, case):
    call, exc = CASES[case]
    with pytest.raises(exc):
        call(wts)


def test_cv_probe_copy_equals_jax_module():
    """``utils/cv_probe.py`` is the JAX package's module, docstrings aside."""
    port = (ROOT / "specenh_torch" / "utils" / "cv_probe.py").read_text()
    orig = (ROOT / "specenh" / "utils" / "cv_probe.py").read_text()
    assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False)


@pytest.mark.parametrize("module,name", [("parallel/multihost", "merge_stores"),
                                         ("models/keras_import", "_split_layers"),
                                         ("models/keras_import",
                                          "model_config_from_keras_weights")])
def test_parallel_and_keras_copies_equal_jax_modules(module, name):
    """The store merge and the Keras weight-list parsing are the JAX
    package's code, docstrings aside."""
    port = _top_level_source(ROOT / "specenh_torch" / f"{module}.py", name)
    orig = _top_level_source(ROOT / "specenh" / f"{module}.py", name)
    assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False)


def test_parallel_and_keras_modules_run_without_jax():
    """``parallel`` (mesh, data_parallel, dp_kernel, multihost),
    ``models.keras_import`` and ``utils.cv_probe`` import with jax, flax,
    ``specenh``, h5py and tensorflow blocked, and a gloo world of one trains
    through ``dp_fit`` on both engines and imports a Keras weight list,
    loading none of them."""
    code = textwrap.dedent("""
        import sys
        blocked = ("jax", "flax", "specenh", "h5py", "tensorflow", "keras")
        for name in blocked:
            sys.modules[name] = None
        import numpy as np, torch
        import specenh_torch.parallel
        import specenh_torch.utils.cv_probe
        from specenh_torch import ModelConfig, TrainConfig, train
        from specenh_torch.models.keras_import import (model_config_from_keras_weights,
                                                       params_from_keras_weights)
        from specenh_torch.parallel.data_parallel import dp_fit
        from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
        from specenh_torch.parallel.mesh import make_mesh
        from specenh_torch.parallel.multihost import host_shard, initialize_distributed
        assert initialize_distributed(backend="gloo") == (0, 1)
        assert host_shard([1, 2, 3]) == [1, 2, 3]
        rng = np.random.default_rng(0)
        mesh = make_mesh(device="cpu")
        for cfg, fn, n in ((ModelConfig(filters=(4, 4), input_shape=(64, 32, 1)), None, 3),
                           (ModelConfig(), dp_kernel_epoch_for, 2)):
            x = rng.random((n, *cfg.input_shape[:2])).astype(np.float32)
            st = train.create_state(cfg, TrainConfig(), device="cpu")
            _, h = dp_fit(st, x, x, mesh, epochs=1, batch_size=2,
                          epoch_fn=fn and fn(cfg, TrainConfig(), mesh))
            assert np.isfinite(h["loss"]).all()
        mesh.close()
        w = [rng.random(s).astype(np.float32) for s in
             ((3, 3, 1, 8), (8,), (3, 3, 8, 4), (4,), (3, 3, 4, 4), (4,), (3, 3, 8, 4), (8,),
              (3, 3, 8, 1), (1,))]
        cfg = model_config_from_keras_weights(w)
        train.create_state(cfg, TrainConfig(), device="cpu").model.load_state_dict(
            params_from_keras_weights(w, cfg))
        loaded = [m for m, v in sys.modules.items() if v is not None]
        assert not [m for m in loaded if m.split(".")[0] in blocked]
        print("trained")
    """)
    env = {**_env(), "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "trained" in res.stdout


def test_mesh_paths_run_without_jax():
    """``parallel.timeshard``, the channel-sharded service and
    ``serve_once`` of a mesh service run on a gloo world of one with jax,
    flax, ``specenh`` and h5py blocked (the daemon persisting into an
    in-memory sink), loading none of them."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        blocked = ("jax", "flax", "specenh", "h5py")
        for name in blocked:
            sys.modules[name] = None
        import numpy as np, torch
        from specenh_torch import ModelConfig, SpecParams
        from specenh_torch.bench.harness import make_enhance_shot_fn
        from specenh_torch.config import Config
        from specenh_torch.io.binfmt import write_shot_bin
        from specenh_torch.io.store import CampaignManifest
        from specenh_torch.parallel import timeshard as ts
        from specenh_torch.parallel.mesh import make_mesh
        from specenh_torch.serve import EnhanceService, serve_once

        class Sink:
            def __init__(self):
                self.path, self.channels = "sink", {}
            def write_channel(self, shot, chn, spec, f, t, out, prefix="ece"):
                self.channels[(shot, chn)] = out
            def flush(self):
                pass
            def close(self):
                pass

        tmesh = make_mesh(1, ("time",), device="cpu")
        dmesh = make_mesh(1, ("data",), device="cpu")
        sp = SpecParams(cut_shot=65536 / 5e5)
        x = np.random.default_rng(0).standard_normal(65536).astype(np.float32)
        fn = ts.make_sharded_enhance_shot(ModelConfig(), sp, tmesh)
        model = EnhanceService(Config(spec=sp), n_channels=1, device="cpu").params
        spec, labels, enh = ts.gather_shards(tmesh, *fn(model, ts.shard_of(tmesh, x)))
        assert spec.shape == labels.shape == enh.shape == (256, 256)
        svc = make_enhance_shot_fn(ModelConfig(), sp, device="cpu", mesh=dmesh)
        assert svc(model, x[None])[1].shape == (1, 256, 128)
        cfg = Config(spec=SpecParams(cut_shot=0.1))
        tiny = ModelConfig(filters=(4, 4), kernels=((3, 3), (3, 3)))
        service = EnhanceService(cfg, tiny, n_channels=2, device="cpu", mesh=dmesh)
        with tempfile.TemporaryDirectory() as d:
            write_shot_bin(os.path.join(d, "shot_1.bin"), np.ones((2, 50000), np.float32))
            manifest = CampaignManifest(os.path.join(d, "m.jsonl"))
            sink = Sink()
            assert serve_once(service, d, sink, manifest, verbose=False) == {"done": 1,
                                                                             "failed": 0}
            manifest.close()
        service.close()
        assert len(sink.channels) == 2
        tmesh.close()
        loaded = [m for m, v in sys.modules.items() if v is not None]
        assert not [m for m in loaded if m.split(".")[0] in blocked]
        print("served")
    """)
    env = {**_env(), "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "served" in res.stdout


def test_no_module_imports_the_test_exchange():
    """The in-process lock-step exchange (``tests/_torch_exchange.py``) is a
    test tool: no module of the port and not ``chip_smoke.py`` imports it
    or anything of ``tests``."""
    files = sorted((ROOT / "specenh_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] != "tests" and "_torch_exchange" not in n, (f, n)
