"""Guards of the port: it imports nothing of the JAX package and serves
and trains without jax, flax, h5py or ``specenh``, also from a tree that
has no ``specenh/``, where ``python -m specenh_torch.cli sweep`` runs too;
h5py is imported only inside the calls that open a store, matplotlib only
where a figure is drawn; its own copies of the JAX package's config,
references, Q8.8 tables, STFT axes, host IO, record pipeline and plots
equal the originals; the native reader builds outside ``native/``;
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
        assert ssim(specs[0].numpy(), spectrogram_ref(shot[0], sp)) > 0.99
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
    """spectrogram_ref and ssim give exactly the JAX package's numbers."""
    sp = SpecParams(cut_shot=0.05)
    sig = np.random.default_rng(3).standard_normal(sp.n_samples + 11).astype(np.float32)
    np.testing.assert_array_equal(spectrogram_ref(sig, sp), jspectrogram_ref(sig, sp)[0])
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


# module -> the JAX package's definitions it copies, and nothing else
_COPIES = {"data/grain_pipeline": ["RecordSlice"],
           "viz/plots": ["plot_val_loss", "plot_svd_compare"]}


@pytest.mark.parametrize("module,name", [(m, n) for m, names in _COPIES.items() for n in names])
def test_data_and_viz_copies_equal_jax_modules(module, name):
    """The streamed split plan's unit (``RecordSlice``), the sweep's loss
    figure and the SVD comparison figure are the JAX package's code,
    docstrings aside; each copy holds the definitions it copies alone."""
    port_path = ROOT / "specenh_torch" / f"{module}.py"
    port = _top_level_source(port_path, name)
    orig = _top_level_source(ROOT / "specenh" / f"{module}.py", name)
    assert _ast_without_docstrings(port, True) == _ast_without_docstrings(orig, False)
    defs = [n.name for n in ast.parse(port_path.read_text()).body if hasattr(n, "name")]
    assert defs == _COPIES[module]


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
