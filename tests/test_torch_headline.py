"""The port's headline benchmark (``specenh_torch.bench.headline``) and
``cli bench`` on the CPU, at small sizes (``device="cpu"``: the kernels'
plain twins, the host's clock): the JSON line has the JAX headline's keys
in its order (read from the JAX module's AST, JAX does not run), every
measure runs end to end and returns its keys, each of the four quality
gates stops the run on a planted fault with nothing printed, the cached
CPU baseline is read and never written, the synthetic stream store is
``scripts/synth_store.py``'s bit for bit and reads the same from HDF5 and
from memory, and without a card every entry point raises."""

import ast
import contextlib
import functools
import importlib.util
import io
import json
import math
import os
import sys
import tempfile
from pathlib import Path

import h5py
import numpy as np
import pytest
import threadpoolctl
import torch

from specenh_torch import cli
from specenh_torch.bench import headline as H
from specenh_torch.config import PatchSpec, SpecParams
from specenh_torch.io.memstore import MemoryStore
from specenh_torch.train_stream import _chunk_plans, _read_chunk, plan_stream_split

ROOT = Path(__file__).resolve().parents[1]
SMALL = SpecParams(cut_shot=0.07)  # 135 frames: one tile
MEASURES = ("measure_card", "measure_train", "measure_svd", "measure_deep3_serving",
            "measure_longshot", "measure_stream_host")
GATES = ("spectrogram", "enhanced-output", "SVD denoise", "SVD compute_signal")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS thread: the suite runs a worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _jax_keys():
    """The JAX headline's JSON keys in their order: ``main``'s record, then
    the keys each ``rec.update(measure_*())`` adds, each function's dict
    literals and ``rec[...]`` assignments in source order."""
    tree = ast.parse((ROOT / "specenh" / "bench" / "headline.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def keys_of(fn):
        found = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                found += [(k.lineno, k.col_offset, k.value) for k in node.keys
                          if isinstance(k, ast.Constant)]
            elif (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
                  and isinstance(node.targets[0].value, ast.Name)
                  and node.targets[0].value.id == "rec"
                  and isinstance(node.targets[0].slice, ast.Constant)):
                found.append((node.lineno, node.col_offset, node.targets[0].slice.value))
        return [k for *_, k in sorted(found)]

    main = fns["main"]
    by_fn = {"main": keys_of(main)}
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"):
            name = node.args[0].func.id
            by_fn[name] = keys_of(fns[name])
    return by_fn


def _small(mp, stream_dir):
    """Every measure at a small size on the CPU (the functions ``main``
    calls through the module), the temp directory ``stream_dir``."""
    small = {
        "measure_card": dict(n_channels=2, sp=SMALL, device="cpu"),
        "measure_train": dict(n=1, bs=1, device="cpu"),
        "measure_svd": dict(n_channels=1, device="cpu"),
        "measure_deep3_serving": dict(n_channels=1, sp=SMALL, device="cpu"),
        "measure_longshot": dict(sp=SMALL, device="cpu"),
        "measure_stream_host": dict(n_shots=1, n_channels=2, chunk_tiles=16),
    }
    mp.setattr(tempfile, "tempdir", str(stream_dir))
    results = {}

    def recorded(name, fn):
        @functools.wraps(fn)
        def call(*a, **k):
            results[name] = out = fn(*a, **k)
            return out
        return call

    for name, kw in small.items():
        mp.setattr(H, name, recorded(name, functools.partial(getattr(H, name), **kw)))
    return results


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """``main(trace_dir=...)`` once with every measure small: its stdout,
    stderr, each measure's result and the trace directory."""
    d = tmp_path_factory.mktemp("headline")
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        results = _small(mp, d)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            H.main(trace_dir=str(d / "trace"))
    return dict(out=out.getvalue(), err=err.getvalue(), results=results, trace=d / "trace")


def test_line_has_the_jax_keys_in_their_order(bench_run):
    lines = bench_run["out"].splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    want = [k for keys in _jax_keys().values() for k in keys]
    assert len(want) == 17
    assert list(rec) == want
    assert rec["unit"] == "spectrograms/s" and "card" in rec["metric"]
    for k, v in rec.items():
        if k not in ("metric", "unit"):
            assert isinstance(v, float) and math.isfinite(v) and v > 0, (k, v)


@pytest.mark.parametrize("name", MEASURES)
def test_each_measure_returns_its_jax_keys(bench_run, name):
    got = bench_run["results"][name]
    if name == "measure_card":  # spectrograms/s: main's value and vs_baseline
        assert isinstance(got, float) and math.isfinite(got) and got > 0
        return
    assert list(got) == _jax_keys()[name]
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got


def test_value_against_the_cached_baseline(bench_run):
    rec = json.loads(bench_run["out"])
    with open(H.BASELINE_CACHE) as fh:
        cpu = json.load(fh)["spectrograms_per_sec_cpu"]
    card = bench_run["results"]["measure_card"]
    assert rec["value"] == round(card, 2)
    assert rec["vs_baseline"] == round(card / cpu, 2)


def test_gate_lines_store_and_trace(bench_run):
    err = bench_run["err"]
    for line in ("# spectrogram SSIM vs CPU reference: ",
                 "# enhanced-output SSIM vs f32 service: ",
                 "# SVD denoise SSIM vs numpy reference: ",
                 "# SVD compute_signal SSIM vs numpy reference: "):
        assert line in err, line
    assert "# stream host pipeline, store HDF5 " in err
    assert list(bench_run["trace"].glob("*.pt.trace.json"))


def _noisy(fn, scale=0.5):
    """``fn`` with uniform noise of ``scale`` added to its tensor result."""
    g = torch.Generator().manual_seed(0)

    def noisy(*a, **k):
        out = fn(*a, **k)
        return out + scale * torch.rand(out.shape, generator=g)
    return noisy


def _faulty_service(make, which):
    """``make_enhance_shot_fn`` whose bf16 service perturbs its specs or its
    enhanced output; the float32 service stays right."""
    def wrapped(*a, **k):
        fn = make(*a, **k)
        if k.get("dtype", torch.bfloat16) is None:
            return fn
        noise = _noisy(lambda t: t)

        def faulty(w, traces):
            specs, enhanced = fn(w, traces)
            return (noise(specs), enhanced) if which == 0 else (specs, noise(enhanced))

        faulty.prepare = fn.prepare
        return faulty
    return wrapped


@pytest.mark.parametrize("gate", GATES)
def test_gate_stops_the_run_on_a_planted_fault(gate, bench_run, tmp_path, monkeypatch,
                                               capsys):
    if gate.startswith("SVD"):
        which = H.denoise_signal if gate == "SVD denoise" else H.compute_signal
        monkeypatch.setattr(H, which.__name__, _noisy(which))
    else:
        monkeypatch.setattr(H, "make_enhance_shot_fn",
                            _faulty_service(H.make_enhance_shot_fn, GATES.index(gate)))
    _small(monkeypatch, tmp_path)
    if gate.startswith("SVD"):  # the measures before it, as they ran
        for name in ("measure_card", "measure_train"):
            monkeypatch.setattr(H, name, lambda r=bench_run["results"][name], **k: r)
    with pytest.raises(SystemExit, match=f"quality gate failed: {gate} SSIM"):
        H.main()
    assert capsys.readouterr().out == ""


def test_cached_baseline_is_read_and_never_written():
    st = os.stat(H.BASELINE_CACHE)
    before = Path(H.BASELINE_CACHE).read_bytes()
    with open(H.BASELINE_CACHE) as fh:
        cached = json.load(fh)
    assert cached["keras_included"] is True
    assert H.get_cpu_baseline() == cached["spectrograms_per_sec_cpu"]
    assert Path(H.BASELINE_CACHE).read_bytes() == before
    assert os.stat(H.BASELINE_CACHE).st_mtime_ns == st.st_mtime_ns


@pytest.mark.parametrize("cache", ["stft_only", "missing"])
def test_baseline_without_keras_exits(cache, tmp_path, monkeypatch):
    """An STFT-only or missing cache, tensorflow blocked: an error, and no
    file written or changed."""
    path = tmp_path / "bench_baseline_cpu.json"
    if cache == "stft_only":
        path.write_text(json.dumps({"spectrograms_per_sec_cpu": 9.0, "keras_included": False}))
    before = path.read_bytes() if path.exists() else None
    monkeypatch.setattr(H, "BASELINE_CACHE", str(path))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(SystemExit, match="tensorflow does not import"):
        H.get_cpu_baseline()
    assert (path.read_bytes() if path.exists() else None) == before
    assert sorted(os.listdir(tmp_path)) == (["bench_baseline_cpu.json"] if before else [])


def _datasets(path):
    with h5py.File(path, "r") as f:
        out = {}
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_synthetic_store_is_the_scripts(tmp_path):
    """One shot x 2 channels: every dataset of ``scripts/synth_store.py``'s
    file, bit for bit and in dtype."""
    spec = importlib.util.spec_from_file_location("synth_store_script",
                                                  ROOT / "scripts" / "synth_store.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.synth_store(str(tmp_path / "script.hdf5"), 1, 2, verbose=False)
    H.synth_store(str(tmp_path / "port.hdf5"), 1, 2)
    want, got = _datasets(tmp_path / "script.hdf5"), _datasets(tmp_path / "port.hdf5")
    assert sorted(got) == sorted(want) and len(want) == 8
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert sorted(os.listdir(tmp_path)) == ["port.hdf5", "script.hdf5"]


def test_stream_reader_same_tiles_from_hdf5_and_memory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = str(tmp_path / "specenh_torch_bench_stream_1x2.hdf5")

    def chunks(store):
        plans = _chunk_plans(plan_stream_split(store, num_samples=1).train, 16)
        return [_read_chunk(store, p, PatchSpec()) for p in plans]

    with H.open_stream_store(1, 2) as (store, what):
        assert what == f"HDF5 {path}"
        want = chunks(store)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with H.open_stream_store(1, 2) as (store, what):
        assert isinstance(store, MemoryStore) and what.startswith("in memory")
        got = chunks(store)
    assert [len(x) for x, _ in want] == [16, 16, 4]
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_cli_bench_reaches_headline_main(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(H, "main", lambda trace_dir=None: seen.append(trace_dir))
    cli.main(["bench", "--trace-dir", str(tmp_path)])
    cli.main(["bench"])
    assert seen == [str(tmp_path), None]


@pytest.mark.parametrize("entry", [*MEASURES[:5], "cli bench"])
def test_without_a_card_each_entry_point_raises(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "cli bench":
            cli.main(["bench"])
        else:
            getattr(H, entry)()
