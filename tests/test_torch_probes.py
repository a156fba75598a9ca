"""The K11 toolchain probes (specenh_torch.probe_walls): the plain twins
against numpy slicing and against the repo's Mosaic probes' own Pallas
kernels (``scripts/probe_mosaic_walls.py``, in interpret mode on the CPU),
the wrappers on CPU, the launch geometry, the shapes, and the runner's
refusal without a CUDA device."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from specenh_torch import _build
from specenh_torch import probe_walls as pw

ROOT = Path(__file__).resolve().parents[1]
NUMPY = {
    "sublane_offset1_slice": lambda x: x[1:257],
    "in_kernel_transpose": lambda x: x.T,
    "stride2_lane_slice": lambda x: x[:, ::2],
}


@pytest.mark.parametrize("name", sorted(pw.PROBES))
def test_twin_matches_numpy(name):
    fn, plain, shape = pw.PROBES[name]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = plain(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), NUMPY[name](x))


@pytest.mark.parametrize("name", sorted(pw.PROBES))
def test_wrapper_on_cpu_runs_the_twin(name):
    before = [k.launches for k in (pw.ROW_SLICE, pw.TRANSPOSE, pw.STRIDE2)]
    assert pw.run_probe(name, "cpu", seed=4)
    assert [k.launches for k in (pw.ROW_SLICE, pw.TRANSPOSE, pw.STRIDE2)] == before


@pytest.mark.parametrize("name", sorted(pw.PROBES))
def test_wrapper_checks_its_input(name):
    fn, _, shape = pw.PROBES[name]
    with pytest.raises(ValueError):
        fn(torch.zeros(shape[0] + 1, shape[1]))
    with pytest.raises(ValueError):
        fn(torch.zeros(shape, dtype=torch.float64))


def _emulate(name, x):
    """The probe's kernel as ``csrc/probes.cu`` splits it, block by block
    over ``pw.grid`` and thread by thread: what each thread stages in
    shared memory and which output elements it writes from there.
    Returns the output and how many times each element was written."""
    rows, cols = x.shape
    gx, gy = pw.grid(name, x.shape)
    t = np.arange(pw.THREADS)
    if name == "sublane_offset1_slice":
        band, w = pw.RS_BAND, pw.RS_W
        out, count = np.zeros((pw.FB, cols), x.dtype), np.zeros((pw.FB, cols), int)
        for by in range(gy):
            for bx in range(gx):
                r0, c0 = by * band, bx * w
                s = np.full((band + 1, w), np.nan, x.dtype)          # the band and its halo row
                staged = np.zeros((band + 1, w), int)
                n = (band + 1) * w // 4                              # 80 copies of 16 bytes
                for e0 in range(0, n, pw.THREADS):                   # the kernel's strided loop
                    e = (e0 + t)[e0 + t < n]
                    r, q = e // (w // 4), e % (w // 4)
                    for k in range(4):
                        s[r, 4 * q + k] = x[r0 + r, c0 + 4 * q + k]
                        np.add.at(staged, (r, 4 * q + k), 1)
                assert (staged == 1).all()
                r, g = t // (w // 4), t % (w // 4)
                for k in range(4):                                   # one float4 a thread
                    out[r0 + r, c0 + 4 * g + k] = s[r + 1, 4 * g + k]  # from the row below
                    np.add.at(count, (r0 + r, c0 + 4 * g + k), 1)
        return out, count
    if name == "in_kernel_transpose":
        n, tile = rows, pw.TILE
        out, count = np.zeros((n, n), x.dtype), np.zeros((n, n), int)
        for by in range(gy):
            for bx in range(gx):
                r0, c0 = by * tile, bx * tile
                s = np.full((tile, tile + 4), np.nan, x.dtype)       # the padded tile
                for k in range(4):                                   # one 16-byte copy a thread
                    s[t // 4, 4 * (t % 4) + k] = x[r0 + t // 4, c0 + 4 * (t % 4) + k]
                c, q = t % tile, t // tile
                for k in range(4):                                   # one float4 a thread
                    out[c0 + c, r0 + 4 * q + k] = s[4 * q + k, c]
                    np.add.at(count, (c0 + c, r0 + 4 * q + k), 1)
        return out, count
    w = cols // 2
    out, count = np.zeros((rows, w), x.dtype), np.zeros((rows, w), int)
    for by in range(gy):
        for bx in range(gx):
            r0, c0 = by * pw.S2_BAND, bx * pw.S2_W
            s = np.full((pw.S2_BAND, 2 * pw.S2_W), np.nan, x.dtype)
            for j in range(pw.S2_BAND * 2 * pw.S2_W // 4 // pw.THREADS):
                e = t + j * pw.THREADS
                r, q = e // (pw.S2_W // 2), e % (pw.S2_W // 2)
                for k in range(4):
                    s[r, 4 * q + k] = x[r0 + r, 2 * c0 + 4 * q + k]
            r, g = t // (pw.S2_W // 4), t % (pw.S2_W // 4)
            pairs = s.reshape(pw.S2_BAND, pw.S2_W, 2)                # the row's float2s
            for i in range(4):
                out[r0 + r, c0 + 4 * g + i] = pairs[r, 4 * g + i, 0]  # their .x
                np.add.at(count, (r0 + r, c0 + 4 * g + i), 1)
    return out, count


@pytest.mark.parametrize("name", sorted(pw.PROBES))
def test_launch_geometry_writes_every_output_once(name):
    """The kernels' split over blocks and threads, emulated: every output
    element written exactly once, with the twin's value; each probe
    spreads over at least the card's 132 SMs."""
    shape = pw.PROBES[name][2]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    out, count = _emulate(name, x)
    assert (count == 1).all()
    np.testing.assert_array_equal(out, NUMPY[name](x))
    gx, gy = pw.grid(name, shape)
    assert gx * gy >= 132


@pytest.mark.parametrize("name, shape", [
    ("sublane_offset1_slice", (264, 200)), ("sublane_offset1_slice", (263, 256)),
    ("sublane_offset1_slice", (264, 96)), ("sublane_offset1_slice", (264, 32)),
    ("in_kernel_transpose", (256, 128)), ("in_kernel_transpose", (200, 200)),
    ("in_kernel_transpose", (8, 8)), ("stride2_lane_slice", (256, 500)),
    ("stride2_lane_slice", (254, 512)), ("stride2_lane_slice", (256, 64)),
])
def test_launch_geometry_refuses_what_the_entry_refuses(name, shape):
    with pytest.raises(ValueError):
        pw.grid(name, shape)


def test_launch_geometry_is_the_cuda_sources():
    """``probe_walls``' copy of the geometry equals ``csrc/probes.cu``'s."""
    src = (_build.CSRC / "probes.cu").read_text()
    consts = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["NT"] == pw.THREADS and consts["T"] == pw.TILE
    assert consts["RS_OUT"] == pw.FB and (consts["RS_BAND"], consts["RS_W"]) == (pw.RS_BAND, pw.RS_W)
    assert (consts["S2_BAND"], consts["S2_W"]) == (pw.S2_BAND, pw.S2_W)
    assert "cudaFuncSetAttribute" not in src and "extern __shared__" not in src


def _mosaic_sources():
    """{probe name: its source} of ``scripts/probe_mosaic_walls.py``'s
    ``PROBES``, by AST (the script is not imported)."""
    tree = ast.parse((ROOT / "scripts" / "probe_mosaic_walls.py").read_text())
    probes = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", "") == "PROBES")
    return {k.value: v.value for k, v in zip(probes.keys, probes.values)}


def _mosaic_kernel(src):
    """The kernel ``k`` and the ``out_shape`` of one Mosaic probe's source:
    its imports, constants and kernel executed, its ``pallas_call``'s
    ``out_shape`` evaluated; its input and its call left out."""
    tree = ast.parse(src)
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "pallas_call")
    out_shape = next(kw.value for kw in call.keywords if kw.arg == "out_shape")
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(n, ast.Assign) and isinstance(n.value, ast.Constant))]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "<mosaic probe>", "exec"), ns)
    return ns["k"], eval(compile(ast.Expression(out_shape), "<mosaic probe>", "eval"), ns)


def test_shapes_are_the_mosaic_probes():
    """The port's copy of the shapes equals the inputs of
    ``scripts/probe_mosaic_walls.py``'s probes, by name."""
    sources = _mosaic_sources()
    assert set(sources) == set(pw.PROBES)
    for name, src in sources.items():
        shape = re.search(r"x = jnp\.ones\((\(.*\)), jnp\.float32\)", src).group(1)
        assert eval(shape, {"FB": pw.FB}) == pw.PROBES[name][2], name


@pytest.mark.parametrize("name", sorted(pw.PROBES))
def test_twin_and_wrapper_match_the_mosaic_kernel(name):
    """The Mosaic probe's own kernel body through ``pl.pallas_call(...,
    interpret=True)`` on seeded input: the twin and the wrapper (on a CPU
    tensor) equal its output bit for bit (tolerance 0: these are copies)."""
    k, out_shape = _mosaic_kernel(_mosaic_sources()[name])
    fn, plain, shape = pw.PROBES[name]
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = np.asarray(pl.pallas_call(k, out_shape=out_shape, interpret=True)(jnp.asarray(x)))
    assert want.shape == tuple(out_shape.shape)
    np.testing.assert_array_equal(plain(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), want)


def test_probes_are_built_with_the_other_kernels():
    assert "probes" in _build.build_all.__defaults__[0]
    assert (_build.CSRC / "probes.cu").exists()


def test_runner_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        pw.main()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-m", "specenh_torch.probe_walls"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "OK" not in res.stdout
