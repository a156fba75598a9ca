"""The K11 toolchain probes (specenh_torch.probe_walls): the plain twins
against numpy slicing, the wrappers on CPU, the shapes against the repo's
Mosaic probes, and the runner's refusal without a CUDA device."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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


def test_shapes_are_the_mosaic_probes():
    """The port's copy of the shapes equals the inputs of
    ``scripts/probe_mosaic_walls.py``'s probes, by name."""
    tree = ast.parse((ROOT / "scripts" / "probe_mosaic_walls.py").read_text())
    probes = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", "") == "PROBES")
    sources = {k.value: v.value for k, v in zip(probes.keys, probes.values)}
    assert set(sources) == set(pw.PROBES)
    for name, src in sources.items():
        shape = re.search(r"x = jnp\.ones\((\(.*\)), jnp\.float32\)", src).group(1)
        assert eval(shape, {"FB": pw.FB}) == pw.PROBES[name][2], name


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
