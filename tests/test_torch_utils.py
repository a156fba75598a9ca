"""The port's observability utilities (``specenh_torch.utils``), its
figures and frame movie (``viz``) and ``tiles.reshape`` / ``patch_nchw``,
case for case as the JAX package's ``tests/test_utils.py``,
``tests/test_viz_and_grain.py`` and ``tests/test_tiles.py``, on the CPU;
the tile layouts equal JAX's exactly."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from specenh.data import tiles as jtiles
from specenh.viz.movie import dump_frames as jdump_frames
from specenh_torch.data import tiles
from specenh_torch.utils import MetricsLogger, nan_guard, profile_trace, psnr, span, ssim


def test_metrics_logger_jsonl(tmp_path):
    p = str(tmp_path / "m.jsonl")
    with MetricsLogger(p) as log:
        log.log("epoch", loss=0.5, epoch=1)
        log.log("span", name="stft", seconds=0.01)
    lines = [json.loads(line) for line in open(p)]
    assert lines[0]["event"] == "epoch" and lines[0]["loss"] == 0.5
    assert "time" in lines[1]


def test_span_logs_and_syncs(tmp_path):
    """A ``span`` event per block; ``sync=True`` with a nested result of
    CPU tensors (nothing to wait for) and with none."""
    p = str(tmp_path / "s.jsonl")
    with MetricsLogger(p) as log:
        with span("work", log):
            pass
        with span("sync", log, sync=True) as sp:
            sp.result = {"a": [torch.ones(3)], "b": (torch.zeros(2), 1)}
        with span("nothing", log, sync=True):
            pass
    recs = [json.loads(line) for line in open(p)]
    assert [r["name"] for r in recs] == ["work", "sync", "nothing"]
    assert all(r["seconds"] >= 0 for r in recs)


def test_nan_guard_catches_nan():
    """A NaN made in the backward raises under the guard; the anomaly mode
    is off again afterwards (a NaN in the forward alone does not raise:
    the kept divergence from ``jax_debug_nans``)."""
    x = torch.tensor([0.0], requires_grad=True)
    with nan_guard():
        with pytest.warns(UserWarning), pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0).sum().backward()
        assert torch.isnan(torch.log(torch.tensor(-1.0)))
    assert not torch.is_anomaly_enabled()


def test_ssim_psnr_sanity():
    rng = np.random.default_rng(0)
    a = rng.random((64, 64))
    assert ssim(a, a) == pytest.approx(1.0)
    assert psnr(a, a) == np.inf
    noisy = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1)
    assert 0 < ssim(a, noisy) < 0.9
    assert psnr(a, noisy) < 20


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (trace,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(trace) as fh:
        assert json.load(fh)["traceEvents"]


def test_reshape_and_patch_nchw_match_jax():
    a = np.random.default_rng(2).standard_normal((2, 256, 3905)).astype(np.float32)
    got = tiles.patch_nchw(a)
    assert got.shape == (60, 256, 128, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtiles.patch_nchw(jnp.asarray(a))))
    x = torch.zeros(5, 256, 128)
    assert tiles.reshape(x).shape == (5, 256, 128, 1)


@pytest.fixture(scope="module")
def specs():
    return np.random.default_rng(0).random((3, 256, 300)).astype(np.float32)


@pytest.fixture(scope="module")
def axes():
    return np.arange(256.0) * (5e5 / 512), np.arange(300) * 256 / 5e5


@pytest.mark.parametrize("figure", ["display", "triptych", "stages", "frame"])
def test_figures_render(tmp_path, specs, axes, figure):
    from specenh_torch.viz import plots

    f, t = axes
    p = str(tmp_path / "fig.png")
    if figure == "display":
        plots.display(specs[:, :, :256], specs[:, :, :256], p, f, t, n=2, seed=0)
    elif figure == "triptych":
        plots.plt_spec_shot(specs[0], specs[1], specs[2], "176053", 1, p, f, t)
    elif figure == "stages":
        plots.plot_stages({"quant": specs[1], "final": specs[2]}, specs[0], p, f, t)
    else:
        stack = specs.transpose(1, 2, 0)
        plots.plot_frame_view(stack, stack, stack, 100, "176053", t, f, p)
    assert os.path.getsize(p) > 1000


def test_dump_frames_matches_jax(tmp_path, specs, axes):
    """The same frame files, and the same count, as JAX's."""
    from specenh_torch.viz.movie import dump_frames

    f, t = axes
    stack = specs.transpose(1, 2, 0)
    n = dump_frames(stack, stack, stack, t, f, "7", str(tmp_path / "t"), start=3, stop=5)
    jn = jdump_frames(stack, stack, stack, t, f, "7", str(tmp_path / "j"), start=3, stop=5)
    assert n == jn == 2
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["s7-f00003.jpg", "s7-f00004.jpg"]
