"""Guards of the port: it imports and serves without jax, flax or h5py;
``chip_smoke.py`` fails where there is no GPU; the kernel wrappers check
their inputs before either path."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from specenh_torch.ops import ae_kernel as tak
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
        for name in ("jax", "flax", "h5py"):
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
        assert not [m for m in loaded if m.split(".")[0] in ("jax", "flax", "h5py")]
        print("served")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "served" in res.stdout


def test_no_jax_imports_in_the_port():
    files = sorted((ROOT / "specenh_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "flax", "h5py"), (f, n)
                # of the JAX package only its jax-free config is imported
                assert not n.startswith("specenh.") or n == "specenh.config", (f, n)


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
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrappers_check_inputs(wts, case):
    call, exc = CASES[case]
    with pytest.raises(exc):
        call(wts)
