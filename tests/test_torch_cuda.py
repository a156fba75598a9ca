"""The CUDA kernels against their plain twins, on a GPU (marker ``gpu``;
skipped where no CUDA device is present).  This file imports no jax, so it
runs where only torch is installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from specenh_torch import ModelConfig, SpecParams
from specenh_torch.models.autoencoder import make_model
from specenh_torch.ops import ae_kernel as tak
from specenh_torch.ops import stft_fused as tsf

pytestmark = pytest.mark.gpu

SP = SpecParams(cut_shot=0.2)
GEOMETRIES = [
    ModelConfig(),
    ModelConfig(kernels=((1, 1), (1, 1)), out_kernel=(1, 1)),
    ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
    ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5)),
    ModelConfig(filters=(64, 64), kernels=((7, 7), (7, 7)), out_kernel=(7, 7)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def traces(cuda):
    x = np.random.default_rng(0).standard_normal((3, SP.n_samples + 7))
    return torch.from_numpy(x.astype(np.float32)).to(cuda)


def test_stft_kernel_matches_twin(traces):
    before = tsf.STFT_KERNEL.launches
    out, mn, mx = tsf.stft_ft_log(traces, SP)
    ref, rmn, rmx = tsf.stft_ft_log_plain(traces, SP)
    assert tsf.STFT_KERNEL.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)
    torch.testing.assert_close(mn, rmn, rtol=0, atol=2e-3)
    torch.testing.assert_close(mx, rmx, rtol=0, atol=2e-3)


@pytest.mark.parametrize("cfg", GEOMETRIES, ids=["k3", "k1", "k5", "k7", "manual", "64x64k7"])
def test_ae_kernels_match_module(cuda, traces, cfg):
    model = make_model(cfg, generator=torch.Generator().manual_seed(1), device=cuda).eval()
    specs = tsf.spectrogram_fused(traces, SP)
    with torch.no_grad():
        want = tak.ae_kernel_enhance_specs_plain(model, specs, 3)
    got = tak.ae_kernel_enhance_specs(tak.build_kernel_weights(model, torch.float32), specs, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    got16 = tak.ae_kernel_enhance_specs(tak.build_kernel_weights(model, torch.bfloat16), specs, 3)
    assert float((got16 - want).abs().max()) < 2e-2


def test_weights_on_another_device_raise(traces):
    wts = tak.build_kernel_weights(make_model(ModelConfig(), generator=torch.Generator()))
    with pytest.raises(ValueError):
        tak.ae_tile_in(wts, tsf.spectrogram_fused(traces, SP), 3)
