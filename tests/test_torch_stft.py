"""The port's STFT (specenh_torch.ops.stft / stft_fused, plain twins on CPU)
against the JAX package: the float64 basis, the reference spectrogram and
the K1 kernel's log-PSD + min/max (JAX in interpret mode)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from specenh.config import SpecParams
from specenh.ops import stft as jstft
from specenh.ops import stft_fused as jsf
from specenh_torch.bench.reference import spectrogram_ref
from specenh_torch.ops import stft as tstft
from specenh_torch.ops import stft_fused as tsf

SP = SpecParams(cut_shot=0.2)  # 100k samples -> 389 frames, 3 tiles


@pytest.fixture(scope="module")
def traces():
    return np.random.default_rng(0).standard_normal((2, SP.n_samples)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ft(traces):
    out, mn, mx, _ = jsf.stft_ft_log(jnp.asarray(traces), SP, bf16=False,
                                      interpret=True)
    return np.asarray(out), np.asarray(mn), np.asarray(mx)


@pytest.mark.parametrize("detrend,scaling,window", [
    ("linear", "density", "hamm"),
    ("constant", "spectrum", "hann"),
    ("none", "density", "boxcar"),
])
def test_basis_matches_jax(detrend, scaling, window):
    want = jstft._basis_np(512, detrend, 5e5, scaling, window)
    got = tstft._basis_np(512, detrend, 5e5, scaling, window)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    assert got[2] == want[2]


def test_psd_weights_match_jax():
    _, _, want = jstft.stft_basis(SP)
    np.testing.assert_allclose(tstft.psd_weights(SP), np.asarray(want), rtol=1e-7)


def test_frame_signal_matches_jax(traces):
    want = np.asarray(jstft.frame_signal(jnp.asarray(traces), 512, 256))
    got = tstft.frame_signal(torch.from_numpy(traces), 512, 256).numpy()
    np.testing.assert_array_equal(got, want)


def test_spectrogram_matches_jax(traces):
    want = np.asarray(jstft.spectrogram(jnp.asarray(traces), SP))
    got = tstft.spectrogram(torch.from_numpy(traces), SP).numpy()
    assert got.shape == want.shape == (2, 256, SP.n_frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_spectrogram_matches_scipy(traces):
    """Against the SciPy recipe, loaded by path as the port loads it."""
    got = tstft.spectrogram(torch.from_numpy(traces), SP).numpy()
    for c in range(2):
        np.testing.assert_allclose(got[c], spectrogram_ref(traces[c], SP)[0], atol=1e-4)


def test_stft_ft_log_plain_matches_jax_kernel(traces, jax_ft):
    out, mn, mx = jax_ft
    got, gmn, gmx = tsf.stft_ft_log_plain(torch.from_numpy(traces), SP)
    assert got.shape == (2, SP.n_freqs_onesided, SP.n_frames)
    np.testing.assert_allclose(got.numpy(), out[:, :257, : SP.n_frames],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gmn.numpy(), mn, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gmx.numpy(), mx, rtol=1e-5, atol=1e-4)


def test_stft_ft_log_on_cpu_runs_the_twin(traces):
    before = tsf.STFT_KERNEL.launches
    x = torch.from_numpy(traces)
    for a, b in zip(tsf.stft_ft_log(x, SP), tsf.stft_ft_log_plain(x, SP)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tsf.STFT_KERNEL.launches == before


def test_spectrogram_fused_matches_jax(traces):
    want = np.asarray(jsf.spectrogram_fused(jnp.asarray(traces), SP, bf16=False,
                                            interpret=True))
    got = tsf.spectrogram_fused(torch.from_numpy(traces), SP).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_supported_matches_jax():
    for sp in (SP, SpecParams(nperseg=256, noverlap=128), SpecParams(noverlap=384)):
        assert tsf.supported(sp) == jsf.supported(sp)


def test_kernel_operands_pad_to_blocks():
    """The FFT kernel's operands: the float64 table (window and twiddles)
    and the one-sided weights, rounded to float32 once, whole blocks of
    frames in the partials' shape."""
    table, weights = tsf._kernel_operands(SP, torch.device("cpu"))
    assert table.dtype == weights.dtype == torch.float32
    assert table.shape == (512 + 2 * 256 + 2 * 257,) and weights.shape == (257,)
    np.testing.assert_array_equal(table.numpy(), tsf.fft_table(SP).astype(np.float32))
    np.testing.assert_array_equal(weights.numpy(), tstft.psd_weights(SP).astype(np.float32))
    assert -(-SP.n_frames // tsf._BLOCK_T) == 25 and tsf._TF_LD % 32 == 0
