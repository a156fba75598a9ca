"""``specenh_torch.ops.crosspower`` against the JAX package's
``specenh.ops.crosspower`` on the CPU, case for case as
``tests/test_crosspower.py``: the self-cross against the port's PSD, the
coherent line over independent noise, and ``ae_co2``'s contract, each
beside JAX's numbers on the same numpy-seeded signals."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from specenh.config import SpecParams as JSpecParams
from specenh.ops import crosspower as jcp
from specenh_torch.config import SpecParams
from specenh_torch.ops.crosspower import ae_co2, cross_power
from specenh_torch.ops.stft import stft_psd


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


@pytest.mark.parametrize("batch", [None, 2], ids=["one", "batched"])
def test_selfcross_equals_psd(batch):
    """cross_power(x, x) is the port's PSD transposed (rtol 1e-4, as JAX's
    test) and JAX's cross power (rtol 1e-4 of the largest value)."""
    sp = SpecParams(cut_shot=0.05)
    shape = (sp.n_samples,) if batch is None else (batch, sp.n_samples)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    cp = cross_power(_t(x), _t(x), sp).numpy()
    psd = stft_psd(_t(x), sp).numpy()
    np.testing.assert_allclose(np.swapaxes(cp, -1, -2), psd, rtol=1e-4, atol=1e-12)
    want = np.asarray(jcp.cross_power(jnp.asarray(x), jnp.asarray(x), JSpecParams(cut_shot=0.05)))
    np.testing.assert_allclose(cp, want, rtol=1e-4, atol=1e-4 * want.max())


def test_coherent_line_survives_incoherent_noise():
    """Two chords share an 80 kHz mode under independent noise: the cross
    power peaks at the shared line, 20x over the floor, as JAX's."""
    sp = SpecParams(cut_shot=0.1)
    rng = np.random.default_rng(1)
    t = np.arange(sp.n_samples) / sp.fs
    mode = np.sin(2 * np.pi * 8e4 * t)
    s1 = mode + 1.0 * rng.standard_normal(t.size)
    s2 = 0.7 * mode + 1.0 * rng.standard_normal(t.size)
    cp = cross_power(_t(s1), _t(s2), sp).numpy()
    mean_by_freq = cp.mean(axis=0)
    peak = int(np.argmax(mean_by_freq))
    assert abs(peak - int(round(8e4 / (sp.fs / sp.nperseg)))) <= 1
    assert mean_by_freq[peak] > 20 * np.median(mean_by_freq)
    want = np.asarray(jcp.cross_power(jnp.asarray(s1, jnp.float32), jnp.asarray(s2, jnp.float32),
                                      JSpecParams(cut_shot=0.1)))
    np.testing.assert_allclose(cp, want, rtol=1e-4, atol=1e-4 * want.max())


def test_ae_co2_contract_and_jax():
    """ampsp (time, freq), strictly positive, freq in kHz to Nyquist, time
    in ms inside the time base, the 250 kHz line at its bin; ``freq`` and
    ``time`` float64 and equal to JAX's, ``ampsp`` within rtol 1e-4 of
    its largest value."""
    fs, n, t0 = 1.0e6, 1 << 16, 0.1
    t = t0 + np.arange(n) / fs
    rng = np.random.default_rng(2)
    s1 = (np.sin(2 * np.pi * 2.5e5 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    s2 = (np.sin(2 * np.pi * 2.5e5 * t + 0.3) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    ampsp, freq, time = ae_co2(_t(s1), _t(s2), t)
    ampsp = ampsp.numpy()
    assert ampsp.shape == (len(time), len(freq)) == (127, 513)
    assert (ampsp > 0).all() and np.isfinite(np.log(ampsp)).all()
    assert abs(freq[-1] - fs / 2 / 1e3) < 1e-6
    assert time.min() >= t0 * 1e3 and time.max() <= t[-1] * 1e3
    assert abs(freq[int(np.argmax(ampsp.mean(axis=0)))] - 250.0) < 2.0
    ja, jf, jt = jcp.ae_co2(jnp.asarray(s1), jnp.asarray(s2), t)
    assert freq.dtype == time.dtype == np.float64
    np.testing.assert_array_equal(freq, jf)
    np.testing.assert_array_equal(time, jt)
    ja = np.asarray(ja)
    np.testing.assert_allclose(ampsp, ja, rtol=1e-4, atol=1e-4 * ja.max())


def test_ae_co2_floor_and_lengths():
    """Signals of unequal length cut to the shortest; an all-zero pair
    gives float32's smallest normal everywhere, as JAX's floor."""
    t = np.arange(5000) / 1.667e6
    z = np.zeros(6000, np.float32)
    ampsp, freq, time = ae_co2(_t(z), _t(z[:5500]), t, nperseg=256)
    ja, _, jt = jcp.ae_co2(jnp.asarray(z), jnp.asarray(z[:5500]), t, nperseg=256)
    assert ampsp.shape == np.asarray(ja).shape == (len(jt), 129)
    np.testing.assert_array_equal(time, jt)
    assert (ampsp.numpy() == np.finfo(np.float32).tiny).all()
