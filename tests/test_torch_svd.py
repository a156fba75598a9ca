"""``specenh_torch.ops.svd`` against the JAX package's ``specenh.ops.svd``
and the float64 NumPy recipes of denoising_by_svd.ipynb cell 1 (the port's
``bench.reference`` copies), case for case as ``tests/test_svd.py``, on the
same numpy-seeded inputs: a (256, 500) rank-6 matrix plus noise, the
0.2 s reference spectrogram, batches and the zero-count quirks.

Tolerances are those of ``tests/test_svd.py`` (relative to the matrix's
max |value|, or SSIM >= 0.995 of the min-max normalized images where a
band edge sits in the noise spectrum), for the port against the float64
reference and against JAX alike: the two float32 packages differ in their
QR, eigh and start basis, not in what they compute."""

import numpy as np
import pytest
import threadpoolctl
import torch

import jax.numpy as jnp

from specenh.bench import reference_cpu as jref
from specenh.ops import svd as jsvd
from specenh_torch.bench import reference as ref
from specenh_torch.bench.reference import ssim
from specenh_torch.ops import svd


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS/LAPACK thread in this module: the suite runs a
    worker per core, and these small factorisations and convolutions slow
    ten-fold when every worker's thread pools spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _lowrank_plus_noise(seed=0, shape=(256, 500), rank=6, noise=0.1):
    rng = np.random.default_rng(seed)
    m = np.zeros(shape)
    for i in range(rank):
        m += np.outer(rng.standard_normal(shape[0]), rng.standard_normal(shape[1])) * (
            4.0 / (i + 1)
        )
    return m + noise * rng.standard_normal(shape)


def _flat_spectrum(n, seed):
    """Orthogonal plus a little noise: a flat spectrum, Gavish-Donoho
    count 0 (the reference's negative-slice quirk)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q + 0.01 * rng.standard_normal((n, n))


@pytest.fixture(scope="module")
def mat():
    return _lowrank_plus_noise()


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()) / scale


def _norm(x):
    x = np.asarray(x, np.float64)
    return (x - x.min()) / (x.max() - x.min())


@pytest.mark.parametrize("beta", [0.1, 0.25, 256 / 3905, 1.0])
def test_omega_equals_jax(beta):
    """The float32 cubic fit, bit for bit JAX's."""
    assert float(svd.omega(beta)) == float(jsvd.omega(beta))
    want = 0.56 * beta**3 - 0.95 * beta**2 + 1.82 * beta + 1.43
    np.testing.assert_allclose(float(svd.omega(beta)), want, rtol=1e-6)


def test_gavish_donoho_count_equals_jax(mat):
    """On the float64 spectrum rounded to float32, single and batched (a
    flat spectrum: count 0)."""
    s64 = np.linalg.svd(mat, compute_uv=False)
    beta = min(mat.shape) / max(mat.shape)
    t_star = (0.56 * beta**3 - 0.95 * beta**2 + 1.82 * beta + 1.43) * np.median(s64)
    want = int((s64 > t_star).sum())
    assert int(svd.gavish_donoho_count(_t(s64), mat.shape)) == want
    assert int(jsvd.gavish_donoho_count(_j(s64), mat.shape)) == want
    flat = np.linalg.svd(_flat_spectrum(256, 11)[:, :256], compute_uv=False)
    s = np.stack([s64[:256], flat])
    got = svd.gavish_donoho_count(_t(s), (256, 500)).tolist()
    assert got == np.asarray(jsvd.gavish_donoho_count(_j(s), (256, 500))).tolist()
    assert got[0] == want and got[1] == 0


def test_top_k_svd_accuracy(mat):
    """Top-6 singular values within rtol 1e-4 of float64 and of JAX's;
    the rank-6 reconstruction at the float64 optimum, rank 8 at its
    Eckart-Young error."""
    u, s, vh = (x.numpy() for x in svd.top_k_svd(_t(mat), 16))
    s64 = np.linalg.svd(mat, compute_uv=False)
    np.testing.assert_allclose(s[:6], s64[:6], rtol=1e-4)
    np.testing.assert_allclose(s[6:8], s64[6:8], rtol=5e-2)
    _, js, _ = jsvd.top_k_svd(_j(mat), 16)
    np.testing.assert_allclose(s[:6], np.asarray(js)[:6], rtol=1e-4)
    u64, s64f, v64 = np.linalg.svd(mat, full_matrices=False)
    r6 = u[:, :6] @ np.diag(s[:6]) @ vh[:6]
    best6 = u64[:, :6] @ np.diag(s64f[:6]) @ v64[:6]
    assert np.abs(r6 - best6).max() / np.abs(mat).max() < 1e-3
    r8 = u[:, :8] @ np.diag(s[:8]) @ vh[:8]
    assert np.linalg.norm(mat - r8) < np.linalg.norm(s64[8:]) * 1.001


# name -> (denoise_signal kwargs, tolerance of the max |diff| / max |mat|)
DENOISE_CASES = {
    "default": (dict(), 1e-4),
    "band": (dict(start=2, stop=5), 1e-3),
    "clamped": (dict(start=-5, stop=10_000), 1e-4),
    "svd-default": (dict(method="svd"), 1e-4),
    "svd-band": (dict(start=2, stop=5, method="svd"), 1e-3),
}


@pytest.mark.parametrize("case", list(DENOISE_CASES))
def test_denoise_signal_matches_reference_and_jax(mat, case):
    kw, tol = DENOISE_CASES[case]
    got = svd.denoise_signal(_t(mat), **kw).numpy()
    want = ref.svd_denoise_ref(mat, start=kw.get("start"), stop=kw.get("stop"))
    scale = np.abs(mat).max()
    assert _rel(got, want, scale) < tol
    assert _rel(got, jsvd.denoise_signal(_j(mat), **kw), scale) < tol


@pytest.mark.parametrize("method", ["auto", "svd"])
def test_denoise_optimal(mat, method):
    """The band edge sits in the noise spectrum: SSIM >= 0.995 and a loose
    max, against float64 and against JAX."""
    got = svd.denoise_signal(_t(mat), use_optimal=True, method=method).numpy()
    jgot = np.asarray(jsvd.denoise_signal(_j(mat), use_optimal=True, method=method))
    want = ref.svd_denoise_ref(mat, use_optimal=True)
    for other in (want, jgot):
        assert ssim(_norm(got), _norm(other)) > 0.995
        assert _rel(got, other, np.abs(mat).max()) < 5e-3


@pytest.mark.parametrize("method", ["gram", "subspace", "svd"])
def test_compute_signal(mat, method):
    """SSIM >= 0.995 against float64 (the reference's accumulated rank-1
    products) and against JAX's same method."""
    got = svd.compute_signal(_t(mat), method=method).numpy()
    want = ref.svd_compute_signal_ref(mat)
    jgot = np.asarray(jsvd.compute_signal(_j(mat), method=method))
    assert ssim(_norm(got), _norm(want)) > 0.995
    assert ssim(_norm(got), _norm(jgot)) > 0.995


@pytest.mark.parametrize("method", ["gram", "subspace"])
def test_compute_signal_band_beyond_kmax(method):
    """2*num_sing exceeds the K_MAX subspace: the subspace method takes
    the exact band (the host-side branch), the Gram method is exact
    anyway; wide and tall (both Gram sides), within 5e-3 of float64 and of
    JAX."""
    rng = np.random.default_rng(17)
    n_sig = svd.K_MAX
    qm, _ = np.linalg.qr(rng.standard_normal((160, 160)))
    qn, _ = np.linalg.qr(rng.standard_normal((220, 220)))
    s = np.concatenate([np.linspace(80.0, 30.0, n_sig), np.full(160 - n_sig, 0.01)])
    m = (qm * s) @ qn[:, :160].T  # (160, 220), 64 dominant components
    for a in (m, m.T):
        got = svd.compute_signal(_t(a), method=method).numpy()
        assert _rel(got, ref.svd_compute_signal_ref(a), np.abs(m).max()) < 5e-3
        assert _rel(got, jsvd.compute_signal(_j(a), method=method), np.abs(m).max()) < 5e-3


def test_deflate_top1_matches_default(mat):
    got = svd.deflate_top1(_t(mat)).numpy()
    scale = np.abs(mat).max()
    assert _rel(got, ref.svd_denoise_ref(mat), scale) < 1e-4
    assert _rel(got, jsvd.deflate_top1(_j(mat)), scale) < 1e-4


def test_batched_denoise(mat):
    """A batch of two: each element as the reference and JAX's batch, and
    bit for bit the port's unbatched call (one start basis for every
    element)."""
    stack = np.stack([mat, mat[::-1]])
    got = svd.denoise_signal(_t(stack)).numpy()
    jgot = np.asarray(jsvd.denoise_signal(_j(stack)))
    for i in range(2):
        assert _rel(got[i], ref.svd_denoise_ref(stack[i]), np.abs(mat).max()) < 1e-4
        assert _rel(got[i], jgot[i], np.abs(mat).max()) < 1e-4
    np.testing.assert_array_equal(got[1], svd.denoise_signal(_t(stack[1])).numpy())


def test_denoise_on_real_spectrogram(small_spec):
    """denoiseSignal(spectrogram), denoising_by_svd.ipynb cell 2, on the
    0.2 s reference spectrogram (256 x 389)."""
    spec = np.asarray(small_spec, np.float64)
    want = ref.svd_denoise_ref(spec)
    got = svd.denoise_signal(_t(spec)).numpy()
    jgot = np.asarray(jsvd.denoise_signal(_j(spec)))
    for other in (want, jgot):
        assert np.abs(got - other).max() < 1e-3
        assert ssim(_norm(got), _norm(other)) > 0.99


@pytest.mark.parametrize("n", [64, 2 * svd.K_MAX], ids=["n64", "beyond-kmax"])
def test_use_optimal_zero_count_negative_slice_quirk(n):
    """Count 0: stop = -1 is a negative slice, all but the LAST component
    are kept.  At n = 128 the stop (127) exceeds K_MAX: the exact band.
    Batched beside a low-rank matrix that does not need it, each element
    takes its own band (torch.where), as JAX's."""
    m = _flat_spectrum(n, 11 if n == 64 else 5)
    s_all = np.linalg.svd(m, compute_uv=False)
    assert (s_all > (0.56 - 0.95 + 1.82 + 1.43) * np.median(s_all)).sum() == 0
    want = ref.svd_denoise_ref(m, use_optimal=True)
    assert np.abs(want).max() > 0.2  # the reference keeps rank n-1, not zeros
    low = _lowrank_plus_noise(seed=3, shape=(n, n), rank=3, noise=0.01)
    stack = np.stack([m, low])
    got = svd.denoise_signal(_t(stack), use_optimal=True).numpy()
    jgot = np.asarray(jsvd.denoise_signal(_j(stack), use_optimal=True))
    assert _rel(got[0], want, np.abs(m).max()) < 5e-2
    assert _rel(got[0], jgot[0], np.abs(m).max()) < 5e-2
    want_low = ref.svd_denoise_ref(low, use_optimal=True)
    assert _rel(got[1], want_low, np.abs(low).max()) < 5e-3
    assert _rel(got[1], jgot[1], np.abs(low).max()) < 5e-3


class _MatmulPrecision(torch.overrides.TorchFunctionMode):
    """Records the TF32 switch at every matrix product."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul):
            self.seen.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("call", ["denoise", "optimal", "compute", "deflate"])
def test_products_run_without_tf32(mat, call):
    """Every product runs with TF32 off, whatever the caller set, and the
    caller's setting is back after the call."""
    fn = {"denoise": svd.denoise_signal,
          "optimal": lambda a: svd.denoise_signal(a, use_optimal=True),
          "compute": svd.compute_signal, "deflate": svd.deflate_top1}[call]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with _MatmulPrecision() as mode:
            fn(_t(mat[:64, :96]))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert mode.seen and not any(mode.seen)


def test_unknown_method_raises(mat):
    with pytest.raises(ValueError, match="unknown method"):
        svd.compute_signal(_t(mat), method="qdwh")
    with pytest.raises(ValueError, match="unknown method"):
        svd.denoise_signal(_t(mat), method="gram")
