"""SVD low-rank spectrogram denoising in plain PyTorch (the counterpart of
``specenh.ops.svd``): the reference's ``omega`` / ``computeSignal`` /
``denoiseSignal`` (spec_denoising/denoising_by_svd.ipynb, code cell 1).

Reference quirks kept exactly (they define parity):

* ``compute_signal`` keeps components 1 .. 2*num_sing - 1: it SKIPS the
  leading component and keeps twice the Gavish-Donoho count minus one,
  capped at the length of the spectrum.
* ``denoise_signal`` defaults to start=1, stop=len(s): drop ONLY the largest
  singular component (the smooth background).
* ``use_optimal=True`` sets start=0, stop=num_sing - 1 (the reference's
  exclusive stop); for num_sing == 0 that stop is a negative Python slice
  bound, which keeps all but the last component: stop wraps to n_min - 1.
* bad start/stop are clamped to [0, len(s)].

A band ``sum_{i in [start, stop)} s_i u_i v_i^T`` with small edges needs
only the TOP-K singular triples, found by randomized subspace iteration
(tall-skinny products, QR, a k x k ``eigh``); the Gavish-Donoho median
needs the whole spectrum, from ``eigvalsh`` of the small-side Gram matrix.
``compute_signal``'s default rebuilds the band from one small-side Gram
``eigh``, exact for any count.  The linear algebra is ``torch.linalg``
(cuSOLVER on the card); every product runs in float32 with TF32 off,
whatever the caller's setting, because the Gram matrix squares the
condition number.  Everything runs on the matrix's device; a band beyond
the K_MAX subspace decides on the host whether the exact band is needed
(one synchronisation) and takes it per batch element.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

__all__ = [
    "K_MAX",
    "omega",
    "compute_signal",
    "denoise_signal",
    "deflate_top1",
    "gavish_donoho_count",
    "top_k_svd",
]

# Static cap on how many leading singular triples the subspace path tracks.
# The Gavish-Donoho count on reference spectrograms is O(10); 2*num_sing-1
# (compute_signal) stays well under 64.
K_MAX = 64
# the seed of the subspace iteration's start basis
_BASIS_SEED = 20240816


@contextlib.contextmanager
def _fp32_matmul():
    """float32 products without TF32 (JAX's Precision.HIGHEST), whatever
    precision API the caller used, its settings restored after; a context
    or, called, a decorator.  The products follow the CUDA matmul precision
    of the current API (``fp32_precision``), pinned to "ieee".  Where the
    caller's settings read consistently through the legacy API
    (``allow_tf32``, ``set_float32_matmul_precision``), that API's global
    precision is pinned to "highest" as well, so the legacy flag reads
    False inside rather than raising on a mix of the two APIs; restoring it
    also resets the CPU matmul precision, which is saved with the CUDA one."""
    cuda, cpu = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul
    saved = (cuda.fp32_precision, cpu.fp32_precision)
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set the current API: the legacy one reads as a mix
        legacy = None
    if legacy is not None:
        torch.set_float32_matmul_precision("highest")
    cuda.fp32_precision = "ieee"
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        cuda.fp32_precision, cpu.fp32_precision = saved


def omega(beta) -> torch.Tensor:
    """Gavish-Donoho optimal-SVHT coefficient omega(beta), cubic fit
    (denoising_by_svd.ipynb cell 1), in float32."""
    beta = torch.as_tensor(beta, dtype=torch.float32)
    return 0.56 * beta**3 - 0.95 * beta**2 + 1.82 * beta + 1.43


def _median_sv(s: torch.Tensor) -> torch.Tensor:
    """np.median over the (descending) singular values of the full spectrum."""
    n = s.shape[-1]
    if n % 2 == 1:
        return s[..., n // 2]
    return 0.5 * (s[..., n // 2 - 1] + s[..., n // 2])


def gavish_donoho_count(s: torch.Tensor, shape: tuple) -> torch.Tensor:
    """num_sing = #(s > omega(beta) * median(s)) with beta = min/max dim.
    ``s`` must be the FULL singular spectrum (the median is over all of it)."""
    m, n = shape[-2], shape[-1]
    beta = min(m, n) / max(m, n)
    t_star = omega(beta) * _median_sv(s)  # a 0-dim CPU tensor: a scalar on any device
    return torch.sum(s > t_star[..., None], dim=-1)


# ---------------------------------------------------------------------------
# randomized subspace iteration
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _start_basis(n: int, k: int, device: str) -> torch.Tensor:
    """The (n, k) float32 start basis from a fixed numpy seed, shared by
    every batch element (callers never write to it)."""
    q = np.random.default_rng(_BASIS_SEED).standard_normal((n, k), dtype=np.float32)
    return torch.from_numpy(q).to(device)


@_fp32_matmul()
def top_k_svd(matrix: torch.Tensor, k: int, iters: int = 8):
    """Leading-k singular triples of (..., m, n) via subspace iteration.

    Returns (u, s, vh) with shapes (..., m, k), (..., k), (..., k, n),
    singular values descending.  Deterministic: the start basis comes from
    a fixed seed, so results repeat run to run, and a matrix gets the same
    triples alone or in a batch.
    """
    *_, m, n = matrix.shape
    k = min(k, m, n)
    a = matrix.float()
    at = a.transpose(-1, -2)
    q = _start_basis(n, k, str(a.device)).expand(*a.shape[:-2], n, k)
    for _ in range(iters):
        y = torch.linalg.qr(a @ q).Q  # (..., m, k)
        q = torch.linalg.qr(at @ y).Q  # (..., n, k)
    y = a @ q  # (..., m, k) = A @ V-basis
    # small Gram eigendecomposition: Y^T Y = W diag(s^2) W^T
    evals, w = torch.linalg.eigh(y.transpose(-1, -2) @ y)  # ascending
    evals, w = evals.flip(-1), w.flip(-1)
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    u = (y @ w) / (s[..., None, :] + 1e-30)
    v = q @ w
    return u, s, v.transpose(-1, -2)


def _band_reconstruct(u, s, vh, mask):
    sw = torch.where(mask, s, torch.zeros_like(s))
    return (u * sw[..., None, :]) @ vh


def _small_gram(a: torch.Tensor) -> torch.Tensor:
    """The small side's Gram matrix: A A^T for m <= n, else A^T A."""
    at = a.transpose(-1, -2)
    return a @ at if a.shape[-2] <= a.shape[-1] else at @ a


def _full_spectrum_for_median(matrix: torch.Tensor) -> torch.Tensor:
    """All singular values (cheaply, via eigvalsh of the small-side Gram
    matrix): the Gavish-Donoho threshold uses the MEDIAN of the full
    spectrum, which the top-k basis alone cannot provide."""
    evals = torch.linalg.eigvalsh(_small_gram(matrix.float())).flip(-1)
    return torch.sqrt(torch.clamp(evals, min=0.0))


def _project_band(a: torch.Tensor, w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum_{k in band} u_k s_k v_k^T from the small side's singular basis
    ``w`` (descending order): (W * mask)(W^T A) for m <= n, else
    (A W * mask) W^T; no division by small singular values."""
    mask = mask.to(a.dtype)
    if a.shape[-2] <= a.shape[-1]:
        return (w * mask[..., None, :]) @ (w.transpose(-1, -2) @ a)
    return ((a @ w) * mask[..., None, :]) @ w.transpose(-1, -2)


def _full_band_fallback(matrix, start, stop, recon):
    """Replace ``recon`` (computed on the K_MAX subspace) with the exact
    band [start, stop) over the FULL spectrum, for the batch elements whose
    ``stop`` exceeds the subspace.  The exact band is computed only when at
    least one element needs it (a host-side branch: one synchronisation),
    from the small-side Gram eigendecomposition."""
    need = stop > K_MAX
    if not bool(need.any()):
        return recon
    a = matrix.float()
    _, w = torch.linalg.eigh(_small_gram(a))  # ascending eigenvalues
    w = w.flip(-1)  # descending = SVD order
    idx = torch.arange(min(a.shape[-2], a.shape[-1]), device=a.device)
    full = _project_band(a, w, (idx >= start[..., None]) & (idx < stop[..., None]))
    return torch.where(need[..., None, None], full, recon)


# ---------------------------------------------------------------------------
# reference API
# ---------------------------------------------------------------------------


def _gram_signal(matrix: torch.Tensor) -> torch.Tensor:
    """``computeSignal`` from ONE small-side Gram eigendecomposition: the
    full singular spectrum (for the Gavish-Donoho median) and the singular
    basis in one pass, so the band 1 .. 2*num_sing - 1 reconstructs exactly
    for ANY count, with no K_MAX subspace and no fallback."""
    a = matrix.float()
    small = min(a.shape[-2], a.shape[-1])
    evals, w = torch.linalg.eigh(_small_gram(a))
    s = torch.sqrt(torch.clamp(evals.flip(-1), min=0.0))
    num_sing = gavish_donoho_count(s, matrix.shape)
    idx = torch.arange(small, device=a.device)
    mask = (idx >= 1) & (idx < torch.clamp(2 * num_sing[..., None], max=small))
    return _project_band(a, w.flip(-1), mask)


@_fp32_matmul()
def compute_signal(matrix: torch.Tensor, method: str = "gram") -> torch.Tensor:
    """``computeSignal``: SVD, Gavish-Donoho threshold, then rebuild from
    components 1 .. 2*num_sing - 1 (capped at the available count).

    ``method='gram'`` (default) reconstructs from one small-side Gram
    eigendecomposition (exact for any band); ``'subspace'`` runs the K_MAX
    subspace iteration (the exact band where it reaches past K_MAX);
    ``'svd'`` forces the full decomposition."""
    if method == "gram":
        return _gram_signal(matrix)
    if method == "svd":
        u, s, vh = torch.linalg.svd(matrix.float(), full_matrices=False)
        num_sing = gavish_donoho_count(s, matrix.shape)
    elif method == "subspace":
        s_full = _full_spectrum_for_median(matrix)
        u, s, vh = top_k_svd(matrix, K_MAX)
        num_sing = gavish_donoho_count(s_full, matrix.shape)
    else:
        raise ValueError(f"compute_signal: unknown method {method!r}")
    idx = torch.arange(s.shape[-1], device=s.device)
    recon = _band_reconstruct(u, s, vh, (idx >= 1) & (idx < 2 * num_sing[..., None]))
    n_min = min(matrix.shape[-2], matrix.shape[-1])
    if method == "svd" or n_min <= K_MAX:
        return recon
    # 2*num_sing can exceed the subspace for heavily structured data
    return _full_band_fallback(matrix, torch.ones_like(num_sing),
                               torch.clamp(2 * num_sing, max=n_min), recon)


@_fp32_matmul()
def denoise_signal(
    matrix: torch.Tensor,
    start: Optional[int] = None,
    stop: Optional[int] = None,
    use_optimal: bool = False,
    method: str = "auto",
) -> torch.Tensor:
    """``denoiseSignal``: band-pass on the singular spectrum.

    Defaults (start=None, stop=None, use_optimal=False) reproduce the
    reference call ``denoiseSignal(s)`` in denoising_by_svd.ipynb cell 2:
    keep sigma_1 .. sigma_{n-1}, i.e. subtract only the dominant component.

    method='auto' picks the subspace path whenever the band is expressible
    as R(stop) - R(start) with small edges; method='svd' forces the full
    decomposition (needed only for large start with finite stop < n).
    """
    if method not in ("auto", "svd"):
        raise ValueError(f"denoise_signal: unknown method {method!r}")
    n_min = min(matrix.shape[-2], matrix.shape[-1])
    if use_optimal:
        # reference quirk: stop = num_sing - 1; for num_sing == 0 that is a
        # NEGATIVE python slice bound (u[:, 0:-1] keeps all but the last
        # component), so the effective stop wraps to n_min - 1
        if method == "svd":
            u, s, vh = torch.linalg.svd(matrix.float(), full_matrices=False)
            num_sing = gavish_donoho_count(s, matrix.shape)
            stop = torch.where(num_sing >= 1, num_sing - 1, s.shape[-1] - 1)
            idx = torch.arange(s.shape[-1], device=s.device)
            return _band_reconstruct(u, s, vh, idx < stop[..., None])
        s_full = _full_spectrum_for_median(matrix)
        num_sing = gavish_donoho_count(s_full, matrix.shape)
        u, s, vh = top_k_svd(matrix, K_MAX)
        stop = torch.where(num_sing >= 1, num_sing - 1, n_min - 1)
        idx = torch.arange(s.shape[-1], device=s.device)
        recon = _band_reconstruct(u, s, vh, idx < stop[..., None])  # start=0
        if n_min - 1 <= K_MAX:
            return recon  # the subspace covers every possible band exactly
        # ``stop`` can exceed the K_MAX subspace two ways: num_sing == 0
        # wraps it to n_min - 1, and a heavily structured spectrum can count
        # past K_MAX + 1 outright; either would return a rank-K_MAX
        # truncation, so those elements take the exact band
        return _full_band_fallback(matrix, torch.zeros_like(stop), stop, recon)

    lo = 1 if start is None else max(int(start), 0)
    hi = n_min if stop is None else min(int(stop), n_min)
    a = matrix.float()
    if method != "svd" and hi >= n_min and lo <= K_MAX:
        # band = everything minus the leading ``lo`` components
        if lo == 0:
            return a.clone()  # a new tensor, as JAX returns a new array
        u, s, vh = top_k_svd(a, max(lo, 2))
        idx = torch.arange(s.shape[-1], device=s.device)
        return a - _band_reconstruct(u, s, vh, idx < lo)
    if method != "svd" and hi <= K_MAX:
        u, s, vh = top_k_svd(a, K_MAX)
    else:
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
    idx = torch.arange(s.shape[-1], device=s.device)
    return _band_reconstruct(u, s, vh, (idx >= lo) & (idx < hi))


@_fp32_matmul()
def deflate_top1(matrix: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Fastest equivalent of the default ``denoise_signal`` (drop sigma_0
    only): power iteration for the dominant singular triple, then a rank-1
    subtraction.  O(iters * m * n).  Valid whenever sigma_0/sigma_1 > 1,
    always true for log spectrograms, whose background mode dominates."""
    m = matrix.float()
    mt = m.transpose(-1, -2)
    v = mt.mean(dim=-1, keepdim=True)  # (..., n, 1) deterministic init
    for _ in range(iters):
        u = m @ v
        u = u / (torch.linalg.vector_norm(u, dim=-2, keepdim=True) + 1e-30)
        v = mt @ u
        v = v / (torch.linalg.vector_norm(v, dim=-2, keepdim=True) + 1e-30)
    u = m @ v
    sigma = torch.linalg.vector_norm(u, dim=-2, keepdim=True)
    u = u / (sigma + 1e-30)
    return m - sigma * (u @ v.transpose(-1, -2))
