"""Time sharding with halo exchange, the long-shot path (the counterpart of
``specenh.parallel.timeshard``).

Nothing in the STFT, the label pipeline or the conv-AE carries long-range
time state, so a shot longer than one card's memory is split along its
TIME axis over the ranks of a ``("time",)`` mesh, and each op exchanges
only the halo it needs (``parallel.collectives``):

* the STFT: ``nperseg - hop`` raw samples from the right neighbour;
* the 31-tap blur: 15 spectrogram columns from each side, reflect-101 at
  the shot's two ends;
* the 4x4 and 3x1 morphology: at most 2 columns a side, 0 (dilate) or 255
  (erode) at the ends, which the uint8 values cannot beat;
* the global reductions become collectives: the per-channel min and max
  one ``max`` all-reduce (the min negated), the row means an all-reduce
  of float64 partial sums divided once, as ``ops.enhance.mean_subtract``
  (the quantile's freq axis is not sharded: it is local).

Each rank holds a contiguous block of ``k * hop`` samples of the trace,
``k`` frames of it; ``shard_of`` cuts it from the whole trace.  The global
frame count is ``n * k - (r - 1)`` (``r = nperseg / hop``), so the last
rank's final ``r - 1`` frames have no data: they are copies of the last
valid frame, harmless to the min and max and in the trailing columns the
tiles drop.  The functions take and return this rank's block (the JAX
package's take and return arrays sharded over the mesh);
``gather_shards`` concatenates the blocks on rank 0.  A world of one is
the unsharded ``spectrogram`` on its first ``n_frames`` columns and the
unsharded ``classical_pipeline`` and AE on its spectrogram.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from specenh_torch.bench.harness import _preparer, _route_depth
from specenh_torch.config import ModelConfig, PatchSpec, PipelineConfig, SpecParams
from specenh_torch.ops import ae_kernel
from specenh_torch.ops.enhance import _gauss_kernel_f64, opencv_gauss_kernel_q88, quantile_filter
from specenh_torch.ops.stft import stft_basis
from specenh_torch.parallel.collectives import Exchange, block_of, exchange_for, gather_blocks

__all__ = [
    "sharded_spectrogram",
    "sharded_enhance",
    "usable_samples",
    "usable_samples_tiled",
    "make_sharded_enhance_shot",
    "shard_of",
    "gather_shards",
]


def usable_samples(n_samples: int, n_dev: int, sp: SpecParams) -> int:
    """Largest T <= n_samples with T divisible by n_dev * hop (equal shards,
    each a whole number of frames)."""
    q = n_dev * sp.hop
    return (n_samples // q) * q


def usable_samples_tiled(n_samples: int, n_dev: int, sp: SpecParams,
                         tile_time: int = 128) -> int:
    """Largest T <= n_samples such that every rank's shard is a whole
    number of AE tiles: T divisible by n_dev * hop * tile_time."""
    q = n_dev * sp.hop * tile_time
    return (n_samples // q) * q


def _axis_size(ex: Exchange, axis: str) -> int:
    if axis not in ex.shape:
        raise ValueError(f"the mesh's axis is {ex.axis_names[0]!r}, not {axis!r}")
    return ex.size


def shard_of(mesh, x):
    """This rank's block of the last (time) axis of ``x``: equal blocks,
    so the length must divide by the mesh's size."""
    ex = exchange_for(mesh)
    if x.shape[-1] % ex.size:
        raise ValueError(f"T={x.shape[-1]} does not split into {ex.size} equal shards")
    return block_of(ex, torch.as_tensor(x), -1)


def gather_shards(mesh, *blocks):
    """Each of this rank's ``blocks`` (sharded along the last axis)
    concatenated with the other ranks' on rank 0, as one tuple; None for
    each on the others.  Every rank calls it."""
    ex = exchange_for(mesh)
    return tuple(gather_blocks(ex, b, -1) for b in blocks)


# ---------------------------------------------------------------------------
# halos and global reductions
# ---------------------------------------------------------------------------


def _extend_time(x: torch.Tensor, left: int, right: int, ex: Exchange, edge) -> torch.Tensor:
    """``x`` with ``left`` columns of the left neighbour's and ``right`` of
    the right neighbour's before and after it; at the shot's ends
    ``edge``: "reflect101" or a constant (every rank joins both
    exchanges)."""
    parts = []
    if left > 0:
        halo = ex.recv_left(x, left)
        if ex.rank == 0:
            halo = (x[..., 1: left + 1].flip(-1) if edge == "reflect101"
                    else torch.full_like(halo, edge))
        parts.append(halo)
    parts.append(x)
    if right > 0:
        halo = ex.recv_right(x, right)
        if ex.rank == ex.size - 1:
            w = x.shape[-1]
            halo = (x[..., w - right - 1: w - 1].flip(-1) if edge == "reflect101"
                    else torch.full_like(halo, edge))
        parts.append(halo)
    return torch.cat(parts, -1)


def _gminmax(x: torch.Tensor, ex: Exchange):
    """The global min and max over the last two axes, per leading index,
    in one all-reduce."""
    mn = x.amin(dim=(-2, -1), keepdim=True)
    mx = x.amax(dim=(-2, -1), keepdim=True)
    both = ex.reduce(torch.cat([-mn, mx], -1), "max")
    return -both[..., :1], both[..., 1:]


def _grescale(x: torch.Tensor, ex: Exchange) -> torch.Tensor:
    mn, mx = _gminmax(x, ex)
    return (x - mn) / (mx - mn)


def _gto_u8(x: torch.Tensor, ex: Exchange) -> torch.Tensor:
    return torch.floor(_grescale(x, ex) * 255.0)


# ---------------------------------------------------------------------------
# the sharded STFT
# ---------------------------------------------------------------------------


def _spectrogram_local(xl: torch.Tensor, sp: SpecParams, k: int, ex: Exchange,
                       basis) -> torch.Tensor:
    """Per-rank body of the sharded STFT: the right halo, ``k`` frames, the
    float64 framed product of ``ops.stft`` with ``basis`` (its
    ``stft_basis`` in float64 on the rank's device; PSD and log in
    float64, rounded once), the last rank's dataless frames copied from
    the last valid one, the global rescale.  ``xl``: (..., k*hop) ->
    (..., n_freqs_kept, k) float32."""
    r = sp.nperseg // sp.hop
    x_ext = torch.cat([xl, ex.recv_right(xl, sp.nperseg - sp.hop)], -1)
    frames = x_ext.double().unfold(-1, sp.nperseg, sp.hop)  # (..., k, nperseg)
    b_real, b_imag, weights = basis
    zr = torch.matmul(frames, b_real)
    zi = torch.matmul(frames, b_imag)
    psd = (zr * zr + zi * zi) * weights  # (..., k, F)
    if r > 1 and ex.rank == ex.size - 1:
        tail = psd[..., k - r: k - r + 1, :].expand(*psd.shape[:-2], r - 1, psd.shape[-1])
        psd = torch.cat([psd[..., : k - r + 1, :], tail], -2)
    sxx = torch.log(psd.transpose(-1, -2) + sp.eps).float()  # (..., F, k)
    mn, mx = _gminmax(sxx, ex)
    return ((sxx[..., : sp.n_freqs_kept, :] - mn) / (mx - mn)).contiguous()


def sharded_spectrogram(x, sp: SpecParams, mesh, axis: str = "time") -> torch.Tensor:
    """The reference's normalized log spectrogram of a trace whose time
    axis is sharded over ``mesh``'s ``axis``.

    ``x``: this rank's block, (..., T / n) samples, on the mesh's device
    (``shard_of``), T divisible by n * hop (``usable_samples``).  Returns
    this rank's (..., n_freqs_kept, T / (n * hop)) columns; the shot's last
    frame (``r - 1`` of them for r = nperseg / hop) duplicates the one
    before.  Requires nperseg % hop == 0 (true for 50 % overlap)."""
    ex = exchange_for(mesh)
    if sp.nperseg % sp.hop != 0:
        raise ValueError("sharded STFT requires nperseg % hop == 0")
    n_dev = _axis_size(ex, axis)
    xl = torch.as_tensor(x, dtype=torch.float32, device=ex.device)
    t_total = xl.shape[-1] * n_dev
    if t_total % (n_dev * sp.hop) != 0:
        raise ValueError(
            f"T={t_total} not divisible by n_dev*hop={n_dev * sp.hop}; "
            "trim with usable_samples()")
    k = t_total // (n_dev * sp.hop)
    r = sp.nperseg // sp.hop  # the last rank's final r-1 frames lack data
    if k < r:
        raise ValueError(f"each shard must hold at least nperseg/hop={r} frames; got {k}")
    with torch.no_grad():
        return _spectrogram_local(xl.contiguous(), sp, k, ex,
                                  stft_basis(sp, ex.device, torch.float64))


# ---------------------------------------------------------------------------
# the sharded label pipeline
# ---------------------------------------------------------------------------


def _sharded_sep(x: torch.Tensor, kt, kf, ex: Exchange) -> torch.Tensor:
    """``ops.enhance._sep_filter`` on a time-sharded image: the time taps
    over the halo-extended columns in tap order, then the frequency taps
    over the reflect-101 padded rows, each a float32 multiply and add."""
    rt, rf = len(kt) // 2, len(kf) // 2
    ext = _extend_time(x, rt, rt, ex, "reflect101")
    p = F.pad(ext.reshape(-1, *ext.shape[-2:]), (0, 0, rf, rf), mode="reflect")
    p = p.reshape(*x.shape[:-2], *p.shape[-2:])
    t_len, f_len = x.shape[-1], x.shape[-2]
    acc = None
    for i, c in enumerate(kt):
        s = p[..., :, i: i + t_len] * float(np.float32(c))
        acc = s if acc is None else acc + s
    out = None
    for j, c in enumerate(kf):
        s = acc[..., j: j + f_len, :] * float(np.float32(c))
        out = s if out is None else out + s
    return out


def _sharded_window(x: torch.Tensor, se, is_max: bool, ex: Exchange) -> torch.Tensor:
    """``ops.enhance._morph_window`` (an OpenCV WxH rect SE, source offsets
    [-d//2, d-1-d//2] per axis) on a time-sharded uint8-valued image."""
    w, h = se
    ext = _extend_time(x, w // 2, w - 1 - w // 2, ex, 0.0 if is_max else 255.0)
    x3 = ext.reshape(-1, *ext.shape[-2:])
    pads = (0, 0, h // 2, h - 1 - h // 2)
    if is_max:
        out = F.max_pool2d(F.pad(x3, pads, value=-float("inf"))[:, None], (h, w), stride=1)
    else:
        out = -F.max_pool2d(F.pad(-x3, pads, value=-float("inf"))[:, None], (h, w), stride=1)
    return out.reshape(x.shape)


def _sharded_meansub(x: torch.Tensor, ex: Exchange) -> torch.Tensor:
    """|x - the global per-freq-row time mean|, globally rescaled: the
    ranks' float64 row sums all-reduced, divided by the global width in
    float64 and rounded to float32 once (``ops.enhance.mean_subtract``)."""
    total = ex.reduce(x.double().sum(dim=-1, keepdim=True), "sum")
    mean = (total / (x.shape[-1] * ex.size)).to(x.dtype)
    return _grescale((x - mean).abs(), ex)


def _enhance_local(s: torch.Tensor, cfg: PipelineConfig, ex: Exchange) -> torch.Tensor:
    """Per-rank body of the sharded 5-stage pipeline: the stages of
    ``ops.enhance.classical_pipeline`` with its arithmetic, the halos and
    the global reductions exchanged."""
    x = quantile_filter(s, cfg.quant_threshold)
    if cfg.emulate_uint8:
        acc = _sharded_sep(_gto_u8(x, ex), opencv_gauss_kernel_q88(cfg.gauss_ksize[0]),
                           opencv_gauss_kernel_q88(cfg.gauss_ksize[1]), ex)  # Q16.16
        x = torch.floor((acc + 32768.0) * (1.0 / 65536.0)).clamp(0.0, 255.0)
    else:
        x = _sharded_sep(x, _gauss_kernel_f64(cfg.gauss_ksize[0]),
                         _gauss_kernel_f64(cfg.gauss_ksize[1]), ex)
    x = _sharded_meansub(_grescale(x, ex), ex)
    # morph: CLOSE(close_se) then OPEN(open_se) on uint8
    x = _gto_u8(x, ex)
    x = _sharded_window(x, cfg.close_se, True, ex)
    x = _sharded_window(x, cfg.close_se, False, ex)
    x = _sharded_window(x, cfg.open_se, False, ex)
    x = _sharded_window(x, cfg.open_se, True, ex)
    return _sharded_meansub(_grescale(x, ex), ex)


def sharded_enhance(spec, mesh, cfg: PipelineConfig = PipelineConfig(),
                    axis: str = "time") -> torch.Tensor:
    """The 5-stage label pipeline on a time-sharded spectrogram: this
    rank's (..., F, T / n) columns in, its columns of
    ``ops.enhance.classical_pipeline`` of the whole out (the same
    fixed-point blur, morphology offsets and global normalizations, the
    reductions as collectives)."""
    ex = exchange_for(mesh)
    _axis_size(ex, axis)
    s = torch.as_tensor(spec, dtype=torch.float32, device=ex.device)
    min_w = max(cfg.gauss_ksize[0] // 2, cfg.close_se[0], cfg.open_se[0]) + 1
    if s.shape[-1] < min_w:
        raise ValueError(
            f"time shard width {s.shape[-1]} < max halo {min_w}; use fewer "
            "devices or a longer shot")
    with torch.no_grad():
        return _enhance_local(s, cfg, ex)


# ---------------------------------------------------------------------------
# the composed long-shot service: STFT -> pipeline -> conv-AE on each shard
# ---------------------------------------------------------------------------


def make_sharded_enhance_shot(
    model_cfg: Optional[ModelConfig] = None,
    sp: SpecParams = SpecParams(),
    mesh=None,
    ps: Optional[PatchSpec] = None,
    pipe_cfg: PipelineConfig = PipelineConfig(),
    axis: str = "time",
    dtype=torch.bfloat16,
    n_samples: Optional[int] = None,
    use_kernel: object = "auto",
):
    """One long shot across the mesh: on each rank the halo-exchange STFT
    of its block of the trace, the sharded label pipeline, and the conv-AE
    on its local tiles (the tiles are SAME-padded and independent, and the
    tile axis is the time axis: the AE needs no halo).

    Returns ``fn(model_or_weights, trace) -> (spec, labels, enhanced)``:
    ``trace`` is this rank's block (``shard_of``), (T / n,) or (C, T / n)
    (at most one leading channel axis), with T divisible by n * hop *
    tile_time (``usable_samples_tiled``); each output is this rank's
    (..., F, T / (n * hop)) columns on the mesh's device (``gather_shards``
    joins them on rank 0).  ``n_samples`` is T (default ``sp.n_samples``),
    used to check the geometry here.  ``mesh`` is required.

    ``use_kernel`` has the service's rules (``bench.harness``): the
    kernel family that covers ``model_cfg`` (``ae_kernel.kernel_depth``:
    S1, S2, S3, S4 at depth 2, their depth-3 forms) on this rank's
    spectrogram columns, or the ``nn.Module`` route; ``fn.prepare(model)``
    builds the kernels' weights once.  The AE computes in ``dtype``
    (bfloat16 by default, what the JAX package's kernel route computes;
    None for float32), on either route.
    """
    model_cfg = model_cfg or ModelConfig()
    ps = ps or PatchSpec()
    if mesh is None:
        raise ValueError("make_sharded_enhance_shot requires a mesh")
    ex = exchange_for(mesh)
    n_dev = _axis_size(ex, axis)
    t_total = sp.n_samples if n_samples is None else n_samples
    if t_total % (n_dev * sp.hop) != 0:
        raise ValueError(
            f"T={t_total} not divisible by n_dev*hop={n_dev * sp.hop}; trim "
            "with usable_samples_tiled()")
    k = t_total // (n_dev * sp.hop)  # frames a shard
    if k % ps.tile_time != 0:
        raise ValueError(
            f"frames/shard {k} not a whole number of {ps.tile_time}-frame "
            "tiles; trim with usable_samples_tiled()")
    if sp.nperseg % sp.hop != 0:
        raise ValueError("sharded STFT requires nperseg % hop == 0")
    if k < sp.nperseg // sp.hop:
        raise ValueError("each shard must hold at least nperseg/hop frames")
    if model_cfg.input_shape[:2] != (sp.n_freqs_kept, ps.tile_time):
        raise ValueError(
            f"model input {model_cfg.input_shape[:2]} != tile geometry "
            f"({sp.n_freqs_kept}, {ps.tile_time})")
    k_tiles = k // ps.tile_time
    dtype = torch.float32 if dtype is None else dtype
    depth = _route_depth(model_cfg, use_kernel)
    prepare = _preparer(depth, dtype)
    basis = stft_basis(sp, ex.device, torch.float64)  # on the card once, as the weights

    def fn(model_or_weights, trace):
        xl = torch.as_tensor(trace, dtype=torch.float32, device=ex.device)
        if xl.ndim not in (1, 2):
            raise ValueError(
                f"trace must be (T,) or (C, T), got {tuple(xl.shape)} — "
                "data.tiles.patch takes one leading axis")
        if xl.shape[-1] != k * sp.hop:
            raise ValueError(f"this rank's block must hold T/n_dev = {k * sp.hop} samples, "
                             f"got {xl.shape[-1]} (cut it with shard_of())")
        wts = prepare(model_or_weights)
        with torch.no_grad():
            s = _spectrogram_local(xl.contiguous(), sp, k, ex, basis)  # (..., F, k)
            labels = _enhance_local(s, pipe_cfg, ex)
            s3 = s[None] if s.ndim == 2 else s
            if depth is None:
                enh = ae_kernel.ae_kernel_enhance_specs_plain(wts, s3, k_tiles, dtype)
            else:
                enh = ae_kernel.ae_kernel_enhance_specs(wts, s3, k_tiles)
        return s, labels, enh[0] if s.ndim == 2 else enh

    fn.prepare = prepare
    return fn
