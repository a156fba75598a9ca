"""The raw-shot -> enhanced-spectrograms service (the counterpart of
``specenh.bench.harness``).

``make_enhance_shot_fn`` builds the serving path: a multi-channel raw shot
goes through the STFT kernel (K1), then the conv-AE stage kernels on
256x128 tiles (K2+K3+K4 at depth 2, K8-in+K6+K8-out at depth 3), and comes
back restitched.  ``stft_mode`` picks the STFT front as the JAX service's
does, and ``use_kernel`` the route (the kernels, or the ``nn.Module`` for
a geometry no kernel family covers).  ``make_production_predict_fn`` is
the AE alone on a tile batch, on the same routes (what a sweep's
``pred_times`` times).  ``enhance_shot_plain`` is the
same service composed of the plain twins (matmul STFT, the ``nn.Module``):
the float32 reference the service is gated against.
"""

from __future__ import annotations

import statistics
from typing import Callable, List, Optional

import numpy as np
import torch

from specenh_torch.config import ModelConfig, PatchSpec, SpecParams
from specenh_torch.data.tiles import n_tiles_for
from specenh_torch.models.autoencoder import ConvAutoencoder
from specenh_torch.ops import ae_kernel, stft_fused
from specenh_torch.ops.stft import spectrogram
from specenh_torch.parallel.collectives import block_of, exchange_for, gather_blocks
from specenh_torch.utils.logging import span

__all__ = ["make_enhance_shot_fn", "make_production_predict_fn", "enhance_shot_plain",
           "example_shot", "time_cuda", "STFT_MODES"]

STFT_MODES = ("auto", "fused", "fused_ft", "xla")


def _route_depth(cfg: ModelConfig, use_kernel) -> int | None:
    """The kernel family's depth for ``use_kernel`` (JAX's rules), or None
    for the module route."""
    if use_kernel not in ("auto", True, False):
        raise ValueError(f"use_kernel must be 'auto', True or False: {use_kernel!r}")
    if use_kernel is False:
        return None
    try:
        return ae_kernel.kernel_depth(cfg)
    except NotImplementedError:
        if use_kernel is True:
            raise
        return None


def _preparer(depth: int | None, dtype):
    """``fn.prepare`` of a route: on the kernels (``depth``) the kernels'
    weights built from a module once, weights of that depth passed through;
    on the module route (None) the module as it is."""
    def prepare(model_or_weights):
        is_wts = isinstance(model_or_weights, ae_kernel.AEKernelWeights)
        if depth is None:
            if is_wts:
                raise TypeError("the module route serves the nn.Module, not kernel weights")
            return model_or_weights
        if not is_wts:
            return ae_kernel.build_kernel_weights(model_or_weights, dtype, depth)
        if model_or_weights.depth != depth:
            raise ValueError(f"depth-{model_or_weights.depth} weights for a "
                             f"depth-{depth} service")
        return model_or_weights

    return prepare


def make_production_predict_fn(model_cfg: ModelConfig, dtype=torch.bfloat16,
                               use_kernel: object = "auto", device="cuda") -> Callable:
    """Tile-batch predictor on the serving path: ``fn(model_or_weights,
    tiles) -> probabilities``, tiles (B, 256, 128) or (B, 256, 128, 1),
    float32 out in the tiles' layout.  The AE kernels
    (``ae_kernel.ae_kernel_apply``, the family ``kernel_depth`` picks)
    where a family covers ``model_cfg``, else the ``nn.Module`` computing
    in ``dtype`` (None: float32); ``use_kernel`` has the rules of
    ``make_enhance_shot_fn`` (``True`` on an uncovered geometry raises
    ``NotImplementedError``).  ``fn.prepare(model)`` gives the kernels'
    weights (kernel weights are returned as they are) or, on the module
    route, the module.  This is what a sweep's ``pred_times`` times."""
    dtype = torch.float32 if dtype is None else dtype
    device = torch.device(device)
    depth = _route_depth(model_cfg, use_kernel)
    prepare = _preparer(depth, dtype)

    def fn(model_or_weights, tiles):
        wts = prepare(model_or_weights)
        t = torch.as_tensor(tiles, dtype=torch.float32, device=device)
        x = (t[..., 0] if t.ndim == 4 else t).contiguous()
        with torch.no_grad():
            out = (wts.forward_as(x, dtype) if depth is None
                   else ae_kernel.ae_kernel_apply(wts, x))
        return out[..., None] if t.ndim == 4 else out

    fn.prepare = prepare
    return fn


def _k_tiles(sp: SpecParams, ps: PatchSpec) -> int:
    k = n_tiles_for(sp.n_frames, ps)
    if k < 1:
        raise ValueError(
            f"shot too short to tile: {sp.n_frames} frames < tile width {ps.tile_time}"
        )
    return k


def make_enhance_shot_fn(
    cfg: ModelConfig = ModelConfig(),
    sp: SpecParams = SpecParams(),
    ps: PatchSpec = PatchSpec(),
    dtype=torch.bfloat16,
    device="cuda",
    stft_mode: str = "auto",
    use_kernel: object = "auto",
    mesh=None,
    axis: str = "data",
    n_channels: Optional[int] = None,
) -> Callable:
    """Returns ``fn(model_or_weights, traces) -> (specs, enhanced)``:
    traces (C, >= n_samples) -> specs (C, 256, n_frames) float32, enhanced
    (C, 256, k*128) float32.

    The AE runs in ``dtype`` (bfloat16, or float32 for ``None``); the STFT
    is float32 either way.  On ``device="cpu"`` every kernel wrapper runs
    its plain twin.

    ``use_kernel`` (the JAX service's values and rules) picks the route:

    - ``True``: the kernel family that covers ``cfg``
      (``ae_kernel.kernel_depth``); ``NotImplementedError`` where none
      does.  ``fn.prepare(model)`` builds the kernels' weights once; a
      resident service passes them in place of the model, and weights of
      another depth than ``cfg``'s raise.
    - ``False``: the module route: the ``nn.Module`` computing in
      ``dtype`` (its float32 parameters cast per layer), behind the
      ``"xla"`` matmul front.  ``fn.prepare`` returns the module as it is;
      kernel weights raise ``TypeError``.
    - ``"auto"``: the kernels where a family covers ``cfg``, in either
      dtype, else the module route.  (JAX's ``"auto"`` also takes its Flax
      route for float32 and on a CPU backend; the port's runs the kernels
      there, whose CPU twins compute the same within the tests'
      tolerances.)

    ``stft_mode``, the STFT front (the JAX service's values and rules):

    - ``"auto"``: K1 in the (F, T) layout (``spectrogram_fused``), then the
      AE stages, for the reference STFT geometry (nperseg 512 / hop 256,
      ``stft_fused.supported``); for any other geometry the matmul front of
      ``"xla"``, as the JAX service's ``"auto"`` falls back to its XLA
      front.
    - ``"fused"``: K1 in the (T, F) layout; the AE's first stage reads the
      raw log-PSD and normalizes it as it loads (``ae_tile_in_norm``, K9's
      route), and the specs output is one transposing pass
      (``normalized_specs``).  Depth 2, bf16 and the reference STFT
      geometry only, on the kernel route, else ``NotImplementedError``.
    - ``"fused_ft"``: K1 in the (F, T) layout, forced: bf16, the
      reference STFT geometry and the kernel route only.  In the port
      this is ``"auto"``'s path.
    - ``"xla"``: the plain matmul STFT (``ops.stft.spectrogram``: a
      float64 matmul, float32 out), then the AE stages; any STFT geometry.

    Any other value raises ``ValueError``.

    With ``mesh`` (a ``parallel.mesh.Mesh`` over ``axis``, or an
    ``Exchange``) the channels are sharded over its ranks: every rank
    calls ``fn`` with the whole ``traces``, computes the front and the AE
    above on its block of channels (blocks as ``numpy.array_split``; the
    service has no cross-channel coupling), and the blocks are gathered
    into full arrays on rank 0; the other ranks get ``(None, None)``.  The
    service runs on the mesh's device.  ``use_kernel=True`` needs the
    channel count divisible by the mesh's size (``ValueError`` naming
    "divisible", JAX's rule); ``"auto"`` and ``False`` serve uneven blocks
    (JAX's ``"auto"`` takes its Flax route for them).  ``n_channels``:
    where given, a call with another channel count raises
    ``ValueError``.  A world of one is the service without a mesh bit for
    bit.

    Each call records the spans ``shot.stft`` (K1 or the matmul STFT and
    the normalization), ``shot.ae`` (the stages) and, over a mesh,
    ``shot.exchange`` (the block and the gathers), while
    ``utils.logging.recording()`` is on.
    """
    dtype = torch.float32 if dtype is None else dtype
    ex = None if mesh is None else exchange_for(mesh)
    if ex is not None and axis not in ex.shape:
        raise ValueError(f"the mesh's axis is {ex.axis_names[0]!r}, not {axis!r}")
    device = torch.device(device) if ex is None else ex.device
    if stft_mode not in STFT_MODES:
        raise ValueError(f"stft_mode must be one of {STFT_MODES}: {stft_mode!r}")
    k_tiles = _k_tiles(sp, ps)
    depth = _route_depth(cfg, use_kernel)
    if stft_mode == "fused" and not (depth == 2 and dtype == torch.bfloat16
                                     and stft_fused.supported(sp)):
        raise NotImplementedError(
            "stft_mode='fused' needs the depth-2 kernels serving in bf16 with the "
            f"reference STFT geometry: {cfg}, {sp}, {dtype}, use_kernel={use_kernel!r}")
    if stft_mode == "fused_ft" and not (depth is not None and dtype == torch.bfloat16
                                        and stft_fused.supported(sp)):
        raise NotImplementedError(
            "stft_mode='fused_ft' needs the kernels serving in bf16 with the "
            f"reference STFT geometry: {cfg}, {sp}, {dtype}, use_kernel={use_kernel!r}")
    prepare = _preparer(depth, dtype)
    if depth is None:
        return _served(_module_body(sp, dtype, k_tiles), prepare, device, ex, axis, False,
                       n_channels)
    matmul_front = stft_mode == "xla" or not stft_fused.supported(sp)

    def front(wts, traces):
        if stft_mode == "fused":
            with span("shot.stft"):
                raw, mn, mx = stft_fused.stft_tf_log(traces, sp)
                specs = stft_fused.normalized_specs(raw, mn, mx, sp.n_frames)
            with span("shot.ae"):
                return specs, ae_kernel.ae_kernel_enhance_raw(wts, raw, mn, mx, k_tiles, "tf")
        with span("shot.stft"):
            if matmul_front:
                specs = spectrogram(traces, sp)
            else:
                specs = stft_fused.spectrogram_fused(traces, sp)
        with span("shot.ae"):
            return specs, ae_kernel.ae_kernel_enhance_specs(wts, specs, k_tiles)

    return _served(front, prepare, device, ex, axis, use_kernel is True, n_channels)


def _module_body(sp: SpecParams, dtype, k_tiles: int) -> Callable:
    """The service's body on the ``nn.Module`` (JAX's Flax route): the
    matmul STFT, then the module computing in ``dtype``."""
    def body(model, traces):
        with span("shot.stft"):
            specs = spectrogram(traces, sp)
        with span("shot.ae"):
            return specs, ae_kernel.ae_kernel_enhance_specs_plain(model, specs, k_tiles, dtype)

    return body


def _served(body: Callable, prepare: Callable, device, ex, axis: str, even: bool,
            n_channels: Optional[int]) -> Callable:
    """``fn(model_or_weights, traces)``: ``body`` on the traces on
    ``device``, or, over the exchange ``ex``, on this rank's block of
    channels with the blocks gathered on rank 0 (``even``: the channel
    count must divide by the mesh's size)."""
    def fn(model_or_weights, traces):
        wts = prepare(model_or_weights)
        traces = torch.as_tensor(traces, dtype=torch.float32, device=device)
        if ex is None:
            with torch.no_grad():
                return body(wts, traces.contiguous())
        c = traces.shape[0]
        if n_channels is not None and c != n_channels:
            raise ValueError(f"the service takes {n_channels} channels, got {c}")
        if even and c % ex.size:
            raise ValueError(
                f"kernel serving over a mesh with use_kernel=True needs the channel "
                f"count ({c}) divisible by the '{axis}' axis size ({ex.size}); "
                "use_kernel='auto' serves uneven blocks on the kernels, False on the module")
        if c < ex.size:
            raise ValueError(f"{c} channels cannot be sharded over {ex.size} ranks")
        with span("shot.exchange"):
            block = block_of(ex, traces, 0).contiguous()
        with torch.no_grad():
            specs, enhanced = body(wts, block)
        with span("shot.exchange"):
            return gather_blocks(ex, specs, 0, c), gather_blocks(ex, enhanced, 0, c)

    fn.prepare = prepare
    return fn


def enhance_shot_plain(model: ConvAutoencoder, traces: torch.Tensor,
                       sp: SpecParams = SpecParams(),
                       ps: PatchSpec = PatchSpec()):
    """The service from the plain twins, on ``traces``' device: the
    reference STFT (a float64 ``torch.matmul``) and the ``nn.Module`` in
    its own dtype.  On a GPU keep TF32 off for the module to be a float32
    reference."""
    k_tiles = _k_tiles(sp, ps)
    with torch.no_grad():
        specs = spectrogram(traces, sp)
        return specs, ae_kernel.ae_kernel_enhance_specs_plain(model, specs, k_tiles)


def example_shot(sp: SpecParams = SpecParams(), n_channels: int = 20,
                 seed: int = 0) -> np.ndarray:
    """Synthetic 20-channel ECE-like shot (chirp + tone + noise), the same
    numbers as ``specenh.bench.harness.example_shot``."""
    rng = np.random.default_rng(seed)
    t = np.arange(sp.n_samples) / sp.fs
    out = np.stack(
        [
            np.sin(2 * np.pi * (5e4 + 2e4 * t) * t + k)
            + 0.3 * np.sin(2 * np.pi * 1.2e5 * t)
            + 0.5 * rng.standard_normal(t.size)
            for k in range(n_channels)
        ]
    )
    return out.astype(np.float32)


def time_cuda(fn: Callable, *args, warmup: int = 3, iters: int = 10) -> float:
    """Median milliseconds of ``fn(*args)`` on the current CUDA stream,
    from CUDA events around each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    pairs: List = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
