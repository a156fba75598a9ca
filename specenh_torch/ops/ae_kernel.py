"""Conv-AE inference on the spectrograms, at depth 2 (K2 + K3 + K4) and at
depth 3 (K8-in + K6 + K8-out; ``ops.ae3_kernel`` gives these functions the
JAX package's depth-3 names): the CUDA stage kernels' wrappers and their plain twins (the counterpart of
``specenh.ops.ae_kernel`` and the tile turns of ``specenh.ops.parity_turn``).

The kernels' layer table for depth d has 2d + 1 layers: the encoder convs
0 .. d-1, the transposed convs d .. 2d-1 (``dec_deconvs[d-1]`` first) and
the out-conv 2d.  ``ae_kernel_enhance_specs`` runs four stage kernels of
``csrc/ae.cu`` over it:

  ae_tile_in    S1  the tile load + cast (K2, K8-in) fused with encoder
                    conv 0 + relu + pool (in bf16 on the tensor cores,
                    ``conv_in_mma_kernel``)
  ae_conv_pool  S2  encoder convs 1 .. d-1 + relu + pool (in bf16 on the
                    tensor cores, ``conv_igemm_kernel``)
  ae_convt      S3  stride-2 transposed conv + relu, d times (in bf16 on
                    the tensor cores, ``convt_igemm_kernel``)
  ae_tile_out   S4  out-conv + sigmoid fused with the restitched store
                    (K4, K8-out; in bf16 on the tensor cores,
                    ``conv_out_mma_kernel``)

``ae_kernel_enhance_raw`` is the same chain with S1 replaced by
``ae_tile_in_norm``: S1 reading the raw log-PSD of the STFT kernel and
min-max normalizing it as it loads, in the (T, F) layout (``layout="tf"``,
the route of K9 ``specs_tf_to_x16_2d``, ``stft_mode="fused"``) or the
(F, T) layout (``layout="ft"``, the route of K10 ``specs_ft_to_x16_2d``).
The JAX kernels produce x16 parity rows; this stage produces pooled conv1
activations, so the port does not use their names.

Each stage wrapper launches its kernel for CUDA tensors and runs its plain
twin (``*_plain``: ``F.conv2d`` and friends on float32 copies of values
rounded to the service dtype, the kernel's rounding points) for CPU
tensors.  The whole AE's plain twin is ``ae_kernel_enhance_specs_plain``:
``patch``, the ``nn.Module``, ``unpatch``.  ``kernel_depth`` decides which
family, if any, covers a geometry.

Activations stay in the service dtype (bf16 or float32), NCHW per tile;
sums are float32 and biases float32, as in the TPU kernels.  An unsupported
geometry raises in ``build_kernel_weights``; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from specenh_torch.config import ModelConfig, PatchSpec
from specenh_torch._build import CudaKernel
from specenh_torch.data.tiles import patch, unpatch
from specenh_torch.models.autoencoder import ConvAutoencoder, conv_transpose_same

__all__ = [
    "AEKernelWeights", "supports", "supports3", "kernel_depth",
    "build_kernel_weights",
    "ae_tile_in", "ae_tile_in_norm", "ae_conv_pool", "ae_convt", "ae_tile_out",
    "convt_igemm_rows", "conv_out_plan", "conv_out_rows", "CONV_OUT_BAND",
    "conv_in_strip",
    "ae_tile_in_plain", "ae_tile_in_norm_plain", "ae_conv_pool_plain",
    "ae_convt_plain", "ae_tile_out_plain", "normalized_tiles",
    "ae_kernel_enhance_specs", "ae_kernel_enhance_raw", "ae_kernel_apply",
    "ae_kernel_enhance_specs_plain",
]

TILE_F, TILE_T = PatchSpec().tile_freq, PatchSpec().tile_time  # 256, 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
TILE_IN = CudaKernel("ae", "ae_tile_in",
                     [_p, _i, _i64, _i64, _p, _p, _p, _i, _i, _i, _i, _i, _i])
TILE_IN_NORM = CudaKernel("ae", "ae_tile_in_norm",
                          [_p, _p, _p, _i, _i64, _i64, _i64, _p, _p, _p, _i, _i, _i,
                           _i, _i, _i])
CONV_POOL = CudaKernel("ae", "ae_conv_pool",
                       [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i])
CONVT = CudaKernel("ae", "ae_convt_relu",
                   [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i])
TILE_OUT = CudaKernel("ae", "ae_tile_out",
                      [_p, _p, _p, _p, _i, _i64, _i64, _i, _i, _i, _i, _i, _i])


@dataclasses.dataclass(frozen=True)
class AEKernelWeights:
    """The 2d + 1 layers in the kernels' layout: ``w[i]`` (Cin, kh, kw,
    Cout) in the service dtype (transposed convs: the Flax kernel,
    unflipped), ``b[i]`` (Cout,) float32.  Layers: the encoder convs, the
    transposed convs from the bottom up, the out-conv.  ``wt[i]`` is the
    operand of the tensor-core templates (``csrc/ae_conv.cuh``), w[i] with
    its input channel fastest (kh, kw, Cout, Cin), in bf16 for the
    multi-channel layers 1 .. 2d-1 (``conv_igemm_kernel`` for the encoder
    convs, ``convt_igemm_kernel`` for the transposed convs); else None."""

    w: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]
    dtype: torch.dtype
    wt: Tuple[torch.Tensor | None, ...]

    @property
    def depth(self) -> int:
        return (len(self.w) - 1) // 2

    @property
    def out(self) -> int:
        """The out-conv's layer index, 2d."""
        return len(self.w) - 1

    def is_convt(self, i: int) -> bool:
        return self.depth <= i < self.out

    def k(self, i: int) -> int:
        return self.w[i].shape[1]

    def cout(self, i: int) -> int:
        return self.w[i].shape[-1]


def _geometry(cfg: ModelConfig, filters_mod: int) -> bool:
    return (
        tuple(cfg.input_shape) == (TILE_F, TILE_T, 1)
        and all(k[0] == k[1] and k[0] % 2 == 1 and k[0] <= 7
                for k in (*cfg.kernels, cfg.out_kernel))
        and all(c % filters_mod == 0 and c <= 64 for c in cfg.filters)
    )


def supports(cfg: ModelConfig) -> bool:
    """Geometries the kernels run at depth 2: odd square kernels up to 7,
    32 or 64 filters per layer, (256, 128, 1) tiles (as the JAX kernel)."""
    return cfg.depth == 2 and _geometry(cfg, 32)


def supports3(cfg: ModelConfig) -> bool:
    """Geometries the kernels run at depth 3: odd square kernels up to 7,
    filters multiples of 16 up to 64, (256, 128, 1) tiles (as the JAX
    kernel)."""
    return cfg.depth == 3 and _geometry(cfg, 16)


def kernel_depth(cfg: ModelConfig, depth: int | None = None) -> int:
    """The depth of the kernel family that covers ``cfg``: 2 (``supports``)
    or 3 (``supports3``).  Raises ``NotImplementedError`` for a geometry
    that neither covers, or, given ``depth``, that family does not."""
    d = 2 if supports(cfg) else 3 if supports3(cfg) else None
    if d is None or depth not in (None, d):
        raise NotImplementedError(
            "the AE kernels run odd square kernels <= 7 with 32/64-channel "
            "filters at depth 2 or filters that are multiples of 16 up to 64 "
            f"at depth 3{'' if depth is None else f' (asked: depth {depth})'}: {cfg}"
        )
    return d


def build_kernel_weights(model: ConvAutoencoder, dtype=torch.bfloat16,
                         depth: int | None = None) -> AEKernelWeights:
    """The layer table of a module that a kernel family covers (of
    ``depth``, if given; see ``kernel_depth``) in the kernels' layout, on
    the module's device."""
    d = kernel_depth(model.cfg, depth)
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"service dtype must be float32 or bfloat16: {dtype}")
    layers = (*model.enc_convs, *model.dec_deconvs[::-1], model.out_conv)
    ws, bs, wts = [], [], []
    for i, conv in enumerate(layers):
        w = conv.weight.detach().float()
        if d <= i < 2 * d:  # torch (in, out, kh, kw), flipped -> Flax, unflipped
            w = w.flip(2, 3).permute(0, 2, 3, 1)
        else:               # torch (out, in, kh, kw)
            w = w.permute(1, 2, 3, 0)
        ws.append(w.to(dtype).contiguous())
        bs.append(conv.bias.detach().float().contiguous())
        mma = 1 <= i < 2 * d and dtype == torch.bfloat16
        wts.append(ws[-1].permute(1, 2, 3, 0).contiguous() if mma else None)
    return AEKernelWeights(tuple(ws), tuple(bs), dtype, tuple(wts))


# ---------------------------------------------------------------------------
# input checks shared by both paths
# ---------------------------------------------------------------------------


def _check_act(x: torch.Tensor, wts: AEKernelWeights, layer: int) -> None:
    cin = wts.w[layer].shape[0]
    if x.dtype != wts.dtype:
        raise TypeError(f"activation dtype {x.dtype} != service dtype {wts.dtype}")
    if x.ndim != 4 or x.shape[1] != cin or x.shape[0] < 1:
        raise ValueError(f"expected (B, {cin}, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("activations must be contiguous")


def _check_specs(specs: torch.Tensor, k_tiles: int) -> None:
    if specs.dtype != torch.float32:
        raise TypeError(f"spectrograms must be float32, got {specs.dtype}")
    if (specs.ndim != 3 or specs.shape[1] != TILE_F or k_tiles < 1
            or specs.shape[2] < k_tiles * TILE_T):
        raise ValueError(
            f"spectrograms must be (C, {TILE_F}, >= {k_tiles}*{TILE_T}), "
            f"got {tuple(specs.shape)}"
        )
    if specs.stride(2) != 1:  # channel and row strides are kernel arguments
        raise ValueError("spectrogram rows must be contiguous")


def _raw_strides(raw: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                 k_tiles: int, layout: str) -> Tuple[int, int, int]:
    """Checks a raw log-PSD in ``layout``; returns its (channel, frequency,
    time) strides."""
    if layout not in ("tf", "ft"):
        raise ValueError(f"layout must be 'tf' or 'ft', not {layout!r}")
    if raw.dtype != torch.float32 or mn.dtype != torch.float32 or mx.dtype != torch.float32:
        raise TypeError(f"raw log-PSD and min/max must be float32: {raw.dtype}, "
                        f"{mn.dtype}, {mx.dtype}")
    if raw.ndim != 3 or k_tiles < 1:
        raise ValueError(f"raw log-PSD must be (C, F, T) or (C, T, F), got {tuple(raw.shape)}")
    c, s1, s2 = raw.stride()
    n1, n2 = raw.shape[1:]
    (nf, fs), (nt, ts) = ((n1, s1), (n2, s2)) if layout == "ft" else ((n2, s2), (n1, s1))
    if nf < TILE_F or nt < k_tiles * TILE_T:
        raise ValueError(f"raw log-PSD ({layout}) needs >= {TILE_F} frequencies and "
                         f">= {k_tiles}*{TILE_T} frames, got {tuple(raw.shape)}")
    if mn.shape != (raw.shape[0], 1) or mx.shape != (raw.shape[0], 1):
        raise ValueError(f"min/max must be ({raw.shape[0]}, 1), got {tuple(mn.shape)}, "
                         f"{tuple(mx.shape)}")
    return c, fs, ts


def _on_device(x: torch.Tensor, wts: AEKernelWeights) -> None:
    """The CUDA path: weights must sit on x's device."""
    if any(t is not None and t.device != x.device for t in (*wts.w, *wts.b, *wts.wt)):
        raise ValueError(f"weights are not on {x.device}")


# ---------------------------------------------------------------------------
# plain twins of the stages
# ---------------------------------------------------------------------------


def _conv_w(wts: AEKernelWeights, i: int) -> torch.Tensor:
    return wts.w[i].float().permute(3, 0, 1, 2)          # (out, in, kh, kw)


def _conv_pool(x: torch.Tensor, wts: AEKernelWeights, i: int) -> torch.Tensor:
    y = F.conv2d(x, _conv_w(wts, i), wts.b[i], padding=wts.k(i) // 2)
    return F.max_pool2d(F.relu(y), 2).to(wts.dtype)


def ae_tile_in_plain(wts: AEKernelWeights, specs: torch.Tensor, k_tiles: int
                     ) -> torch.Tensor:
    tiles = patch(specs[:, :, : k_tiles * TILE_T])[:, None]
    return _conv_pool(tiles.to(wts.dtype).float(), wts, 0)


def normalized_tiles(raw: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                     k_tiles: int, layout: str) -> torch.Tensor:
    """(C*k, 256, 128) float32 tiles of the min-max normalized raw log-PSD
    (``layout`` "tf" or "ft"), the values ``ae_tile_in_norm`` loads."""
    v = raw if layout == "ft" else raw.transpose(1, 2)
    v = v[:, :TILE_F, : k_tiles * TILE_T]
    return patch((v - mn[:, :, None]) / (mx - mn)[:, :, None])


def ae_tile_in_norm_plain(wts: AEKernelWeights, raw: torch.Tensor, mn: torch.Tensor,
                          mx: torch.Tensor, k_tiles: int, layout: str) -> torch.Tensor:
    """Normalize, ``patch``, cast, conv1 + relu + pool."""
    tiles = normalized_tiles(raw, mn, mx, k_tiles, layout)[:, None]
    return _conv_pool(tiles.to(wts.dtype).float(), wts, 0)


def ae_conv_pool_plain(wts: AEKernelWeights, x: torch.Tensor, layer: int = 1
                       ) -> torch.Tensor:
    return _conv_pool(x.float(), wts, layer)


def ae_convt_plain(wts: AEKernelWeights, x: torch.Tensor, layer: int
                   ) -> torch.Tensor:
    w = wts.w[layer].float().permute(0, 3, 1, 2).flip(2, 3)  # torch layout
    y = F.relu(conv_transpose_same(x.float(), w, wts.b[layer]))
    return y.to(wts.dtype).contiguous()  # the crop leaves a strided view


def ae_tile_out_plain(wts: AEKernelWeights, x: torch.Tensor, k_tiles: int
                      ) -> torch.Tensor:
    o = wts.out
    y = F.conv2d(x.float(), _conv_w(wts, o), wts.b[o], padding=wts.k(o) // 2)
    return unpatch(torch.sigmoid(y)[:, 0], tiles_per_spec=k_tiles)


# ---------------------------------------------------------------------------
# stage wrappers
# ---------------------------------------------------------------------------


def conv_in_strip(cout: int, pool: bool) -> int:
    """Rows of a strip (one block) of ``conv_in_mma_kernel``
    (``csrc/ae_conv.cuh``) with ``cout`` output channels: a pooled stage
    (``pool``: S1's ``CiPoolEpi``, conv 0's ``CiPoolMaskEpi``) takes 16
    rows up to 32 channels and 8 above; the out-conv's input gradient,
    whose stage holds every row at full width (``CiGateEpi``), 8, 4 and 2
    rows for 16, 32 and 48-64 channels."""
    if pool:
        return 16 if cout <= 32 else 8
    return 8 if cout <= 16 else 4 if cout <= 32 else 2


def _conv_in_smem(k: int, cout: int, pool: bool, bits: bool = False) -> int:
    """Shared memory of a ``conv_in_mma_kernel`` block (``ci_smem_bytes``):
    the window's two copies (rows of 76 words), the B fragments of the k (k
    + 1) / 2 tap pairs in 16-slot chunks, the epilogue's stage (one channel
    4 words apart from the next; with ``bits``, conv 0's routing bytes
    after the pooled values, ``CiPoolMaskEpi``)."""
    rows = conv_in_strip(cout, pool)
    window = 2 * (rows + 2 * (k // 2)) * 76
    chunks = (k * (k + 1) + 15) // 16
    stage = cout * ((rows // 2 * 32 if pool else rows * 64) + 4)
    if bits:
        stage += cout * (rows // 2 * 16 + 4)
    return 4 * window + chunks * (cout // 8) * 32 * 8 + 4 * stage


def ae_tile_in(wts: AEKernelWeights, specs: torch.Tensor, k_tiles: int
               ) -> torch.Tensor:
    """S1: (C, 256, >= k*128) float32 spectrograms -> (C*k, c1, 128, 64)
    pooled conv1 activations in the service dtype; on the card in bf16
    ``conv_in_mma_kernel``, in float32 ``conv_quad_kernel``."""
    _check_specs(specs, k_tiles)
    if not specs.is_cuda:
        return ae_tile_in_plain(wts, specs, k_tiles)
    _on_device(specs, wts)
    b, cout = specs.shape[0] * k_tiles, wts.cout(0)
    out = torch.empty(b, cout, TILE_F // 2, TILE_T // 2, dtype=wts.dtype,
                      device=specs.device)
    TILE_IN(specs.data_ptr(), k_tiles, specs.stride(0), specs.stride(1),
            wts.w[0].data_ptr(), wts.b[0].data_ptr(), out.data_ptr(),
            _DTYPE_CODE[wts.dtype], b, cout, TILE_F, TILE_T, wts.k(0))
    return out


def ae_tile_in_norm(wts: AEKernelWeights, raw: torch.Tensor, mn: torch.Tensor,
                    mx: torch.Tensor, k_tiles: int, layout: str) -> torch.Tensor:
    """S1 on the raw log-PSD: (C, F >= 256, T >= k*128) (``layout="ft"``,
    K10's route) or (C, T, F) (``layout="tf"``, K9's route) float32 and the
    per-channel (C, 1) min/max -> (C*k, c1, 128, 64) pooled conv1
    activations; equal to ``ae_tile_in`` on the normalized spectrograms (on
    the card the same template: ``conv_in_mma_kernel`` in bf16,
    ``conv_quad_kernel`` in float32)."""
    c, fs, ts = _raw_strides(raw, mn, mx, k_tiles, layout)
    if not raw.is_cuda:
        return ae_tile_in_norm_plain(wts, raw, mn, mx, k_tiles, layout)
    _on_device(raw, wts)
    mn, mx = mn.reshape(-1).contiguous(), mx.reshape(-1).contiguous()
    b, cout = raw.shape[0] * k_tiles, wts.cout(0)
    out = torch.empty(b, cout, TILE_F // 2, TILE_T // 2, dtype=wts.dtype,
                      device=raw.device)
    TILE_IN_NORM(raw.data_ptr(), mn.data_ptr(), mx.data_ptr(), k_tiles, c, fs, ts,
                 wts.w[0].data_ptr(), wts.b[0].data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[wts.dtype], b, cout, TILE_F, TILE_T, wts.k(0))
    return out


def ae_conv_pool(wts: AEKernelWeights, x: torch.Tensor, layer: int = 1
                 ) -> torch.Tensor:
    """S2: encoder conv ``layer`` (1 .. d-1), (B, Cin, H, W) -> (B, Cout,
    H/2, W/2); on the card in bf16 ``conv_igemm_kernel`` (``wt[layer]``),
    in float32 ``conv_quad_kernel``."""
    if not 1 <= layer < wts.depth:
        raise ValueError(f"pooled conv layers are 1..{wts.depth - 1}, not {layer}")
    _check_act(x, wts, layer)
    if not x.is_cuda:
        return ae_conv_pool_plain(wts, x, layer)
    _on_device(x, wts)
    b, cin, h, w = x.shape
    cout = wts.cout(layer)
    out = torch.empty(b, cout, h // 2, w // 2, dtype=wts.dtype, device=x.device)
    wk = wts.w[layer] if wts.wt[layer] is None else wts.wt[layer]
    CONV_POOL(x.data_ptr(), wk.data_ptr(), wts.b[layer].data_ptr(),
              out.data_ptr(), _DTYPE_CODE[wts.dtype], b, cin, cout, h, w,
              wts.k(layer))
    return out


def convt_igemm_rows(w: int) -> int:
    """Input rows of a strip of ``convt_igemm_kernel`` (``csrc/ae_conv.cuh``)
    over a grid ``w`` columns wide: a block's 8 warps hold one 16-position
    fragment each, 128 positions, so R = 128 / w (``ct_strip_rows``)."""
    return 128 // w


def ae_convt(wts: AEKernelWeights, x: torch.Tensor, layer: int) -> torch.Tensor:
    """S3: transposed conv ``layer`` (d .. 2d-1; at depth 2 layer 2 is
    convT2, 3 convT1), (B, Cin, H, W) -> (B, Cout, 2H, 2W); on the card in
    bf16 ``convt_igemm_kernel`` (``wt[layer]``), in float32
    ``convt_relu_kernel``."""
    if not wts.is_convt(layer):
        raise ValueError(f"transposed-conv layers are {wts.depth}..{wts.out - 1}, "
                         f"not {layer}")
    _check_act(x, wts, layer)
    if not x.is_cuda:
        return ae_convt_plain(wts, x, layer)
    _on_device(x, wts)
    b, cin, h, w = x.shape
    cout = wts.cout(layer)
    out = torch.empty(b, cout, 2 * h, 2 * w, dtype=wts.dtype, device=x.device)
    wk = wts.w[layer] if wts.wt[layer] is None else wts.wt[layer]
    CONVT(x.data_ptr(), wk.data_ptr(), wts.b[layer].data_ptr(),
          out.data_ptr(), _DTYPE_CODE[wts.dtype], b, cin, cout, h, w,
          wts.k(layer))
    return out


CONV_OUT_BAND = 64  # rows a conv_out_mma_kernel block walks (CO_BAND)


def _conv_out_smem(k: int, cin: int, rows: int, ring: int) -> int:
    """Shared memory of a ``conv_out_mma_kernel`` block (``co_smem_bytes``):
    the ring of ``ring`` rows of every channel (+8 bf16 a channel), a
    strip's tap sums, the weights' B fragments."""
    return cin * (ring * TILE_T + 8) * 2 + rows * TILE_T * k * 4 + (cin // 16) * k * 32 * 8


def conv_out_plan(k: int, cin: int) -> Tuple[int, int]:
    """(strip rows, strips in flight ahead) of ``conv_out_mma_kernel``
    (``csrc/ae_conv.cuh`` ``co_plan``) at kernel size ``k`` over ``cin``
    input channels: the most rows of 8, 4, 2 whose ring with one strip
    ahead (2 (k // 2) + 2 rows rows of every channel) keeps two blocks an
    SM in its 228 KB (1 KB reserved a block), else the most that fit one
    block (227 KB); then the most strips ahead, up to 3, that keep as many
    blocks an SM.  Raises where nothing fits."""
    r = k // 2
    for room in (228 * 1024 // 2 - 1024, 227 * 1024):
        for rows in (8, 4, 2):
            if _conv_out_smem(k, cin, rows, 2 * r + 2 * rows) > room:
                continue
            pf = 1
            while pf < 3 and _conv_out_smem(k, cin, rows, 2 * r + (pf + 2) * rows) <= room:
                pf += 1
            return rows, pf
    raise ValueError(f"conv_out_mma_kernel: {cin} channels at k{k} do not fit")


def conv_out_rows(k: int, cin: int) -> int:
    """Output rows of a strip of ``conv_out_mma_kernel``: a block walks a
    band of ``CONV_OUT_BAND`` rows of one tile in strips of this many."""
    return conv_out_plan(k, cin)[0]


def ae_tile_out(wts: AEKernelWeights, x: torch.Tensor, k_tiles: int
                ) -> torch.Tensor:
    """S4: (C*k, c1, 256, 128) -> (C, 256, k*128) float32 restitched
    sigmoid output; on the card in bf16 ``conv_out_mma_kernel``, in
    float32 ``conv_quad_kernel``."""
    o = wts.out
    _check_act(x, wts, o)
    b, cin, h, w = x.shape
    if (h, w) != (TILE_F, TILE_T) or b % k_tiles:
        raise ValueError(f"expected (C*{k_tiles}, {cin}, {TILE_F}, {TILE_T}), "
                         f"got {tuple(x.shape)}")
    if not x.is_cuda:
        return ae_tile_out_plain(wts, x, k_tiles)
    _on_device(x, wts)
    out = torch.empty(b // k_tiles, h, k_tiles * w, dtype=torch.float32,
                      device=x.device)
    TILE_OUT(x.data_ptr(), wts.w[o].data_ptr(), wts.b[o].data_ptr(),
             out.data_ptr(), k_tiles, out.stride(0), out.stride(1),
             _DTYPE_CODE[wts.dtype], b, cin, h, w, wts.k(o))
    return out


def ae_kernel_enhance_specs(wts: AEKernelWeights, specs: torch.Tensor,
                            k_tiles: int) -> torch.Tensor:
    """(C, 256, T) spectrograms -> (C, 256, k*128) restitched enhancement:
    patch -> AE -> unpatch, as the stages: one S1, d-1 S2, d S3, one S4."""
    return _enhance_pooled(wts, ae_tile_in(wts, specs, k_tiles), k_tiles)


def ae_kernel_enhance_raw(wts: AEKernelWeights, raw: torch.Tensor, mn: torch.Tensor,
                          mx: torch.Tensor, k_tiles: int, layout: str) -> torch.Tensor:
    """``ae_kernel_enhance_specs`` of the normalized spectrograms, from the
    raw log-PSD in ``layout`` and its (C, 1) min/max: S1 is
    ``ae_tile_in_norm``."""
    return _enhance_pooled(wts, ae_tile_in_norm(wts, raw, mn, mx, k_tiles, layout),
                           k_tiles)


def _enhance_pooled(wts: AEKernelWeights, x: torch.Tensor, k_tiles: int) -> torch.Tensor:
    """The stages after S1."""
    for i in range(1, wts.depth):
        x = ae_conv_pool(wts, x, i)
    for i in range(wts.depth, wts.out):
        x = ae_convt(wts, x, i)
    return ae_tile_out(wts, x, k_tiles)


def ae_kernel_apply(wts: AEKernelWeights, tiles: torch.Tensor) -> torch.Tensor:
    """(B, 256, 128) tiles -> (B, 256, 128) sigmoid probabilities."""
    return ae_kernel_enhance_specs(wts, tiles, 1)


def ae_kernel_enhance_specs_plain(model: ConvAutoencoder, specs: torch.Tensor,
                                  k_tiles: int, dtype=None) -> torch.Tensor:
    """Plain twin of the whole AE: ``patch``, the module, ``unpatch``; the
    module computes in its own dtype, or in ``dtype`` when given."""
    tiles = patch(specs[:, :, : k_tiles * TILE_T])
    out = model(tiles) if dtype is None else model.forward_as(tiles, dtype)
    return unpatch(out, tiles_per_spec=k_tiles)
