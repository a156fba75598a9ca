"""K2 + K3 + K4, depth-2 conv-AE inference on the spectrograms: the CUDA
stage kernels' wrappers and their plain twins (the counterpart of
``specenh.ops.ae_kernel`` and the tile turns of ``specenh.ops.parity_turn``).

``ae_kernel_enhance_specs`` runs four stage kernels of ``csrc/ae.cu``:

  ae_tile_in    S1  K2 (tile load + cast) fused with conv1 + relu + pool
  ae_conv_pool  S2  conv2 + relu + pool
  ae_convt      S3  stride-2 transposed conv + relu, twice
  ae_tile_out   S4  out-conv + sigmoid fused with K4 (restitched store)

Each stage wrapper launches its kernel for CUDA tensors and runs its plain
twin (``*_plain``: ``F.conv2d`` and friends on float32 copies of values
rounded to the service dtype, the kernel's rounding points) for CPU
tensors.  The whole AE's plain twin is ``ae_kernel_enhance_specs_plain``:
``patch``, the ``nn.Module``, ``unpatch``.

Activations stay in the service dtype (bf16 or float32), NCHW per tile;
sums are float32 and biases float32, as in the TPU kernel.  An unsupported
geometry raises in ``build_kernel_weights``; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from specenh.config import ModelConfig, PatchSpec
from specenh_torch._build import CudaKernel
from specenh_torch.data.tiles import patch, unpatch
from specenh_torch.models.autoencoder import ConvAutoencoder, conv_transpose_same

__all__ = [
    "AEKernelWeights", "supports", "build_kernel_weights",
    "ae_tile_in", "ae_conv_pool", "ae_convt", "ae_tile_out",
    "ae_tile_in_plain", "ae_conv_pool_plain", "ae_convt_plain",
    "ae_tile_out_plain", "ae_kernel_enhance_specs", "ae_kernel_apply",
    "ae_kernel_enhance_specs_plain",
]

TILE_F, TILE_T = PatchSpec().tile_freq, PatchSpec().tile_time  # 256, 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
TILE_IN = CudaKernel("ae", "ae_tile_in",
                     [_p, _i, _i64, _i64, _p, _p, _p, _i, _i, _i, _i, _i, _i])
CONV_POOL = CudaKernel("ae", "ae_conv_pool",
                       [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i])
CONVT = CudaKernel("ae", "ae_convt_relu",
                   [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i])
TILE_OUT = CudaKernel("ae", "ae_tile_out",
                      [_p, _p, _p, _p, _i, _i64, _i64, _i, _i, _i, _i, _i, _i])


@dataclasses.dataclass(frozen=True)
class AEKernelWeights:
    """The five layers in the kernels' layout: ``w[i]`` (Cin, kh, kw, Cout)
    in the service dtype (transposed convs: the Flax kernel, unflipped),
    ``b[i]`` (Cout,) float32.  Layers: conv1, conv2, convT2, convT1, out."""

    w: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]
    dtype: torch.dtype

    def k(self, i: int) -> int:
        return self.w[i].shape[1]

    def cout(self, i: int) -> int:
        return self.w[i].shape[-1]


def supports(cfg: ModelConfig) -> bool:
    """Geometries the kernels run: depth 2, odd square kernels up to 7,
    32 or 64 filters per layer, (256, 128, 1) tiles (as the JAX kernel)."""
    return (
        cfg.depth == 2
        and tuple(cfg.input_shape) == (TILE_F, TILE_T, 1)
        and all(k[0] == k[1] and k[0] % 2 == 1 and k[0] <= 7
                for k in (*cfg.kernels, cfg.out_kernel))
        and all(c % 32 == 0 and c <= 64 for c in cfg.filters)
    )


def build_kernel_weights(model: ConvAutoencoder, dtype=torch.bfloat16
                         ) -> AEKernelWeights:
    """The kernels' weights from the module, on the module's device."""
    if not supports(model.cfg):
        raise NotImplementedError(
            "the AE kernels run depth-2 geometries with odd square kernels "
            f"<= 7 and 32/64-channel filters: {model.cfg}"
        )
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"service dtype must be float32 or bfloat16: {dtype}")
    enc, dec = model.enc_convs, model.dec_deconvs
    layers = (enc[0], enc[1], dec[1], dec[0], model.out_conv)
    ws, bs = [], []
    for i, conv in enumerate(layers):
        w = conv.weight.detach().float()
        if i in (2, 3):  # torch (in, out, kh, kw), flipped -> Flax, unflipped
            w = w.flip(2, 3).permute(0, 2, 3, 1)
        else:            # torch (out, in, kh, kw)
            w = w.permute(1, 2, 3, 0)
        ws.append(w.to(dtype).contiguous())
        bs.append(conv.bias.detach().float().contiguous())
    return AEKernelWeights(tuple(ws), tuple(bs), dtype)


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


def _on_device(x: torch.Tensor, wts: AEKernelWeights) -> None:
    """The CUDA path: weights must sit on x's device."""
    if any(t.device != x.device for t in (*wts.w, *wts.b)):
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


def ae_conv_pool_plain(wts: AEKernelWeights, x: torch.Tensor) -> torch.Tensor:
    return _conv_pool(x.float(), wts, 1)


def ae_convt_plain(wts: AEKernelWeights, x: torch.Tensor, layer: int
                   ) -> torch.Tensor:
    w = wts.w[layer].float().permute(0, 3, 1, 2).flip(2, 3)  # torch layout
    y = F.relu(conv_transpose_same(x.float(), w, wts.b[layer]))
    return y.to(wts.dtype).contiguous()  # the crop leaves a strided view


def ae_tile_out_plain(wts: AEKernelWeights, x: torch.Tensor, k_tiles: int
                      ) -> torch.Tensor:
    y = F.conv2d(x.float(), _conv_w(wts, 4), wts.b[4], padding=wts.k(4) // 2)
    return unpatch(torch.sigmoid(y)[:, 0], tiles_per_spec=k_tiles)


# ---------------------------------------------------------------------------
# stage wrappers
# ---------------------------------------------------------------------------


def ae_tile_in(wts: AEKernelWeights, specs: torch.Tensor, k_tiles: int
               ) -> torch.Tensor:
    """S1: (C, 256, >= k*128) float32 spectrograms -> (C*k, c1, 128, 64)
    pooled conv1 activations in the service dtype."""
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


def ae_conv_pool(wts: AEKernelWeights, x: torch.Tensor) -> torch.Tensor:
    """S2: (B, c1, H, W) -> (B, c2, H/2, W/2)."""
    _check_act(x, wts, 1)
    if not x.is_cuda:
        return ae_conv_pool_plain(wts, x)
    _on_device(x, wts)
    b, cin, h, w = x.shape
    cout = wts.cout(1)
    out = torch.empty(b, cout, h // 2, w // 2, dtype=wts.dtype, device=x.device)
    CONV_POOL(x.data_ptr(), wts.w[1].data_ptr(), wts.b[1].data_ptr(),
              out.data_ptr(), _DTYPE_CODE[wts.dtype], b, cin, cout, h, w,
              wts.k(1))
    return out


def ae_convt(wts: AEKernelWeights, x: torch.Tensor, layer: int) -> torch.Tensor:
    """S3: (B, Cin, H, W) -> (B, Cout, 2H, 2W), layer 2 (convT2) or 3
    (convT1)."""
    if layer not in (2, 3):
        raise ValueError(f"transposed-conv layers are 2 and 3, not {layer}")
    _check_act(x, wts, layer)
    if not x.is_cuda:
        return ae_convt_plain(wts, x, layer)
    _on_device(x, wts)
    b, cin, h, w = x.shape
    cout = wts.cout(layer)
    out = torch.empty(b, cout, 2 * h, 2 * w, dtype=wts.dtype, device=x.device)
    CONVT(x.data_ptr(), wts.w[layer].data_ptr(), wts.b[layer].data_ptr(),
          out.data_ptr(), _DTYPE_CODE[wts.dtype], b, cin, cout, h, w,
          wts.k(layer))
    return out


def ae_tile_out(wts: AEKernelWeights, x: torch.Tensor, k_tiles: int
                ) -> torch.Tensor:
    """S4: (C*k, c1, 256, 128) -> (C, 256, k*128) float32 restitched
    sigmoid output."""
    _check_act(x, wts, 4)
    b, cin, h, w = x.shape
    if (h, w) != (TILE_F, TILE_T) or b % k_tiles:
        raise ValueError(f"expected (C*{k_tiles}, {cin}, {TILE_F}, {TILE_T}), "
                         f"got {tuple(x.shape)}")
    if not x.is_cuda:
        return ae_tile_out_plain(wts, x, k_tiles)
    _on_device(x, wts)
    out = torch.empty(b // k_tiles, h, k_tiles * w, dtype=torch.float32,
                      device=x.device)
    TILE_OUT(x.data_ptr(), wts.w[4].data_ptr(), wts.b[4].data_ptr(),
             out.data_ptr(), k_tiles, out.stride(0), out.stride(1),
             _DTYPE_CODE[wts.dtype], b, cin, h, w, wts.k(4))
    return out


def ae_kernel_enhance_specs(wts: AEKernelWeights, specs: torch.Tensor,
                            k_tiles: int) -> torch.Tensor:
    """(C, 256, T) spectrograms -> (C, 256, k*128) restitched enhancement:
    patch -> AE -> unpatch, as the four stages."""
    x = ae_tile_in(wts, specs, k_tiles)
    x = ae_conv_pool(wts, x)
    x = ae_convt(wts, x, 2)
    x = ae_convt(wts, x, 3)
    return ae_tile_out(wts, x, k_tiles)


def ae_kernel_apply(wts: AEKernelWeights, tiles: torch.Tensor) -> torch.Tensor:
    """(B, 256, 128) tiles -> (B, 256, 128) sigmoid probabilities."""
    return ae_kernel_enhance_specs(wts, tiles, 1)


def ae_kernel_enhance_specs_plain(model: ConvAutoencoder, specs: torch.Tensor,
                                  k_tiles: int) -> torch.Tensor:
    """Plain twin of the whole AE: ``patch``, the module, ``unpatch``."""
    tiles = patch(specs[:, :, : k_tiles * TILE_T])
    return unpatch(model(tiles), tiles_per_spec=k_tiles)
