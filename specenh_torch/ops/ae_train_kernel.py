"""Conv-AE training on the CUDA stage kernels: K5 + K5b at depth 2, K7 at
depth 3 (``ops.ae3_train_kernel`` gives these functions the JAX package's
depth-3 names).  The stage kernels'
wrappers, their plain twins, the gradient as a ``torch.autograd.Function``,
and the epoch engines (the counterpart of ``specenh.ops.ae_train_kernel``).

The stages are depth-generic, over the layer table of ``ops.ae_kernel``
(depth d: encoder convs 0 .. d-1, transposed convs d .. 2d-1, out-conv 2d).
One step (``kernel_loss_grad_sums``) runs the stages of
``csrc/ae_train.cu``:

  forward   ae_train_in        conv 0 + relu + pool -> p1, pool routing bits
            ae_train_conv_pool convs 1 .. d-1 + relu + pool, routing bits
            ae_convt (ae.cu)   the d transposed convs + relu
            ae_train_loss      out-conv -> logits, BCE sum, dz, its db
  backward  ae_train_wgrad / ae_train_dgrad_conv / ae_train_dgrad_convt,
            layer by layer down to conv 0 (ae_train_wgrad_x)
  sums      ae_train_sum       every stage's partials (the BCE, the bias
                               and weight gradients) in one plan, at most
                               two launches at the step's end (StepSums)

K5 (``pre=False``) reads float32 tiles and rounds x and y to the kernel
dtype as it loads them; K5b (``pre=True``, ``pre_layout=True`` in the epoch
engine) reads tiles cast to the kernel dtype once per epoch, through its
own entry points ``ae_train_in_pre`` and ``ae_train_loss_pre`` (conv1's
weight gradient then runs on the generic ``ae_train_wgrad``).  The cast is
value-exact, so both give the same sums bit for bit.

Rounding follows the TPU kernel: x, y, weights and every stored activation
and dz in the kernel dtype; sums, biases, logits and bias gradients float32;
each dz rounded once, before both of its products.  dz5 is UNNORMALISED:
the wrapper divides by mask_sum * 256 * 128.  The pool backward routes to
every maximal phase of a window whose max is > 0 (4 bits per pooled value);
this is not ``F.max_pool2d``'s backward, which picks one.

Each stage wrapper launches its kernel for CUDA tensors and runs its plain
twin (``*_plain``, the same math in float32 on values rounded where the
kernel rounds, its sums accumulated in float64) for CPU tensors.  An unsupported geometry raises; a kernel
that fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from specenh_torch.config import ModelConfig, PatchSpec
from specenh_torch._build import CudaKernel
from specenh_torch.models.autoencoder import ConvAutoencoder, convt_pad_before
from specenh_torch.ops import ae_kernel as AK
from specenh_torch.ops.ae_kernel import kernel_depth, supports
from specenh_torch.utils.logging import span

__all__ = [
    "TrainWeights", "supports", "kernel_depth", "build_train_weights",
    "ae_train_in", "ae_train_conv_pool", "ae_train_loss",
    "ae_train_dgrad_conv", "ae_train_dgrad_convt", "ae_train_wgrad",
    "ae_train_sum", "ae_train_in_plain", "ae_train_conv_pool_plain",
    "ae_train_loss_plain", "ae_train_dgrad_conv_plain",
    "ae_train_dgrad_convt_plain", "ae_train_wgrad_plain",
    "WgradPlan", "wgrad_plan", "dgrad_convt_rows", "conv_igemm_rows", "conv_in_rows",
    "sum_slabs",
    "StepSums", "step_partials", "step_sums",
    "train_weights", "route_bits", "route_expand", "route_bits64",
    "loss_grad_sums", "bce_sum", "normalise",
    "kernel_loss_grad_sums", "kernel_loss_grad_sums_plain",
    "kernel_bce_sum", "kernel_value_and_grad",
    "masked_bce_from_logits", "make_kernel_train_step",
    "kernel_train_epoch_fn", "TRAIN_KERNELS",
]

TILE_F, TILE_T = PatchSpec().tile_freq, PatchSpec().tile_time  # 256, 128
NQ = 128  # threads of a quad / position block in ae_train.cu (NT)
_DT = {torch.float32: 0, torch.bfloat16: 1}

_p, _i = ctypes.c_void_p, ctypes.c_int
TRAIN_IN = CudaKernel("ae_train", "ae_train_in", [_p, _p, _p, _p, _p] + [_i] * 6)
TRAIN_IN_PRE = CudaKernel("ae_train", "ae_train_in_pre", [_p, _p, _p, _p, _p] + [_i] * 6)
TRAIN_CONV_POOL = CudaKernel("ae_train", "ae_train_conv_pool",
                             [_p, _p, _p, _p, _p] + [_i] * 7)
TRAIN_LOSS = CudaKernel("ae_train", "ae_train_loss", [_p] * 8 + [_i] * 7)
TRAIN_LOSS_PRE = CudaKernel("ae_train", "ae_train_loss_pre", [_p] * 8 + [_i] * 7)
DGRAD_CONV = CudaKernel("ae_train", "ae_train_dgrad_conv", [_p] * 6 + [_i] * 8)
DGRAD_CONVT = CudaKernel("ae_train", "ae_train_dgrad_convt",
                         [_p, _p, _p, _i, _p, _p] + [_i] * 8)
WGRAD = CudaKernel("ae_train", "ae_train_wgrad", [_p] * 4 + [_i] * 15)
WGRAD_X = CudaKernel("ae_train", "ae_train_wgrad_x", [_p] * 4 + [_i] * 10)
TRAIN_SUM = CudaKernel("ae_train", "ae_train_sum", [_p, _i, _p])
TRAIN_KERNELS = (TRAIN_IN, TRAIN_IN_PRE, TRAIN_CONV_POOL, TRAIN_LOSS,
                 TRAIN_LOSS_PRE, DGRAD_CONV, DGRAD_CONVT, WGRAD, WGRAD_X,
                 TRAIN_SUM)


def _layer_params(depth: int) -> Tuple[str, ...]:
    """Kernel layer i -> the module's parameter name prefix: the encoder
    convs, the transposed convs from the bottom up, the out-conv."""
    return (*(f"enc_convs.{i}" for i in range(depth)),
            *(f"dec_deconvs.{i}" for i in reversed(range(depth))), "out_conv")


@dataclasses.dataclass(frozen=True)
class TrainWeights:
    """The forward weights (``ae_kernel.AEKernelWeights``) and, for layers 1
    to 2d, the input-gradient operands ``bwd[i]`` in the kernel dtype: for
    the stride-1 convs the kernel transposed and flipped in space, (Cout,
    K, K, Cin) for ``conv_quad_kernel`` (and, the out-conv's (1, K, K, C1)
    in bf16, for ``conv_in_mma_kernel``) or, for the encoder convs that run
    on the tensor cores (those with ``fwd.wt[i]``), (K, K, Cin, Cout) with
    dz's channel fastest; for the transposed convs (K, K, Cin, Cout), the
    kernel with the channel of dz fastest."""

    fwd: AK.AEKernelWeights
    bwd: Tuple[torch.Tensor | None, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.fwd.dtype


def build_train_weights(model: ConvAutoencoder, dtype=torch.bfloat16,
                        depth: int | None = None) -> TrainWeights:
    """The kernels' weights from the module (raises for a geometry that no
    kernel family, or not that of ``depth``, covers)."""
    return train_weights(AK.build_kernel_weights(model, dtype, depth))


def train_weights(fwd: AK.AEKernelWeights) -> TrainWeights:
    """The forward weights of any depth with their input-gradient
    operands."""
    bwd = [None]
    for i in range(1, fwd.out + 1):
        w = fwd.w[i]
        if fwd.is_convt(i):
            w = w.permute(1, 2, 0, 3)
        elif fwd.wt[i] is not None:  # the tensor-core kernel's: dz's channel fastest
            w = w.flip(1, 2).permute(1, 2, 0, 3)
        else:
            w = w.flip(1, 2).permute(3, 1, 2, 0)
        bwd.append(w.contiguous())
    return TrainWeights(fwd, tuple(bwd))


def grads_to_torch(gw, gb) -> Dict[str, torch.Tensor]:
    """Kernel-layout gradients (per layer: (Cin, K, K, Cout), (Cout,)) ->
    a dict keyed like ``model.named_parameters()``."""
    out = {}
    depth = (len(gw) - 1) // 2
    for i, name in enumerate(_layer_params(depth)):
        g = gw[i]
        g = (g.permute(0, 3, 1, 2).flip(2, 3) if depth <= i < 2 * depth
             else g.permute(3, 0, 1, 2))
        out[f"{name}.weight"] = g.contiguous()
        out[f"{name}.bias"] = gb[i]
    return out


# ---------------------------------------------------------------------------
# pool routing and input checks
# ---------------------------------------------------------------------------


def route_bits(r: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Routing bits of a 2x2 max pool: bit a*2+b of out[m, n] is set where
    r[2m+a, 2n+b] == p[m, n] and p[m, n] > 0; uint8 (B, C, H/2, W/2)."""
    b, c, h, w = r.shape
    rq = r.reshape(b, c, h // 2, 2, w // 2, 2)
    hit = (rq == p[:, :, :, None, :, None]) & (p > 0)[:, :, :, None, :, None]
    weight = torch.tensor([[1, 2], [4, 8]], dtype=torch.int32, device=r.device)
    return (hit.int() * weight[:, None, :]).sum((3, 5)).to(torch.uint8)


def route_expand(v: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) pooled gradient -> (B, C, 2H, 2W) at every routed pixel."""
    b, c, h, w = v.shape
    out = torch.zeros(b, c, h, 2, w, 2, dtype=v.dtype, device=v.device)
    for a in (0, 1):
        for bb in (0, 1):
            hit = ((bits >> (a * 2 + bb)) & 1).to(v.dtype)
            out[:, :, :, a, :, bb] = v * hit
    return out.reshape(b, c, 2 * h, 2 * w)


def route_bits64(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """Conv 0's routing bits computed in float64 (``route_bits`` of
    relu(conv(x, w) + bias)), and the near ties: (B, Cout, H/2, W/2) bool,
    the pool windows whose bits float32 rounding may decide, where the
    window's largest value lies within the bound of 0, or is positive and
    within the bound of its second largest.  The bound, 2^-17 (128 float32
    ulps) times the window's largest sum of |terms| (the taps' |w x| and
    |bias|), is more than twice the error of a float32 sum of its <= 50
    terms in any order: a float32 evaluation routes a window as float64
    does, and two float32 evaluations route it alike, outside the near
    ties.  x (B, H, W) as the kernel reads it (rounded to the kernel
    dtype), w (1, K, K, Cout), bias (Cout,)."""
    k = w.shape[1]
    w64, x64, b64 = w.double().permute(3, 0, 1, 2), x.double()[:, None], bias.double()
    z = F.conv2d(x64, w64, b64, padding=k // 2)
    mag = F.conv2d(x64.abs(), w64.abs(), b64.abs(), padding=k // 2)
    b, c, h, wd = z.shape
    win = z.reshape(b, c, h // 2, 2, wd // 2, 2).permute(0, 1, 2, 4, 3, 5)
    top = win.reshape(b, c, h // 2, wd // 2, 4).topk(2, -1).values
    tol = 2.0 ** -17 * F.max_pool2d(mag, 2)
    near = (top[..., 0].abs() <= tol) | ((top[..., 0] > tol) & (top[..., 0] - top[..., 1] <= tol))
    r = F.relu(z)
    return route_bits(r, F.max_pool2d(r, 2)), near


def _popcount(bits: torch.Tensor) -> torch.Tensor:
    return sum(((bits >> q) & 1).float() for q in range(4))


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tiles(x: torch.Tensor, name: str, dtypes) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype}, expected one of {dtypes}")
    if x.ndim != 3 or x.shape[0] < 1 or tuple(x.shape[1:]) != (TILE_F, TILE_T):
        raise ValueError(f"{name}: expected (B, {TILE_F}, {TILE_T}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_device(x: torch.Tensor, tw: TrainWeights) -> None:
    if any(t.device != x.device for t in (*tw.fwd.w, *tw.fwd.b, *tw.bwd[1:])):
        raise ValueError(f"weights are not on {x.device}")


def _act_shape(tw: TrainWeights, layer: int, b: int):
    """Shape of the activation a layer reads: (B, Cin, H, W), at 1 / 2^s
    of the tile with s = min(layer, 2d - layer)."""
    cin = tw.fwd.w[layer].shape[0]
    s = min(layer, tw.fwd.out - layer)
    return (b, cin, TILE_F >> s, TILE_T >> s)


def _rows(b: int, h: int, w: int) -> int:
    """Partial rows of a conv_quad_kernel launch over an (h, w) grid."""
    return b * (((h // 2) * (w // 2) + NQ - 1) // NQ)


def conv_igemm_rows(b: int, h: int, w: int, cout: int) -> int:
    """Partial rows of ``conv_igemm_kernel`` (``csrc/ae_conv.cuh``) over an
    (h, w) grid with ``cout`` output channels: one per (tile, strip of R
    rows).  A block's 8 warps each hold a row pair x 16 columns, all in
    one group up to 32 channels and in two groups (half the channels each)
    for 48 and 64, so a strip is 256 or 128 positions: R = positions / w
    (``ig_strip_rows``)."""
    pos = 32 * (8 if cout <= 32 else 4)
    return b * (h // (pos // w))


def conv_in_rows(b: int, h: int, cout: int) -> int:
    """Partial rows of ``conv_in_mma_kernel`` (``csrc/ae_conv.cuh``) as
    the out-conv's input gradient over an (h, 128) grid with ``cout``
    channels: one per (tile, strip of ``ae_kernel.conv_in_strip(cout,
    pool=False)`` rows)."""
    return b * (h // AK.conv_in_strip(cout, pool=False))


def _loss_rows(tw: TrainWeights, b: int) -> int:
    """Partial rows (BCE, db) of the loss over ``b`` tiles: in bf16
    ``conv_out_mma_kernel`` writes one per (tile, band of
    ``ae_kernel.CONV_OUT_BAND`` rows), in float32 ``conv_quad_kernel`` one
    per quad block."""
    if tw.dtype == torch.bfloat16:
        return b * (TILE_F // AK.CONV_OUT_BAND)
    return _rows(b, TILE_F, TILE_T)


def _dgrad_conv_rows(tw: TrainWeights, layer: int, b: int, h: int, w: int) -> int:
    """Partial rows of a stride-1 input-gradient launch over an (h, w) grid:
    the encoder convs' on ``conv_igemm_kernel`` and the bf16 out-conv's on
    ``conv_in_mma_kernel`` one per (tile, strip), else one per quad block."""
    cout = tw.fwd.w[layer].shape[0]
    if tw.fwd.wt[layer] is not None:
        return conv_igemm_rows(b, h, w, cout)
    if layer == tw.fwd.out and tw.dtype == torch.bfloat16:
        return conv_in_rows(b, h, cout)
    return _rows(b, h, w)


def dgrad_convt_rows(b: int, h: int, w: int, cout: int) -> int:
    """Partial rows of ``convt_dgrad_kernel`` over an (h, w) output grid
    with ``cout`` channels: one per (tile, strip of R rows), where a block
    holds 8 warps of 16-position fragments, 8 // (cout / 8) a warp (one
    from 48 channels up), and R = min(positions / w, h)."""
    nf = cout // 8
    pos = 8 * 16 * (1 if nf >= 6 else 8 // nf)
    return b * (h // min(pos // w, h))


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _conv_pool_mask(x: torch.Tensor, tw: TrainWeights, i: int):
    r = F.relu(F.conv2d(x, AK._conv_w(tw.fwd, i), tw.fwd.b[i],
                        padding=tw.fwd.k(i) // 2))
    p = F.max_pool2d(r, 2)
    return p.to(tw.dtype), route_bits(r, p)


def ae_train_in_plain(tw: TrainWeights, x: torch.Tensor):
    return _conv_pool_mask(x.to(tw.dtype).float()[:, None], tw, 0)


def ae_train_conv_pool_plain(tw: TrainWeights, p: torch.Tensor, layer: int = 1):
    return _conv_pool_mask(p.float(), tw, layer)


def ae_train_loss_plain(tw: TrainWeights, e: torch.Tensor, y: torch.Tensor,
                        mask: torch.Tensor):
    o = tw.fwd.out
    z = F.conv2d(e.float(), AK._conv_w(tw.fwd, o), tw.fwd.b[o],
                 padding=tw.fwd.k(o) // 2)[:, 0]
    # elementwise in float64: torch's vectorised float32 exp / log1p may
    # differ by an ulp with the tensor's alignment, which would make two
    # calls on the same values disagree
    zd, yr, m = z.double(), y.to(tw.dtype).double(), mask.double()[:, None, None]
    dz = ((torch.sigmoid(zd) - yr) * m).float()
    per = zd.clamp_min(0) - zd * yr + torch.log1p(torch.exp(-zd.abs()))
    return (z, dz.to(tw.dtype)[:, None], _sum64(per * m).reshape(1),
            _sum64(dz).reshape(1))


def _sum64(t: torch.Tensor, dims=None) -> torch.Tensor:
    """A sum accumulated in float64, returned as float32: the twins' sums
    do not depend on the order a reduction takes."""
    t = t.double()
    return (t.sum() if dims is None else t.sum(dims)).float()


def _gate(v: torch.Tensor, gate: torch.Tensor, dtype):
    """(stored output, float32 dz whose sum is the bias gradient)."""
    if gate.dtype == torch.uint8:
        return v.to(dtype).contiguous(), v * _popcount(gate)
    g = v * (gate.float() > 0)
    return g.to(dtype).contiguous(), g


def ae_train_dgrad_conv_plain(tw: TrainWeights, layer: int, dz: torch.Tensor,
                              gate: torch.Tensor, dz_bits=None):
    d = dz.float() if dz_bits is None else route_expand(dz.float(), dz_bits)
    v = F.conv_transpose2d(d, AK._conv_w(tw.fwd, layer), padding=tw.fwd.k(layer) // 2)
    out, g = _gate(v, gate, tw.dtype)
    return out, _sum64(g, (0, 2, 3))


def _convt_dz_taps(dz: torch.Tensor, k: int, h: int, w: int) -> torch.Tensor:
    """dz[..., 2m + PA - i, 2n + PA - j] as (B, C, K, K, H, W), zero outside."""
    pa = convt_pad_before(k)
    lead = k - 1 - pa
    dzp = F.pad(dz, (lead, pa + 1, lead, pa + 1))
    b, c = dz.shape[:2]
    cols = F.unfold(dzp, k, stride=2)            # (B, C*K*K, (H+1)*(W+1))
    cols = cols.reshape(b, c, k, k, h + 1, w + 1)[..., :h, :w]
    return cols.flip(2, 3)                        # index t = K-1-i -> i


def ae_train_dgrad_convt_plain(tw: TrainWeights, layer: int, dz: torch.Tensor,
                               gate: torch.Tensor):
    k = tw.fwd.k(layer)
    h, w = dz.shape[2] // 2, dz.shape[3] // 2
    taps = _convt_dz_taps(dz.float(), k, h, w)
    v = torch.einsum("bcijmn,oijc->bomn", taps, tw.fwd.w[layer].float())
    out, g = _gate(v, gate, tw.dtype)
    return out, _sum64(g, (0, 2, 3))


def ae_train_wgrad_plain(tw: TrainWeights, layer: int, inp: torch.Tensor,
                         dz: torch.Tensor, dz_bits=None):
    """(Cin, K, K, Cout) float32 weight gradient of one layer."""
    k = tw.fwd.k(layer)
    x = inp.to(tw.dtype).float()
    x = x[:, None] if x.ndim == 3 else x
    d = dz.float() if dz_bits is None else route_expand(dz.float(), dz_bits)
    b, cin, h, w = x.shape
    x, d = x.double(), d.double()
    if tw.fwd.is_convt(layer):
        taps = _convt_dz_taps(d, k, h, w)
        return torch.einsum("bcmn,boijmn->cijo", x, taps).float()
    cols = F.unfold(x, k, padding=k // 2).reshape(b, cin, k, k, h * w)
    return torch.einsum("bcijp,bop->cijo", cols, d.flatten(2)).float()


# ---------------------------------------------------------------------------
# stage wrappers
# ---------------------------------------------------------------------------


_SUM_BLOCKS = 264  # two blocks on each of the card's 132 SMs
_SUM_SLAB = 64     # the fewest rows a slab takes: 8 for each of a block's warps


def sum_slabs(n: int, m: int) -> int:
    """The row slabs of ``ae_train_sum``'s first pass over (n, m) partials:
    ``ceil(m / 32)`` column groups times the slabs fill the card, and each
    slab has at least 64 rows; 1 is a single pass."""
    return max(1, min(_SUM_BLOCKS // -(-m // 32), n // _SUM_SLAB))


class StepSums:
    """A plan that sums many (n, m) float32 partial arrays on the card in at
    most two launches of ``ae_train_sum``: ``add(part)`` returns the (m,)
    view of one output buffer (``cols`` columns in all) that will hold
    part's sums, ``run()`` computes every sum added, each in the fixed order
    of its own ``ae_train_sum`` call: the same bits.  A training step hands
    every stage's partials to one plan and runs it at the step's end,
    before anything reads the sums."""

    def __init__(self, cols: int, device):
        self.out = torch.empty(cols, dtype=torch.float32, device=device)
        self._parts, self._used = [], 0

    def add(self, part: torch.Tensor) -> torch.Tensor:
        _check(part, "partials", torch.float32, part.shape)
        if part.ndim != 2 or not part.is_cuda:
            raise ValueError(f"partials must be (n, m) on the card, got {tuple(part.shape)} "
                             f"on {part.device}")
        col, self._used = self._used, self._used + part.shape[1]
        if self._used > self.out.numel():
            raise ValueError(f"the plan holds {self.out.numel()} columns")
        self._parts.append((part, col))
        return self.out[col:self._used]

    def run(self) -> None:
        """The sums of every part added, then the plan is empty."""
        if not self._parts:
            return
        seg, off = [], 0
        for p, col in self._parts:
            n, m = p.shape
            slabs = sum_slabs(n, m)
            seg += [p.data_ptr(), self.out.data_ptr() + 4 * col, n, m, slabs, off]
            off += slabs * m if slabs > 1 else 0
        scratch = torch.empty(off, dtype=torch.float32, device=self.out.device) if off else None
        TRAIN_SUM((ctypes.c_longlong * len(seg))(*seg), len(self._parts),
                  0 if scratch is None else scratch.data_ptr())
        self._parts = []


def step_partials(tw: TrainWeights, b: int):
    """The (n, m) partial arrays a step of ``b`` tiles sums on the card, in
    the order its stages hand them to the plan: the loss's (the BCE and the
    out-conv's bias gradient), then from the out-conv down each layer's
    weight gradient and the bias gradient of the layer below."""
    w = tw.fwd

    def wgrad(i):
        h, wd = _act_shape(tw, i, b)[2:]
        stride, off = (2, convt_pad_before(w.k(i))) if w.is_convt(i) else (1, w.k(i) // 2)
        plan = wgrad_plan(w.w[i].shape[0], w.cout(i), w.k(i), h, wd, stride, off,
                          tw.dtype.itemsize)
        return b * plan.sg, w.w[i].numel()

    def dgrad(i):  # the input gradient's bias partials, of the layer below
        _, c, h, wd = _act_shape(tw, i, b)
        rows = dgrad_convt_rows(b, h, wd, c) if w.is_convt(i) else _dgrad_conv_rows(
            tw, i, b, h, wd)
        return rows, c

    out = [(_loss_rows(tw, b), 2)]
    for i in range(w.out, 0, -1):
        out += [wgrad(i), dgrad(i)]
    return out + [wgrad(0)]


def step_sums(tw: TrainWeights, device) -> StepSums:
    """The plan of one step's sums (``step_partials``): the parameters'
    gradients and the BCE, one column each."""
    return StepSums(1 + sum(t.numel() for t in (*tw.fwd.w, *tw.fwd.b)), device)


def _sum(part: torch.Tensor, sums: StepSums | None) -> torch.Tensor:
    """part's (m,) sums: now, or when ``sums`` runs."""
    return ae_train_sum(part) if sums is None else sums.add(part)


def ae_train_sum(part: torch.Tensor) -> torch.Tensor:
    """(n, m) float32 partials -> (m,) sums, in a fixed order: on the card
    each warp sums every 8th row of its slab of ``sum_slabs`` over 32
    columns, then a fixed tree over the warps, then the slabs' sums in
    order."""
    _check(part, "partials", torch.float32, part.shape)
    if part.ndim != 2:
        raise ValueError(f"partials must be (n, m), got {tuple(part.shape)}")
    if not part.is_cuda:
        return _sum64(part, 0)
    sums = StepSums(part.shape[1], part.device)
    out = sums.add(part)
    sums.run()
    return out


def ae_train_in(tw: TrainWeights, x: torch.Tensor, pre: bool = False):
    """conv1 + relu + pool: (B, 256, 128) tiles, float32 (K5) or in the
    kernel dtype (K5b, ``pre=True``) -> p1 (B, C1, 128, 64), bits (uint8).
    On the card in bf16 ``conv_in_mma_kernel`` (both tile dtypes stage the
    same bits), in float32 ``conv_quad_kernel``."""
    _check_tiles(x, "tiles", (tw.dtype,) if pre else (torch.float32,))
    if not x.is_cuda:
        return ae_train_in_plain(tw, x)
    _on_device(x, tw)
    b, c1 = x.shape[0], tw.fwd.cout(0)
    out = torch.empty(b, c1, TILE_F // 2, TILE_T // 2, dtype=tw.dtype, device=x.device)
    bits = torch.empty(out.shape, dtype=torch.uint8, device=x.device)
    (TRAIN_IN_PRE if pre else TRAIN_IN)(
        x.data_ptr(), tw.fwd.w[0].data_ptr(), tw.fwd.b[0].data_ptr(),
        out.data_ptr(), bits.data_ptr(), _DT[tw.dtype], b, c1, TILE_F, TILE_T,
        tw.fwd.k(0))
    return out, bits


def ae_train_conv_pool(tw: TrainWeights, p: torch.Tensor, layer: int = 1):
    """Encoder conv ``layer`` (1 .. d-1) + relu + pool, with routing bits:
    at depth 2, p1 (B, C1, 128, 64) -> p2 (B, C2, 64, 32).  On the card in
    bf16 ``conv_igemm_kernel``, in float32 ``conv_quad_kernel``."""
    if not 1 <= layer < tw.fwd.depth:
        raise ValueError(f"pooled conv layers are 1..{tw.fwd.depth - 1}, not {layer}")
    _check(p, f"input of layer {layer}", tw.dtype, _act_shape(tw, layer, p.shape[0]))
    if not p.is_cuda:
        return ae_train_conv_pool_plain(tw, p, layer)
    _on_device(p, tw)
    b, cin, h, w = p.shape
    cout = tw.fwd.cout(layer)
    out = torch.empty(b, cout, h // 2, w // 2, dtype=tw.dtype, device=p.device)
    bits = torch.empty(out.shape, dtype=torch.uint8, device=p.device)
    wk = tw.fwd.w[layer] if tw.fwd.wt[layer] is None else tw.fwd.wt[layer]
    TRAIN_CONV_POOL(p.data_ptr(), wk.data_ptr(),
                    tw.fwd.b[layer].data_ptr(), out.data_ptr(), bits.data_ptr(),
                    _DT[tw.dtype], b, cin, cout, h, w, tw.fwd.k(layer))
    return out, bits


def ae_train_loss(tw: TrainWeights, e: torch.Tensor, y: torch.Tensor,
                  mask: torch.Tensor, pre: bool = False, sums: StepSums | None = None):
    """out-conv + masked sigmoid-BCE: e (B, C1, 256, 128), labels y
    (B, 256, 128) float32 (K5) or in the kernel dtype (K5b), tile mask (B,)
    float32 -> (logits (B, 256, 128) float32, dz5 (B, 1, 256, 128) in the
    kernel dtype, BCE sum (1,), db5 (1,)).  On the card in bf16
    ``conv_out_mma_kernel`` (one partial row per (tile, band)), in float32
    ``conv_quad_kernel`` (one per quad block): ``_loss_rows``.  The two sums
    are taken now, or, given a step's plan ``sums``, when it runs; so for
    the other stages' sums."""
    b, o = e.shape[0], tw.fwd.out
    _check(e, "e", tw.dtype, _act_shape(tw, o, b))
    _check_tiles(y, "labels", (tw.dtype,) if pre else (torch.float32,))
    _check(mask, "mask", torch.float32, (b,))
    if y.shape[0] != b or y.device != e.device or mask.device != e.device:
        raise ValueError("labels and mask must match the batch and device of e")
    if not e.is_cuda:
        return ae_train_loss_plain(tw, e, y, mask)
    _on_device(e, tw)
    logits = torch.empty(b, TILE_F, TILE_T, dtype=torch.float32, device=e.device)
    dz = torch.empty(b, 1, TILE_F, TILE_T, dtype=tw.dtype, device=e.device)
    rows = _loss_rows(tw, b)
    part = torch.empty(rows, 2, dtype=torch.float32, device=e.device)
    (TRAIN_LOSS_PRE if pre else TRAIN_LOSS)(
        e.data_ptr(), tw.fwd.w[o].data_ptr(), tw.fwd.b[o].data_ptr(),
        y.data_ptr(), mask.data_ptr(), logits.data_ptr(), dz.data_ptr(),
        part.data_ptr(), rows, _DT[tw.dtype], b, e.shape[1], TILE_F, TILE_T,
        tw.fwd.k(o))
    out = _sum(part, sums)
    return logits, dz, out[0:1], out[1:2]


def ae_train_dgrad_conv(tw: TrainWeights, layer: int, dz: torch.Tensor,
                        gate: torch.Tensor, dz_bits=None, sums: StepSums | None = None):
    """Input gradient of a stride-1 conv, gated, and the bias gradient of
    the layer below.  The out-conv (layer 2d): its dz (B, 1, 256, 128),
    gate = its input e -> (dz of the last transposed conv, its db).  An
    encoder conv i (1 .. d-1): dz routed from the pooled gradient (B, Ci+1,
    H/2, W/2) and layer i's bits, gate = layer i-1's bits (B, Ci, H, W) ->
    (the pooled gradient of layer i-1, its db).  On the card in bf16 the
    out-conv (one dz channel) runs ``conv_in_mma_kernel`` (one bias partial
    row per (tile, strip): ``conv_in_rows``) and the encoder convs
    ``conv_igemm_kernel`` (``conv_igemm_rows``); every float32 launch
    ``conv_quad_kernel`` (one per quad block)."""
    out_layer = layer == tw.fwd.out
    if not (out_layer or 1 <= layer < tw.fwd.depth):
        raise ValueError(f"stride-1 input gradients are of layers 1..{tw.fwd.depth - 1} "
                         f"and {tw.fwd.out}, not {layer}")
    cout = tw.fwd.w[layer].shape[0]
    b = dz.shape[0]
    shape = _act_shape(tw, layer, b)
    if out_layer:
        _check(dz, "dz", tw.dtype, (b, 1, *shape[2:]))
        _check(gate, "gate", tw.dtype, shape)
    else:
        cz = tw.fwd.cout(layer)
        _check(dz, "dz", tw.dtype, (b, cz, shape[2] // 2, shape[3] // 2))
        if dz_bits is None:
            raise ValueError(f"layer {layer}'s input gradient reads dz through its routing bits")
        _check(dz_bits, "dz bits", torch.uint8, dz.shape)
        _check(gate, "gate", torch.uint8, shape)
    if not dz.is_cuda:
        return ae_train_dgrad_conv_plain(tw, layer, dz, gate, dz_bits)
    _on_device(dz, tw)
    h, w = shape[2:]
    out = torch.empty(shape, dtype=tw.dtype, device=dz.device)
    rows = _dgrad_conv_rows(tw, layer, b, h, w)
    part = torch.empty(rows, cout, dtype=torch.float32, device=dz.device)
    DGRAD_CONV(dz.data_ptr(), 0 if dz_bits is None else dz_bits.data_ptr(),
               tw.bwd[layer].data_ptr(), gate.data_ptr(), out.data_ptr(),
               part.data_ptr(), rows, _DT[tw.dtype], b, dz.shape[1], cout, h, w,
               tw.fwd.k(layer))
    return out, _sum(part, sums)


def ae_train_dgrad_convt(tw: TrainWeights, layer: int, dz: torch.Tensor,
                         gate: torch.Tensor, sums: StepSums | None = None):
    """Input gradient of a stride-2 transposed conv (layer d .. 2d-1),
    gated, and the bias gradient of the layer below: dz (B, Cout, 2H, 2W),
    gate = the layer's input (B, Cin, H, W) -> (its dz, its db).  The
    first one (layer d) reads the last encoder conv's pool: gate = its
    routing bits -> (the pooled gradient, the encoder conv's db).  At depth
    2, layer 3 (convT1) takes dz4 (B, C1, 256, 128) -> dz3 and layer 2
    (convT2) dz3 (B, C2, 128, 64) -> dp2.  On the card the kernel writes
    one bias partial row per (tile, strip) (``dgrad_convt_rows``), summed
    in a fixed order by ``ae_train_sum``."""
    if not tw.fwd.is_convt(layer):
        raise ValueError(f"transposed-conv layers are {tw.fwd.depth}..{tw.fwd.out - 1}, "
                         f"not {layer}")
    routed = layer == tw.fwd.depth
    b = dz.shape[0]
    shape = _act_shape(tw, layer, b)
    cz = tw.fwd.cout(layer)
    _check(dz, "dz", tw.dtype, (b, cz, 2 * shape[2], 2 * shape[3]))
    _check(gate, "gate", torch.uint8 if routed else tw.dtype, shape)
    if not dz.is_cuda:
        return ae_train_dgrad_convt_plain(tw, layer, dz, gate)
    _on_device(dz, tw)
    if dz.data_ptr() % 16:
        raise ValueError("the transposed convs' input-gradient kernel reads a 16-byte aligned dz")
    h, w = shape[2:]
    out = torch.empty(shape, dtype=tw.dtype, device=dz.device)
    rows = dgrad_convt_rows(b, h, w, shape[1])
    part = torch.empty(rows, shape[1], dtype=torch.float32, device=dz.device)
    DGRAD_CONVT(dz.data_ptr(), tw.bwd[layer].data_ptr(), gate.data_ptr(),
                int(routed), out.data_ptr(), part.data_ptr(), rows,
                _DT[tw.dtype], b, cz, shape[1], h, w, tw.fwd.k(layer))
    return out, _sum(part, sums)


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """How ``csrc/ae_train.cu``'s ``wgrad_kernel`` splits one layer's weight
    gradient.  The GEMM ``D[(t, tap), c] = sum_p T[t][p + shift(tap)] P[c][p]``
    (stride 1: T = the input, P = dz; stride 2: T = dz's four phase planes,
    P = the input) has ``ct * k * k`` rows in 16-row fragments; a block owns
    one tile, one of ``sg`` groups of its grid rows (one partial row each)
    and one of ``slices`` slices of ``gm * mw`` fragments, walks its rows in
    strips of ``rows`` with T's halo ``hlo .. hhi``; its 8 warps are ``gm``
    groups of ``mw`` fragments times ``8 // gm`` groups of positions."""

    ct: int
    cp: int
    k: int
    stride: int
    off: int
    hlo: int
    hhi: int
    rows: int
    sg: int
    mw: int
    gm: int
    slices: int

    def taps(self):
        """(plane, dy, dx) of each tap, as the kernel's ``wg_tap``."""
        out = []
        for tap in range(self.k * self.k):
            i, j = divmod(tap, self.k)
            if self.stride == 1:
                out.append((0, i - self.off, j - self.off))
            else:
                a, c = self.off - i, self.off - j
                out.append(((a & 1) * 2 + (c & 1), a >> 1, c >> 1))
        return out


_WG_WARPS = 8
_WG_SMEM = 112 * 1024  # a block's shared memory budget: two blocks an SM
# The most 16-position steps one accumulator takes in a row: the error of
# the tensor cores' float32 accumulation grows with the length of the chain
# (a bf16 k7 out-conv gradient, 2048 steps, was 1.1e-4 of its scale off the
# twin on an H100), so the rows of a tile are split into more groups
# (partial rows).
_WG_CHAIN = 128


def _wg_bytes(ct, cp, k, h, w, rows, nph, hlo, hhi, gm, mw, item) -> int:
    """Shared memory of a block, as ``wg_geometry`` in ae_train.cu."""
    xs0 = hlo // 8 * 8
    nc = -(-(w + hhi - xs0) // 8)
    ldt = 8 * nc + ((8 if nc % 2 == 0 else 0) if item == 2 else 4)
    wpe = 2 if item == 2 else 1
    words = rows * w // wpe
    pcs = (words + (36 - words % 32) % 32) * wpe
    tmax = min(ct, (gm * mw * 16 - 1) // (k * k) + 2)
    stage = (tmax * nph * (rows + hhi - hlo) * ldt + cp * pcs) * item
    np_ = -(-cp // 8)
    red = _WG_WARPS * 32 * (4 if np_ <= 4 else 2) * np_ * 16 if gm < _WG_WARPS else 0
    return max(stage, red)


def wgrad_plan(cin: int, cout: int, k: int, h: int, w: int, stride: int,
               off: int, item: int) -> WgradPlan:
    """The weight-gradient kernel's split of a layer whose input grid is
    (h, w), for operands of ``item`` bytes: warps take up to ``mw``
    fragments each (at most 64 accumulators a thread), the fragments fill
    as few warp groups as they can, a tile's rows are split into groups
    until there are 4 blocks a tile and no accumulator takes more than
    ``_WG_CHAIN`` steps, and the strips are as tall as the shared memory
    budget allows."""
    ct, cp = (cin, cout) if stride == 1 else (cout, cin)
    mf, np_ = -(-ct * k * k // 16), -(-cp // 8)
    mw = min(4 if np_ <= 4 else 2, -(-mf // _WG_WARPS))
    gm = 1
    while gm < _WG_WARPS and gm * mw < mf:
        gm *= 2
    slices = -(-mf // (gm * mw))
    shifts = [d for _, d, _ in WgradPlan(ct, cp, k, stride, off, 0, 0, 0, 0, 0, 0, 0).taps()]
    hlo, hhi = min(shifts), max(shifts)
    gp = _WG_WARPS // gm
    sg = 1
    while (slices * sg < 4 or h // sg * w // 16 > _WG_CHAIN * gp) and h % (4 * sg) == 0:
        sg *= 2
    nph = 4 if stride == 2 else 1
    rows = 2
    while (h % (sg * rows * 2) == 0
           and _wg_bytes(ct, cp, k, h, w, rows * 2, nph, hlo, hhi, gm, mw, item) <= _WG_SMEM):
        rows *= 2
    return WgradPlan(ct, cp, k, stride, off, hlo, hhi, rows, sg, mw, gm, slices)


def ae_train_wgrad(tw: TrainWeights, layer: int, inp: torch.Tensor,
                   dz: torch.Tensor, dz_bits=None, pre: bool = False,
                   sums: StepSums | None = None) -> torch.Tensor:
    """Weight gradient (Cin, K, K, Cout) float32 of one layer, summed over
    the batch: ``inp`` is the layer's input (for conv 0 the tiles: float32
    through ``ae_train_wgrad_x``, K5, or with ``pre=True`` in the kernel
    dtype, K5b), ``dz`` the gradient at its output, or for the encoder
    convs the pooled gradient with its routing bits.  On the card the
    kernel writes one partial row per (tile, row group of ``wgrad_plan``),
    summed in a fixed order by ``ae_train_sum``."""
    if layer not in range(tw.fwd.out + 1):
        raise ValueError(f"layers are 0..{tw.fwd.out}, not {layer}")
    convt = tw.fwd.is_convt(layer)
    b = inp.shape[0]
    shape = _act_shape(tw, layer, b)
    cout, k = tw.fwd.cout(layer), tw.fwd.k(layer)
    h, w = shape[2:]
    hz, wz = (2 * h, 2 * w) if convt else (h, w)
    if layer == 0:
        _check_tiles(inp, "tiles", (tw.dtype,) if pre else (torch.float32,))
    else:
        _check(inp, "input", tw.dtype, shape)
    if layer < tw.fwd.depth:
        if dz_bits is None:
            raise ValueError(f"layer {layer}'s dz is read through its routing bits")
        _check(dz, "dz", tw.dtype, (b, cout, hz // 2, wz // 2))
        _check(dz_bits, "dz bits", torch.uint8, dz.shape)
    else:
        _check(dz, "dz", tw.dtype, (b, cout, hz, wz))
    if not inp.is_cuda:
        return ae_train_wgrad_plain(tw, layer, inp, dz, dz_bits)
    _on_device(inp, tw)
    if any(t.data_ptr() % 16 for t in (inp, dz, dz_bits) if t is not None):
        raise ValueError("the weight-gradient kernel reads 16-byte aligned tensors")
    cin = shape[1]
    stride, off = (2, convt_pad_before(k)) if convt else (1, k // 2)
    plan = wgrad_plan(cin, cout, k, h, w, stride, off, tw.dtype.itemsize)
    part = torch.empty(b * plan.sg, cin * k * k * cout, dtype=torch.float32,
                       device=inp.device)
    bits = 0 if dz_bits is None else dz_bits.data_ptr()
    split = (plan.rows, plan.sg, plan.mw, plan.gm)
    if layer == 0 and not pre:
        WGRAD_X(inp.data_ptr(), dz.data_ptr(), bits, part.data_ptr(),
                _DT[tw.dtype], b, cout, h, w, k, *split)
    else:
        WGRAD(inp.data_ptr(), dz.data_ptr(), bits, part.data_ptr(),
              _DT[tw.dtype], b, cin, cout, h, w, hz, wz, k, stride, off, *split)
    return _sum(part, sums).reshape(cin, k, k, cout)


# ---------------------------------------------------------------------------
# one step: forward stages, backward stages, sums
# ---------------------------------------------------------------------------

_KERNEL = dict(in_=ae_train_in, conv_pool=ae_train_conv_pool, convt=AK.ae_convt,
               loss=ae_train_loss, wgrad=ae_train_wgrad,
               dgrad_conv=ae_train_dgrad_conv, dgrad_convt=ae_train_dgrad_convt)
_PLAIN = dict(in_=lambda tw, x, pre: ae_train_in_plain(tw, x),
              conv_pool=ae_train_conv_pool_plain, convt=AK.ae_convt_plain,
              loss=lambda tw, e, y, m, pre: ae_train_loss_plain(tw, e, y, m),
              wgrad=lambda tw, i, a, d, bits=None, pre=False:
                  ae_train_wgrad_plain(tw, i, a, d, bits),
              dgrad_conv=ae_train_dgrad_conv_plain,
              dgrad_convt=ae_train_dgrad_convt_plain)


def _forward(tw: TrainWeights, x, y, mask, pre: bool, f=_KERNEL):
    """Forward stages; returns (what the backward reads, logits, BCE sum).
    ``act[i]`` is layer i's input (``act[0]`` the tiles), ``bits[i]`` the
    routing bits of encoder conv i's pool; ``dz`` the out-conv's dz and
    ``db`` its bias gradient."""
    d = tw.fwd.depth
    act, bits = [x], []
    p, pm = f["in_"](tw, x, pre)
    act.append(p)
    bits.append(pm)
    for i in range(1, d):
        p, pm = f["conv_pool"](tw, p, i)
        act.append(p)
        bits.append(pm)
    for i in range(d, 2 * d):
        act.append(f["convt"](tw.fwd, act[-1], i))
    logits, dz, bce, db = f["loss"](tw, act[-1], y, mask, pre)
    return dict(act=act, bits=bits, dz=dz, db=db), logits, bce


def _backward(tw: TrainWeights, s, pre: bool, f=_KERNEL):
    """Backward stages, from the out-conv down; returns the kernel-layout
    gradient sums (gw, gb)."""
    d, o = tw.fwd.depth, tw.fwd.out
    act, bits, dz = s["act"], s["bits"], s["dz"]
    gw, gb = [None] * (o + 1), [None] * (o + 1)
    gb[o] = s["db"]
    gw[o] = f["wgrad"](tw, o, act[o], dz)
    dz, gb[o - 1] = f["dgrad_conv"](tw, o, dz, act[o])
    for i in range(o - 1, d - 1, -1):  # the transposed convs, top down
        gw[i] = f["wgrad"](tw, i, act[i], dz)
        # the lowest one's input is the last pool's output: routed gate
        dz, gb[i - 1] = f["dgrad_convt"](tw, i, dz, act[i] if i > d else bits[d - 1])
    for i in range(d - 1, 0, -1):  # the encoder convs: dz is a pooled gradient
        gw[i] = f["wgrad"](tw, i, act[i], dz, bits[i])
        dz, gb[i - 1] = f["dgrad_conv"](tw, i, dz, bits[i - 1], bits[i])
    gw[0] = f["wgrad"](tw, 0, act[0], dz, bits[0], pre=pre)
    return gw, gb


def _tiles(t: torch.Tensor) -> torch.Tensor:
    """(B, 256, 128) or the JAX layout (B, 256, 128, 1), contiguous."""
    return (t[..., 0] if t.ndim == 4 else t).contiguous()


def _check_pre(depth: int, pre: bool) -> None:
    if pre and depth != 2:
        raise NotImplementedError("the pre-cast entry points (K5b) are depth 2's; the "
                                  "JAX package's depth-3 kernel has no pre-cast variant")


def _inputs(tw, x, y, mask, pre):
    _check_pre(tw.fwd.depth, pre)
    x, y = _tiles(x), _tiles(y)
    if pre:
        x, y = x.to(tw.dtype), y.to(tw.dtype)
    return x, y, mask.to(torch.float32).contiguous()


def _stages_into(sums: StepSums):
    """The kernel stages, each handing its partials to the step's plan."""
    return dict(_KERNEL, **{k: functools.partial(_KERNEL[k], sums=sums)
                            for k in ("loss", "wgrad", "dgrad_conv", "dgrad_convt")})


def _step(tw: TrainWeights, x, y, mask, pre: bool, plain: bool):
    """(BCE sum (1,), kernel-layout (gw, gb)) of checked inputs, from the
    stage twins (``plain``) or the stage kernels.  On the card every sum of
    the step is one plan (``step_sums``), run after the last stage."""
    sums = step_sums(tw, x.device) if x.is_cuda and not plain else None
    f = _PLAIN if plain else _KERNEL if sums is None else _stages_into(sums)
    saved, _, bce = _forward(tw, x, y, mask, pre, f)
    grads = _backward(tw, saved, pre, f)
    if sums is not None:
        sums.run()
    return bce, grads


def loss_grad_sums(tw: TrainWeights, x, y, mask, pre: bool = False,
                   plain: bool = False):
    """UNNORMALISED (bce_sum, mask_sum, grad_sums) of one batch, for
    weights of any depth: from the stage kernels, or with ``plain=True``
    from the stage twins on any device."""
    x, y, mask = _inputs(tw, x, y, mask, pre)
    bce, grads = _step(tw, x, y, mask, pre, plain)
    return bce[0], mask.sum(), grads_to_torch(*grads)


def kernel_loss_grad_sums(model: ConvAutoencoder, x, y, mask,
                          dtype=torch.bfloat16, pre: bool = False):
    """UNNORMALISED (bce_sum, mask_sum, grad_sums) of one batch from the
    stage kernels, at depth 2 or 3: the building block of data-parallel
    training (sum all three over the devices, then divide by mask_sum * 256
    * 128).  ``grad_sums`` is keyed like ``model.named_parameters()``."""
    return loss_grad_sums(build_train_weights(model, dtype), x, y, mask, pre)


def kernel_loss_grad_sums_plain(model: ConvAutoencoder, x, y, mask,
                                dtype=torch.bfloat16):
    """The plain twin of ``kernel_loss_grad_sums``, from the stage twins, on
    any device."""
    return loss_grad_sums(build_train_weights(model, dtype), x, y, mask, plain=True)


class _KernelBCE(torch.autograd.Function):
    """The masked BCE sum of a batch through the stage kernels.  As the TPU
    kernel, forward runs the whole step, the forward and the backward
    stages (on the card their sums one plan); backward returns the
    parameters' gradients, moved from the kernels' weight layout to torch's
    and scaled by the incoming gradient (for the mean loss: 1 / (mask_sum *
    256 * 128))."""

    @staticmethod
    def forward(ctx, x, y, mask, tw, pre, names, *params):
        bce, grads = _step(tw, x, y, mask, pre, False)
        ctx.names, ctx.grads = names, grads_to_torch(*grads)
        return bce.reshape(())

    @staticmethod
    def backward(ctx, g):
        grads, ctx.grads = ctx.grads, None
        return (None,) * 6 + tuple(grads[n] * g for n in ctx.names)


def bce_sum(tw: TrainWeights, model: ConvAutoencoder, x, y, mask,
            pre: bool = False) -> torch.Tensor:
    """The masked BCE sum as a differentiable scalar of ``model``'s
    parameters, whose kernel weights ``tw`` are: ``.backward()`` writes the
    ``.grad``s from the backward stage kernels."""
    x, y, mask = _inputs(tw, x, y, mask, pre)
    names, params = zip(*model.named_parameters())
    return _KernelBCE.apply(x, y, mask, tw, pre, names, *params)


def kernel_bce_sum(model: ConvAutoencoder, x, y, mask, dtype=torch.bfloat16,
                   pre: bool = False) -> torch.Tensor:
    """The masked BCE sum as a differentiable scalar: ``.backward()`` writes
    the module's ``.grad``s from the backward stage kernels."""
    return bce_sum(build_train_weights(model, dtype), model, x, y, mask, pre)


def normalise(sums):
    """(bce_sum, mask_sum, grad_sums) -> (mean masked BCE, gradients): the
    sums over mask_sum * 256 * 128."""
    bce, msum, grads = sums
    denom = msum * float(TILE_F * TILE_T)
    return bce / denom, {k: g / denom for k, g in grads.items()}


def kernel_value_and_grad(model: ConvAutoencoder, x, y, mask,
                          dtype=torch.bfloat16, pre: bool = False):
    """(mean masked BCE, gradients keyed like ``named_parameters``) from
    the stage kernels: the sums over mask_sum * 256 * 128."""
    return normalise(kernel_loss_grad_sums(model, x, y, mask, dtype, pre))


def masked_bce_from_logits(logits: torch.Tensor, y: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Mean BCE over the real tiles of (B, 256, 128) float32 logits."""
    per = logits.clamp_min(0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    w = mask.float()[:, None, None]
    return (per * w).sum() / (w.sum() * per[0].numel())


def make_kernel_train_step(cfg: ModelConfig, dtype=torch.bfloat16,
                           pre: bool = False, depth: int | None = None):
    """``step(state, x, y, mask) -> (state, loss)``: the stage kernels'
    forward and backward, then the state's optimizer (Adam); the drop-in
    for ``train.train_step`` on the geometries ``kernel_depth`` accepts (of
    ``depth``, if given).  Spans: ``train.step`` keyed by ``state.step``,
    and in it ``step.weights``, ``step.loss`` (forward and backward) and
    ``step.adam`` (``optimizer.step``)."""
    depth = kernel_depth(cfg, depth)
    _check_pre(depth, pre)

    def step(state, x, y, mask):
        with span("train.step", key=state.step):
            state.optimizer.zero_grad(set_to_none=True)
            with span("step.weights"):
                tw = build_train_weights(state.model, dtype, depth)
            with span("step.loss"):
                loss = (bce_sum(tw, state.model, x, y, mask, pre)
                        / (mask.sum() * float(TILE_F * TILE_T)))
                loss.backward()
            with span("step.adam"):
                state.optimizer.step()
            state.step += 1
        return state, loss.detach()

    return step


def kernel_train_epoch_fn(cfg: ModelConfig, dtype=torch.bfloat16,
                          pre_layout: bool = False, depth: int | None = None):
    """``epoch(state, x, y, batch_idx, batch_mask) -> (state, losses)`` on
    the stage kernels, the ``train.train_epoch`` equivalent.  Each batch
    gathers its tiles by index.  ``pre_layout=True`` (K5b) casts the whole
    of x and y to the kernel dtype once per call and gathers from that."""
    step = make_kernel_train_step(cfg, dtype, pre=pre_layout, depth=depth)

    def epoch(state, x, y, batch_idx, batch_mask):
        x, y = _tiles(x), _tiles(y)
        if pre_layout:
            x, y = x.to(dtype), y.to(dtype)
        losses = []
        for idx, m in zip(batch_idx, batch_mask):
            state, loss = step(state, x[idx], y[idx], m)
            losses.append(loss)
        return state, torch.stack(losses)

    return epoch
