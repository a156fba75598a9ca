"""Data-parallel training on the CUDA training kernels (the counterpart of
``specenh.parallel.dp_kernel``).

Every rank runs the stage kernels (``ops.ae_train_kernel``: K5 at depth 2,
K7 at depth 3) on its block of each global batch.  A step packs the three
UNNORMALISED sums they emit — the BCE sum, the mask sum and every
parameter's gradient sum — into one flat float32 buffer and makes one
``all_reduce`` of it (about 28k floats for the flagship); then it divides
by the GLOBAL mask sum, so a rank whose block is all padding contributes
zeros and the step stays finite (a per-rank mean would be 0/0 there).
The gradients are scaled as the single-card step scales them, by
autograd's incoming gradient ``1 / denom`` (``ops.ae_train_kernel``'s
``_KernelBCE``), so a world of one is ``fit`` with ``kernel_epoch_for``
bit for bit.  On the CPU the stage wrappers run their plain twins.  There
is no fallback: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from specenh_torch.config import ModelConfig, TrainConfig
from specenh_torch.ops import ae_train_kernel as TK
from specenh_torch.ops.ae_kernel import kernel_depth
from specenh_torch.parallel.mesh import Mesh

__all__ = ["dp_kernel_epoch_for"]


def dp_kernel_epoch_for(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh,
                        dtype=None):
    """Epoch function on the training kernels for ``dp_fit(...,
    epoch_fn=...)``: the contract of ``make_dp_epoch_programs``' train
    epoch (this rank's blocks in, the global batches' losses out), one
    ``all_reduce`` a step.  ``dtype`` is the kernels' (bf16 by default);
    the optimizer is the state's.  A geometry no kernel covers raises."""
    dtype = torch.bfloat16 if dtype is None else dtype
    depth = kernel_depth(model_cfg)
    denom_scale = float(TK.TILE_F * TK.TILE_T)

    def step(state, x, y, mask):
        state.optimizer.zero_grad(set_to_none=True)
        tw = TK.build_train_weights(state.model, dtype, depth)
        bce, msum, grads = TK.loss_grad_sums(tw, x, y, mask)
        named = list(state.model.named_parameters())
        flat = torch.cat([bce.reshape(1), msum.reshape(1),
                          *(grads[name].reshape(-1) for name, _ in named)])
        dist.all_reduce(flat, group=mesh.group)
        denom = flat[1] * denom_scale
        g = torch.ones_like(denom) / denom
        off = 2
        for _, p in named:
            p.grad = flat[off : off + p.numel()].view_as(p) * g
            off += p.numel()
        state.optimizer.step()
        state.step += 1
        return state, flat[0] / denom

    def epoch(state, x, y, batch_idx, batch_mask):
        x, y = TK._tiles(x), TK._tiles(y)
        losses = []
        for idx, m in zip(batch_idx, batch_mask):
            state, loss = step(state, x[idx], y[idx], m)
            losses.append(loss)
        return state, torch.stack(losses)

    return epoch
