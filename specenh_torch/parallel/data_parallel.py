"""Data-parallel training over a process-group mesh (the counterpart of
``specenh.parallel.data_parallel``).

The JAX package runs one SPMD program whose partitioner inserts the
gradient ``psum``.  Here every rank runs the autograd engine (float32, or
bf16 activations with ``create_state(dtype=torch.bfloat16)``) on its
contiguous block of each global batch, as ``P("data")`` places it, and one
``all_reduce`` a step sums the loss and the gradients.  The mask sums of an
epoch's global batches are all-reduced once an epoch, before its first
step, so every rank divides by the GLOBAL mask sum inside its graph: a
block of padding alone gives a zero, finite contribution, and a world of
one is ``train.fit`` bit for bit.

Every rank draws the same ``default_rng(seed)`` permutation from its own
copy of the data (``dp_fit`` checks the plan agrees, once; no data is
broadcast).  ``dataset_sharding`` is placement only: "data" puts on a
rank's device the rows its blocks read in an epoch (its val rows once),
"replicated" every row; the results do not depend on it.  Rank 0 writes
the metrics, checkpoints, ``run_meta.json`` and ``history.json``.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from specenh_torch.parallel.mesh import Mesh
from specenh_torch.train import (TrainState, _epoch_batches, _save_checkpoint, check_run_meta,
                                 latest_checkpoint_epoch, restore_checkpoint, weighted_epoch_mean,
                                 write_run_meta)

__all__ = [
    "shard_batch",
    "make_dp_train_step",
    "make_dp_eval_step",
    "make_dp_epoch_programs",
    "dp_fit",
    "barrier",
]


def _block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of a leading dimension of ``n``."""
    if n % mesh.size:
        raise ValueError(f"a leading dimension of {n} does not split over {mesh.size} ranks")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's contiguous block of each array's leading dimension, on
    its device.  The leading dim must already be a multiple of the mesh
    size — ``dp_fit`` pads its batches (with zero masks) first."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        out.append(t[_block(mesh, t.shape[0])].to(mesh.device))
    return tuple(out)


def _ctl_device(mesh: Mesh) -> torch.device:
    """Where a collective's small control tensors live: NCCL reduces only
    device tensors, gloo any."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def _bce_sum(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """(masked BCE sum, elements a tile), as ``train.bce_from_logits``
    computes its numerator."""
    per = logits.clamp_min(0) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    w = mask.reshape((-1,) + (1,) * (per.ndim - 1)).to(per.dtype)
    return (per * w).sum(), per[0].numel()


def _mask_sums(mesh: Mesh, batch_mask: torch.Tensor) -> torch.Tensor:
    """The global mask sum of each batch (one ``all_reduce``)."""
    s = batch_mask.to(torch.float32).sum(dim=-1).reshape(-1).contiguous()
    dist.all_reduce(s, group=mesh.group)
    return s


def _pack(*ts: torch.Tensor) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in ts])


def _grad_step(state: TrainState, mesh: Mesh, x, y, mask, msum):
    """One autograd step on this rank's block, ``msum`` the global mask sum
    of the batch; the loss and the gradients in one ``all_reduce``."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    s, per_tile = _bce_sum(state.model(x, logits=True), y, mask)
    loss = s / (msum * per_tile)
    loss.backward()
    params = list(state.model.parameters())
    flat = _pack(loss.detach(), *(p.grad for p in params))
    dist.all_reduce(flat, group=mesh.group)
    off = 1
    for p in params:
        p.grad = flat[off : off + p.numel()].view_as(p)
        off += p.numel()
    state.optimizer.step()
    state.step += 1
    return state, flat[0]


def make_dp_train_step(mesh: Mesh):
    """``step(state, x, y, mask) -> (state, loss)`` on this rank's block of
    the global batch (``shard_batch``): the mask sum and then the loss and
    gradients all-reduced, so the update equals the single-device step on
    the unsharded batch up to the order of the sums."""

    def step(state: TrainState, x, y, mask):
        return _grad_step(state, mesh, x, y, mask, _mask_sums(mesh, mask)[0])

    return step


@torch.no_grad()
def _eval_sums(state: TrainState, x, y, batch_idx, batch_mask) -> torch.Tensor:
    state.model.eval()
    rows = []
    for idx, m in zip(batch_idx, batch_mask):
        s, per_tile = _bce_sum(state.model(x[idx], logits=True), y[idx], m)
        rows.append(torch.stack([s, m.to(torch.float32).sum(), s.new_tensor(per_tile)]))
    return torch.stack(rows)


def _eval_losses(mesh: Mesh, sums: torch.Tensor) -> torch.Tensor:
    """Each batch's global mean BCE from the ranks' (sum, mask sum, tile
    size) rows, in one ``all_reduce``."""
    per_tile = sums[:, 2].clone()
    t = sums[:, :2].contiguous()
    dist.all_reduce(t, group=mesh.group)
    return t[:, 0] / (t[:, 1] * per_tile)


def make_dp_eval_step(mesh: Mesh):
    """``step(state, x, y, mask) -> loss``: the global masked mean BCE of a
    batch from this rank's block."""

    def step(state: TrainState, x, y, mask):
        idx = torch.arange(x.shape[0], device=x.device)
        return _eval_losses(mesh, _eval_sums(state, x, y, idx[None], mask[None]))[0]

    return step


def make_dp_epoch_programs(mesh: Mesh):
    """``(train_epoch, eval_epoch)`` with ``train.train_epoch``'s and
    ``eval_epoch``'s call contract on this rank's share: ``batch_idx`` and
    ``batch_mask`` (n_batches, bs / size) are its blocks of the epoch's
    global batches, indexing its rows ``x`` and ``y``.  The losses returned
    are the global batches'.  A train epoch makes one ``all_reduce`` of the
    mask sums and then one a step; an eval epoch one."""

    def train_epoch(state: TrainState, x, y, batch_idx, batch_mask):
        msums = _mask_sums(mesh, batch_mask)
        losses = []
        for b, (idx, m) in enumerate(zip(batch_idx, batch_mask)):
            state, loss = _grad_step(state, mesh, x[idx], y[idx], m, msums[b])
            losses.append(loss)
        return state, torch.stack(losses)

    def eval_epoch(state: TrainState, x, y, batch_idx, batch_mask):
        return _eval_losses(mesh, _eval_sums(state, x, y, batch_idx, batch_mask))

    return train_epoch, eval_epoch


def _tiles_on(a, rows: Optional[np.ndarray], device) -> torch.Tensor:
    """Rows ``rows`` (all if None) of tiles ``a`` (numpy or a tensor on any
    device) as contiguous float32 (B, H, W) on ``device``."""
    if rows is not None:
        a = a[rows] if isinstance(a, np.ndarray) else a[torch.from_numpy(rows).to(a.device)]
    t = torch.as_tensor(a, dtype=torch.float32, device=device)
    return (t[..., 0] if t.ndim == 4 else t).contiguous()


def _local_rows(batch_idx: np.ndarray, batch_mask: np.ndarray):
    """The rows a rank's blocks read (sorted) and the blocks' indices into
    them; padded slots read local row 0."""
    rows = np.unique(batch_idx[batch_mask > 0])
    local = np.where(batch_mask > 0, np.searchsorted(rows, batch_idx), 0)
    if rows.size == 0:  # every block padding: one row to point at
        rows = np.zeros(1, np.int64)
    return rows, local.astype(np.int64)


def _agree(mesh: Mesh, names: str, *values: int) -> None:
    """Every rank holds the same ``values`` (one ``all_reduce``; read on
    the host, so every rank has reached it)."""
    v = torch.tensor(values, dtype=torch.int64, device=_ctl_device(mesh))
    both = torch.cat([v, -v])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    hi, neg_lo = both.reshape(2, -1).tolist()
    if hi != [-x for x in neg_lo]:
        raise RuntimeError(
            f"the ranks disagree (max {hi}, min {[-x for x in neg_lo]} of {names}): "
            "each rank must hold the same dataset, seed and checkpoint directory")


def barrier(mesh: Mesh) -> None:
    """Return once every rank has reached it (one ``all_reduce``, read on
    the host)."""
    t = torch.zeros(1, device=_ctl_device(mesh))
    dist.all_reduce(t, group=mesh.group)
    t.item()


@torch.no_grad()
def _broadcast_params(mesh: Mesh, model: torch.nn.Module) -> None:
    """Rank 0's parameters on every rank (one ``broadcast``)."""
    params = list(model.parameters())
    flat = _pack(*params)
    dist.broadcast(flat, src=0, group=mesh.group)
    off = 0
    for p in params:
        p.copy_(flat[off : off + p.numel()].view_as(p))
        off += p.numel()


def dp_fit(
    state: TrainState,
    x_train,
    y_train,
    mesh: Mesh,
    x_val=None,
    y_val=None,
    epochs: int = 15,
    batch_size: int = 128,
    seed: int = 0,
    shuffle: bool = True,
    dataset_sharding: str = "data",
    metrics_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    epoch_fn=None,
    patience: Optional[int] = None,
    verbose: bool = False,
) -> Tuple[TrainState, dict]:
    """Multi-process Keras-fit equivalent, with ``train.fit``'s history,
    checkpoints, resume and early stopping.  ``batch_size`` is GLOBAL: at
    least the mesh size, rounded up to a multiple of it, capped at the
    dataset padded to one (padded rows masked); each rank trains its
    contiguous block of every batch.  ``epoch_fn`` swaps the engine (the
    contract of ``make_dp_epoch_programs``' train epoch), e.g.
    ``dp_kernel.dp_kernel_epoch_for(...)``.  ``state`` lives on the rank's
    device and starts from rank 0's parameters (broadcast once).

    ``dataset_sharding`` places data only: "data" holds on a rank's device
    the rows its blocks read in an epoch, at most ``ceil(n / bs)`` blocks
    of ``bs / size`` rows (``ceil(n / size)`` when ``bs`` divides ``n``);
    "replicated" every row.  The results do not depend on it."""
    if dataset_sharding not in ("data", "replicated"):
        raise ValueError(f"dataset_sharding must be 'data' or 'replicated', got {dataset_sharding!r}")
    if state.device != mesh.device:
        raise ValueError(f"the state is on {state.device}, this rank's device is {mesh.device}")
    dev, n_dev, lead = mesh.device, mesh.size, mesh.rank == 0
    bs = max(batch_size, n_dev)
    bs += (-bs) % n_dev
    n = len(x_train)
    bs = min(bs, n + (-n) % n_dev)
    mine = _block(mesh, bs)
    sharded = dataset_sharding == "data"
    rng = np.random.default_rng(seed)
    history = {"loss": [], "val_loss": []}
    if checkpoint_dir:
        checkpoint_dir = os.path.abspath(checkpoint_dir)
    run_meta = {"n": int(n), "seed": int(seed), "batch_size": int(bs),
                "shuffle": bool(shuffle), "devices": int(n_dev)}

    # every read of the checkpoint directory happens before the agreement
    # below, every write (rank 0's) after it
    start_epoch = 0
    last = latest_checkpoint_epoch(checkpoint_dir) if resume and checkpoint_dir else None
    if last is not None:
        check_run_meta(checkpoint_dir, run_meta, optional_keys=("devices",))
        state = restore_checkpoint(state, checkpoint_dir, last)
        start_epoch = last + 1
        for _ in range(start_epoch):  # replay the shuffle stream
            if shuffle:
                rng.permutation(n)
        hpath = os.path.join(checkpoint_dir, "history.json")
        if os.path.exists(hpath):
            with open(hpath) as fh:
                saved_hist = json.load(fh)
            history["loss"] = list(saved_hist.get("loss", []))[:start_epoch]
            history["val_loss"] = list(saved_hist.get("val_loss", []))[:start_epoch]
        if verbose and lead:
            print(f"resumed from epoch {last}")
    first = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    _agree(mesh, "[first permutation's crc32, n, batch size, seed, last checkpoint]",
           zlib.crc32(first.astype(np.int64).tobytes()), n, bs, seed,
           -1 if last is None else last)
    _broadcast_params(mesh, state.model)
    if checkpoint_dir and lead:
        write_run_meta(checkpoint_dir, run_meta)
    writer = open(metrics_path, "a") if metrics_path and lead else None

    dp_train, eval_epoch = make_dp_epoch_programs(mesh)
    train_epoch = epoch_fn if epoch_fn is not None else dp_train
    if not sharded:
        x_train, y_train = _tiles_on(x_train, None, dev), _tiles_on(y_train, None, dev)
    have_val = x_val is not None and len(x_val)
    if have_val:
        n_val = len(x_val)
        vi, vm = _epoch_batches(n_val, min(bs, n_val + (-n_val) % n_dev), np.arange(n_val))
        vi_mine, vm_mine = vi[:, _block(mesh, vi.shape[1])], vm[:, _block(mesh, vm.shape[1])]
        rows = None
        if sharded:
            rows, vi_mine = _local_rows(vi_mine, vm_mine)
        xv, yv = _tiles_on(x_val, rows, dev), _tiles_on(y_val, rows, dev)
        vi_t, vm_t = torch.from_numpy(vi_mine).to(dev), torch.from_numpy(vm_mine).to(dev)

    # opt-in early stopping (see train.fit), seeded from a restored history;
    # val_loss is all-reduced, so every rank decides the same
    best_val = min(history["val_loss"], default=np.inf)
    stale = 0
    if patience is not None and history["val_loss"]:
        stale = len(history["val_loss"]) - 1 - int(np.argmin(history["val_loss"]))
        if stale >= patience:
            history["stopped_epoch"] = start_epoch - 1
            start_epoch = epochs

    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        perm = rng.permutation(n) if shuffle else np.arange(n)
        batch_idx, batch_mask = _epoch_batches(n, bs, perm)
        bi, bm = batch_idx[:, mine], batch_mask[:, mine]
        xs, ys = x_train, y_train
        if sharded:
            rows, bi = _local_rows(bi, bm)
            xs, ys = _tiles_on(x_train, rows, dev), _tiles_on(y_train, rows, dev)
        state, losses = train_epoch(state, xs, ys, torch.from_numpy(bi).to(dev),
                                    torch.from_numpy(bm).to(dev))
        del xs, ys
        history["loss"].append(float(weighted_epoch_mean(losses, batch_mask)))
        if have_val:
            v_losses = eval_epoch(state, xv, yv, vi_t, vm_t)
            history["val_loss"].append(float(weighted_epoch_mean(v_losses, vm)))
        dt = time.perf_counter() - t0
        if verbose and lead:
            print(f"epoch {epoch+1}/{epochs} loss={history['loss'][-1]:.5f}"
                  + (f" val={history['val_loss'][-1]:.5f}" if history["val_loss"] else ""))
        if writer:
            writer.write(json.dumps({
                "epoch": epoch,
                "loss": history["loss"][-1],
                "val_loss": history["val_loss"][-1] if history["val_loss"] else None,
                "sec": dt,
                "devices": int(n_dev),
            }) + "\n")
            writer.flush()
        if checkpoint_dir and lead:
            _save_checkpoint(state, checkpoint_dir, epoch)
            with open(os.path.join(checkpoint_dir, "history.json"), "w") as fh:
                json.dump(history, fh)
        if patience is not None and history["val_loss"]:
            val = history["val_loss"][-1]
            if val < best_val:
                best_val, stale = val, 0
            else:
                stale += 1
            if stale >= patience:
                history["stopped_epoch"] = epoch
                if checkpoint_dir and lead:
                    with open(os.path.join(checkpoint_dir, "history.json"), "w") as fh:
                        json.dump(history, fh)
                if verbose and lead:
                    print(f"early stopping: val_loss stale for "
                          f"{patience} epochs (best {best_val:.5f})")
                break
    if writer:
        writer.close()
    # no rank returns before rank 0's files are written
    _agree(mesh, "[epochs in the history, stopped epoch]", len(history["loss"]),
           history.get("stopped_epoch", -1))
    history["new_epochs"] = max(0, epochs - start_epoch)
    return state, history
