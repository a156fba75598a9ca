"""The collectives of the sharded paths (JAX's ``pmin``/``pmax``/``psum``,
the ``ppermute`` halos of ``specenh/parallel/timeshard.py:68-81`` and the
gathers a ``shard_map``'s out_specs imply).

An ``Exchange`` is one rank's side of them over a 1-D mesh: its rank, the
mesh's size and device, and four primitives (``reduce``, ``all_gather``,
``gather`` into rank 0, ``broadcast`` from rank 0), on which the halos
(``recv_right``, ``recv_left``) and the gathers of uneven blocks are
built.  The per-shard bodies (``parallel.timeshard``, the channel-sharded
service of ``bench.harness``) call nothing else, so every rank meets the
same collectives in the same order.

``GroupExchange`` runs them over a ``parallel.mesh.Mesh``'s process
group: NCCL moves the card's tensors itself; gloo's traffic is staged
through host tensors (gloo takes CUDA tensors for only some collectives),
as ``data_parallel._ctl_device`` stages it.  Blocks of a dimension follow
``numpy.array_split``: the first ``n % size`` ranks hold one more.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["Exchange", "GroupExchange", "exchange_for", "block_sizes", "block_of",
           "gather_blocks"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class Exchange:
    """One rank's side of the collectives over a 1-D mesh of ``size``
    ranks; ``shape`` reads as a mesh's (``{"time": 8}``).  Subclasses
    give the four primitives."""

    rank: int
    size: int
    device: torch.device
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """The element-wise ``op`` ("sum", "max" or "min") of every
        rank's ``x``, a new tensor on ``x``'s device."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (one shape on every rank), in rank order."""
        raise NotImplementedError

    def gather(self, x: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's ``x`` (one shape on every rank) in rank order on
        rank 0; None on the others."""
        raise NotImplementedError

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (the others pass a tensor of its
        shape and dtype)."""
        raise NotImplementedError

    def recv_right(self, x: torch.Tensor, cols: int) -> torch.Tensor:
        """The first ``cols`` columns (last axis) of the right neighbour's
        ``x``; zeros on the last rank, as a ``ppermute`` with no source."""
        parts = self.all_gather(x[..., :cols].contiguous())
        if self.rank + 1 < self.size:
            return parts[self.rank + 1]
        return torch.zeros_like(parts[self.rank])

    def recv_left(self, x: torch.Tensor, cols: int) -> torch.Tensor:
        """The last ``cols`` columns of the left neighbour's ``x``; zeros
        on rank 0."""
        parts = self.all_gather(x[..., x.shape[-1] - cols:].contiguous())
        if self.rank > 0:
            return parts[self.rank - 1]
        return torch.zeros_like(parts[0])


class GroupExchange(Exchange):
    """The collectives over a ``parallel.mesh.Mesh``'s process group."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.rank, self.size = mesh.rank, mesh.size
        self.device, self.axis_names = mesh.device, tuple(mesh.axis_names)
        # where the collectives' tensors live: NCCL takes device tensors, gloo host ones
        self._wire = mesh.device if mesh.backend == "nccl" else torch.device("cpu")

    def _on_wire(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``x`` on the wire device, which the
        collective may write."""
        if x.device == self._wire:
            return x.detach().clone(memory_format=torch.contiguous_format)
        return x.detach().to(self._wire).contiguous()

    def reduce(self, x, op):
        t = self._on_wire(x)
        dist.all_reduce(t, op=_OPS[op], group=self.mesh.group)
        return t.to(x.device)

    def all_gather(self, x):
        t = self._on_wire(x)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.mesh.group)
        return [o.to(x.device) for o in out]

    def gather(self, x):
        t = self._on_wire(x)
        out = [torch.empty_like(t) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(t, out, dst=0, group=self.mesh.group)
        return None if out is None else [o.to(x.device) for o in out]

    def broadcast(self, x):
        t = self._on_wire(x)
        dist.broadcast(t, src=0, group=self.mesh.group)
        return t.to(x.device)


def exchange_for(mesh) -> Exchange:
    """``mesh`` itself where it is an ``Exchange``, else a
    ``GroupExchange`` over the ``parallel.mesh.Mesh``."""
    from specenh_torch.parallel.mesh import Mesh

    if isinstance(mesh, Exchange):
        return mesh
    if isinstance(mesh, Mesh):
        return GroupExchange(mesh)
    raise TypeError(f"mesh must be a parallel.mesh.Mesh or an Exchange, not {type(mesh)!r}")


def block_sizes(n: int, size: int) -> tuple:
    """The sizes of ``size`` blocks of ``n`` (``numpy.array_split``)."""
    q, r = divmod(n, size)
    return tuple(q + (i < r) for i in range(size))


def block_of(ex: Exchange, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view)."""
    sizes = block_sizes(x.shape[dim], ex.size)
    return x.narrow(dim, sum(sizes[: ex.rank]), sizes[ex.rank])


def gather_blocks(ex: Exchange, x: torch.Tensor, dim: int = -1,
                  n: Optional[int] = None) -> Optional[torch.Tensor]:
    """The ranks' blocks of a dimension of ``n`` (None: ``size`` equal
    blocks of ``x``'s) concatenated along ``dim`` on rank 0; None on the
    others.  Uneven blocks travel padded to the largest and are trimmed."""
    dim = dim % x.ndim
    sizes = block_sizes(x.shape[dim] * ex.size if n is None else n, ex.size)
    if x.shape[dim] != sizes[ex.rank]:
        raise ValueError(f"rank {ex.rank}'s block has {x.shape[dim]} along dim {dim}, "
                         f"expected {sizes[ex.rank]} of {sum(sizes)}")
    pad = max(sizes) - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    parts = ex.gather(x.contiguous())
    if parts is None:
        return None
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)
