"""The process-group mesh (the counterpart of ``specenh.parallel.mesh``).

JAX's ``Mesh`` is one controller over many devices.  torch's idiom is one
process per GPU in one ``torch.distributed`` process group: a ``Mesh`` here
is that group seen from one rank, with this rank's device.  A mesh has one
axis, named by its use: ``data`` (data-parallel training,
``parallel.data_parallel``; the channel-sharded service,
``bench.harness.make_enhance_shot_fn(mesh=)``), ``time`` (the long-shot
path, ``parallel.timeshard``) or ``sweep`` (the envelope sweep's config
axis, ``sweep.sweep_fit(mesh=)``).  ``parallel.collectives.GroupExchange``
runs the sharded paths' collectives over it.  ``local_size`` and
``local_rank`` place a rank on its host (launcher's ``LOCAL_WORLD_SIZE``
and ``LOCAL_RANK``), for what a host's ranks share: its RAM and its
disk.

A process group that is already initialized (``torchrun``,
``multihost.initialize_distributed``; NCCL for one GPU a rank, or gloo,
which also lets two ranks share one card) is the mesh; otherwise
``make_mesh`` makes a world of one, the only mesh a single process can
hold.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "check_visible", "default_backend", "local_size",
           "local_rank"]


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_visible(n_devices: int, device="cuda") -> None:
    """Raise JAX's message when more GPUs are asked for than are visible
    (specenh/parallel/mesh.py:33-38)."""
    if torch.device(device).type != "cuda":
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise ValueError(f"requested {n_devices} devices but only {have} available")


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D process-group mesh: the group, this rank,
    the group's size, the axis names and this rank's device.  ``shape``
    reads as JAX's (``mesh.shape["data"]``)."""

    group: object
    rank: int
    size: int
    axis_names: Tuple[str, ...]
    device: torch.device
    backend: str
    owns_group: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}

    def close(self) -> None:
        """Destroy the process group if ``make_mesh`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _rank_device(device, rank: int) -> torch.device:
    """The rank's device, made the current CUDA device (the kernels launch
    on the current device's stream)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              device="cuda") -> Mesh:
    """A 1-D mesh over the current process group, or, when none is
    initialized, over a new world of one (``n_devices`` None or 1; NCCL on
    ``cuda``, gloo on ``cpu``).  ``device`` is the rank's device
    (``cuda``: ``cuda:LOCAL_RANK``).  More GPUs than are visible raise
    JAX's message."""
    axis_names = tuple(axis_names)
    if len(axis_names) != 1:
        raise NotImplementedError(
            f"a mesh has one axis ('data', 'time' or 'sweep'), not {axis_names}: "
            "multi-axis meshes are not ported (no command builds one)")
    if dist.is_initialized():
        size = dist.get_world_size()
        if n_devices is not None and n_devices != size:
            if n_devices > size:
                raise ValueError(f"requested {n_devices} devices but only {size} available")
            raise ValueError(f"a mesh spans the whole process group ({size} ranks), "
                             f"not {n_devices}")
        rank = dist.get_rank()
        return Mesh(dist.group.WORLD, rank, size, axis_names, _rank_device(device, rank),
                    dist.get_backend())
    n = 1 if n_devices is None else int(n_devices)
    check_visible(n, device)
    if n != 1:
        raise ValueError(
            f"a mesh of {n} devices is {n} processes: start them with torchrun "
            f"--nproc-per-node {n} (or the CLI's --devices {n}) and call "
            "multihost.initialize_distributed first")
    backend = default_backend(device)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return Mesh(dist.group.WORLD, 0, 1, axis_names, _rank_device(device, 0), backend,
                owns_group=True)


def local_size(mesh: Mesh) -> int:
    """The ranks of ``mesh`` on this rank's host: the launcher's
    ``LOCAL_WORLD_SIZE`` (torchrun's, the CLI's), else the whole mesh."""
    return int(os.environ.get("LOCAL_WORLD_SIZE") or mesh.size)


def local_rank(mesh: Mesh) -> int:
    """This rank's index on its host: the launcher's ``LOCAL_RANK``, else
    its rank."""
    return int(os.environ.get("LOCAL_RANK") or mesh.rank)
