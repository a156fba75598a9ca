"""Multi-process campaign scaling (the counterpart of
``specenh.parallel.multihost``).

* ``initialize_distributed`` — the ``torch.distributed`` process group:
  from explicit arguments over ``tcp://``, or from the launcher's
  environment (``torchrun``'s ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
  ``MASTER_PORT``, or SLURM's ``SLURM_PROCID``/``SLURM_NTASKS`` with
  ``MASTER_ADDR`` or ``SLURM_LAUNCH_NODE_IPADDR``); after it,
  ``mesh.make_mesh`` spans every process;
* ``host_shard`` — the deterministic strided partition of a shot list
  across processes (the SLURM-array analog, hyperparam_scan.py:122);
* ``merge_stores`` — fold per-host HDF5 stores into one file (h5py is
  imported inside the call).

A single process with no cluster named is standalone: (0, 1).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch.distributed as dist

__all__ = ["initialize_distributed", "host_shard", "merge_stores"]


def _int_env(k: str) -> int:
    try:
        return int(os.environ.get(k) or 1)
    except ValueError:
        return 1


def _cluster_named() -> bool:
    """The environment names more than one process or node (JAX's list,
    specenh/parallel/multihost.py:70-80, and torchrun's ``WORLD_SIZE``)."""
    n_tpu_workers = len([h for h in os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",") if h])
    return any(os.environ.get(k) for k in (
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS",
    )) or n_tpu_workers > 1 or _int_env("SLURM_JOB_NUM_NODES") > 1 \
        or _int_env("OMPI_COMM_WORLD_SIZE") > 1 or _int_env("WORLD_SIZE") > 1


def _launcher_env():
    """(rank, world size, address, port) from torchrun's or SLURM's
    environment, or None where neither names a group of more than one."""
    if _int_env("WORLD_SIZE") > 1 and "RANK" in os.environ:
        return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT", "29500"))
    if _int_env("SLURM_NTASKS") > 1 and "SLURM_PROCID" in os.environ:
        addr = os.environ.get("MASTER_ADDR") or os.environ.get("SLURM_LAUNCH_NODE_IPADDR")
        return (int(os.environ["SLURM_PROCID"]), int(os.environ["SLURM_NTASKS"]), addr,
                os.environ.get("MASTER_PORT", "29500"))
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    timeout: Optional[float] = None,
) -> tuple:
    """Join the process group.  With arguments, over
    ``tcp://coordinator_address``; with none, from the launcher's
    environment.  Returns (process_id, num_processes); (0, 1) on a single
    host with no cluster named.  ``backend`` is NCCL (one GPU a process) or
    gloo (the CPU); ``timeout`` in seconds bounds every collective.

    As in the JAX package, an environment that names a cluster while the
    process comes up 1 of 1 raises: a silent fallback would run the
    campaign once per host."""
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address or num_processes:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id), **kw)
    else:
        env = _launcher_env()
        named = _cluster_named()
        if env is not None:
            rank, world, addr, port = env
            if not addr:
                raise RuntimeError(
                    "the launcher's environment names a process group but no "
                    "coordinator address (set MASTER_ADDR), or pass "
                    "coordinator_address/num_processes/process_id explicitly")
            dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                    world_size=world, rank=rank, **kw)
        elif named:
            raise RuntimeError(
                "cluster environment names multiple nodes but the process "
                "came up single-process; pass coordinator_address/"
                "num_processes/process_id explicitly (a silent fallback "
                "would run the campaign once per host)")
        else:
            return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_shard(
    items: Sequence, process_id: Optional[int] = None, num_processes: Optional[int] = None
) -> List:
    """Deterministic strided partition of a work list across processes —
    the SLURM-array analog (hyperparam_scan.py:122) minus the scheduler."""
    up = dist.is_initialized()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    n = (dist.get_world_size() if up else 1) if num_processes is None else num_processes
    return list(items)[pid::n]


def merge_stores(out_path: str, part_paths: Sequence[str]) -> int:
    """Fold per-host HDF5 stores into one (idempotent; returns channels
    copied).  Uses h5py low-level copy so axis/label datasets stay exact."""
    import h5py

    n = 0
    with h5py.File(out_path, "a") as out:
        for part in part_paths:
            with h5py.File(part, "r") as src:
                for shot in src:
                    for chn in src[shot]:
                        name = f"{shot}/{chn}"
                        if name in out:
                            del out[name]
                        src.copy(name, out, name=name)
                        n += 1
    return n
