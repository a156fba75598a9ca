"""A lock-step exchange of n threads in one process, for the CPU tests: the
port's sharded bodies run as n shards (JAX's n-device CPU mesh's
counterpart) without starting n processes.  A test tool: nothing in
``specenh_torch`` imports it.

``run_shards(n, body)`` calls ``body(ex)`` on n threads, ``ex`` the
thread's ``ThreadExchange`` (rank, size, the CPU), and returns the n
results in rank order; the first exception raised on any thread is
raised here (the others' collectives are broken off, not left waiting).
A reduction folds the ranks' tensors in rank order.
"""

import functools
import threading

import torch

from specenh_torch.parallel.collectives import Exchange

TIMEOUT = 120  # seconds a collective may wait for the other threads

_FOLD = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


class _Hub:
    def __init__(self, n: int):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=TIMEOUT)


class ThreadExchange(Exchange):
    """One thread's side of a lock-step exchange over a 1-D mesh."""

    def __init__(self, hub: _Hub, rank: int, axis_names=("time",)):
        self.hub, self.rank, self.size = hub, rank, len(hub.slots)
        self.device, self.axis_names = torch.device("cpu"), tuple(axis_names)

    def _swap(self, x):
        """Every rank's ``x``, in rank order."""
        self.hub.slots[self.rank] = x
        self.hub.barrier.wait()
        got = list(self.hub.slots)
        self.hub.barrier.wait()
        return got

    def reduce(self, x, op):
        return functools.reduce(_FOLD[op], self._swap(x.detach().clone()))

    def all_gather(self, x):
        return [t.clone() for t in self._swap(x.detach().clone())]

    def gather(self, x):
        got = self._swap(x.detach().clone())
        return got if self.rank == 0 else None

    def broadcast(self, x):
        return self._swap(x.detach().clone())[0].clone()


def run_shards(n: int, body, axis_names=("time",)) -> list:
    """``body(ex)`` on n lock-step threads; their results in rank order."""
    hub = _Hub(n)
    out, errors = [None] * n, []

    def run(rank):
        try:
            out[rank] = body(ThreadExchange(hub, rank, axis_names))
        except BaseException as e:  # recorded and raised in the caller
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT * 4)
    assert not any(t.is_alive() for t in threads), "a shard thread did not finish"
    real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
    if errors:
        raise (real or errors)[0]
    return out
