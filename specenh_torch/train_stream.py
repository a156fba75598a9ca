"""Host-streamed training (the counterpart of ``specenh.train_stream``):
reference recipes whose tile tensors do not fit the device's resident
budget.

The reference's largest recipe trains on 200 shots (VAE/manual_scan.py:
137-156): 120 000 tiles, ~15.7 GB per float32 tile tensor, ~31 GB for
(x, y).  ``train.fit`` uploads both tensors whole; ``fit_streaming``
streams the epoch instead:

* the store stays where it is; the split plan (``plan_stream_split``) is
  computed from its METADATA, without reading a tile;
* each epoch streams fixed-size chunks of tiles through the device, and
  every chunk runs the caller's epoch engine (``train.train_epoch`` or
  the kernels' ``kernel_epoch_for``) over its batches.

Shuffle semantics are the JAX package's.  A global tile permutation needs
full residency, so the stream shuffles hierarchically: with the host-RAM
chunk cache on (``cache='auto'|'always'``) chunk composition is canonical
(store order, the same every epoch) and an epoch shuffles the chunk order
and the tile order within each chunk; with ``cache='never'`` the record
order itself reshuffles across chunk boundaries every epoch.  The epoch's
generator is ``np.random.default_rng([seed, epoch])``, so a resume replays
it.  With ``chunk_tiles >= n`` and ``shuffle=False`` the trajectory is
``train.fit``'s.

The chunk cache keeps assembled chunks in host RAM as the first epoch
streams them, within ``SPECENH_STREAM_CACHE_GB`` (default 60 % of
MemAvailable); later epochs stream from memory.  The cached chunks are
pageable, behind two pinned staging buffers: on an H100 host the staging
copy of a 2048-tile chunk's x ran at 6.9-27 GB/s on the reader thread,
hidden behind the chunk's steps, while page-locking a chunk
(``cudaHostRegister``) ran no faster, 3.6-10.6 GB/s, and a pinned cache
would lock up to the whole budget (``chip_smoke.py`` phase 17).  ``tile_cache`` keeps
the canonical tile stream on disk (``data.tilecache``) for later runs.
``cache_dtype='bf16'`` holds and uploads chunks as bfloat16 (half the
bytes); they are widened to float32 on the device, which is value-exact
on the training kernels (they round their tile operands to bf16 as they
load them), and rounds the inputs of the autograd engines.

On the card, where JAX's asynchronous dispatch overlaps chunk i+1's read
and upload with chunk i's program for free, the overlap is built by hand
(``_ChunkStream``): a reader thread assembles chunks and copies each into
one of two pinned staging buffers; the dispatching thread uploads it with
``copy_(non_blocking=True)`` on a side stream, which the compute stream
waits on; a staging buffer is refilled only after its copy's event has
fired, device chunks are marked with ``record_stream`` for the compute
stream, and at most two chunks are on the device at once.  The losses stay
on the device until the split's epoch ends.

Over a ``parallel.mesh.Mesh`` (``fit_streaming(mesh=)``) every rank
streams the same chunks and draws the same shuffles, and uploads only the
rows its block of each global batch reads; the data-parallel engines
(``parallel.data_parallel``, ``parallel.dp_kernel``) sum the gradients.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import random
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from specenh_torch.config import PatchSpec, TrainConfig
from specenh_torch.data.grain_pipeline import RecordSlice, iter_record_slices
from specenh_torch.data.tiles import n_tiles_for
from specenh_torch.io.store import SpectrogramStore
from specenh_torch.train import (TrainState, _epoch_batches, _save_checkpoint, check_run_meta,
                                 eval_epoch, latest_checkpoint_epoch, restore_checkpoint,
                                 train_epoch, weighted_epoch_mean, write_run_meta)

__all__ = ["StreamPlan", "plan_stream_split", "fit_streaming", "estimate_resident_bytes"]


class StreamPlan:
    """Per-split record slices of a streamed campaign."""

    def __init__(self, train: List[RecordSlice], tune: List[RecordSlice],
                 test: List[RecordSlice], tile_shape: Tuple[int, int]):
        self.train = train
        self.tune = tune
        self.test = test
        self.tile_shape = tile_shape  # (F, W)

    def n_tiles(self, split: str) -> int:
        return sum(s.n_tiles for s in getattr(self, split))


def plan_stream_split(
    store: SpectrogramStore,
    num_samples: int = 20,
    channels: Optional[Sequence[int]] = None,
    ps: PatchSpec = PatchSpec(),
    cfg: TrainConfig = TrainConfig(),
    seed: Optional[int] = None,
) -> StreamPlan:
    """``data.dataset.assemble_from_store`` as record slices: the same
    sampled shots (``random.Random(seed).sample``, hyperparam_scan.py:133)
    and the same split boundaries, read from the store's metadata only.

    ``split_by='tile'`` puts the reference's int(n*0.6) / int(n*0.85)
    boundaries on the global tile index (a boundary inside a channel gives
    a slice to each side: the reference's leaky split); ``split_by='shot'``
    splits the sampled shot list first (dataset.ipynb cell 3)."""
    rng = random.Random(seed)
    keys = rng.sample(store.shots(), min(num_samples, len(store.shots())))
    if channels is None:
        channels = store.channels_of(keys[0])

    def k_of(shot: str, chn: int) -> int:
        return n_tiles_for(store.spec_shape(shot, chn)[-1], ps)

    tile_shape = (store.spec_shape(keys[0], channels[0])[0], ps.tile_time)

    if cfg.split_by == "shot":
        a = int(len(keys) * cfg.split_fracs[0])
        b = int(len(keys) * cfg.split_fracs[1])
        if a == 0 or b == a:
            raise ValueError(
                f"{len(keys)} shots are too few for a shot-level "
                f"{cfg.split_fracs} split; sample more shots or use "
                "split_by='tile'"
            )

        def whole(shot_keys):
            return [RecordSlice(s, c, 0, k_of(s, c)) for s in shot_keys for c in channels]

        return StreamPlan(whole(keys[:a]), whole(keys[a:b]), whole(keys[b:]), tile_shape)

    records = [(s, c, k_of(s, c)) for s in keys for c in channels]
    n = sum(k for _, _, k in records)
    a, b = int(n * cfg.split_fracs[0]), int(n * cfg.split_fracs[1])
    splits: List[List[RecordSlice]] = [[], [], []]
    bounds = [(0, a), (a, b), (b, n)]
    g = 0
    for shot, chn, k in records:
        for si, (lo_b, hi_b) in enumerate(bounds):
            lo = max(lo_b, g) - g
            hi = min(hi_b, g + k) - g
            if hi > lo:
                splits[si].append(RecordSlice(shot, chn, lo, hi))
        g += k
    return StreamPlan(*splits, tile_shape=tile_shape)


def _iter_chunks(
    store: SpectrogramStore,
    slices: List[RecordSlice],
    ps: PatchSpec,
    chunk_tiles: int,
    order=None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Concatenate streamed records into (x, y) chunks of exactly
    ``chunk_tiles`` tiles (final chunk short), NHWC float32."""
    bx: List[np.ndarray] = []
    by: List[np.ndarray] = []
    n = 0
    for x, y in iter_record_slices(store, slices, ps, order):
        bx.append(x)
        by.append(y)
        n += len(x)
        while n >= chunk_tiles:
            xs, ys = np.concatenate(bx), np.concatenate(by)
            yield xs[:chunk_tiles], ys[:chunk_tiles]
            bx, by = [xs[chunk_tiles:]], [ys[chunk_tiles:]]
            n = len(bx[0])
    if n:
        yield np.concatenate(bx), np.concatenate(by)


def _chunk_plans(
    slices: Sequence[RecordSlice], chunk_tiles: int
) -> List[List[RecordSlice]]:
    """Cut the canonical (given-order) slice list into fixed-size chunk
    plans: each plan is a list of record sub-slices totalling exactly
    ``chunk_tiles`` tiles (final chunk short).  Composition depends only on
    the plan + chunk size — never on the epoch — so cached chunks are
    identical across epochs, resumes, and processes."""
    plans: List[List[RecordSlice]] = []
    cur: List[RecordSlice] = []
    n = 0
    for s in slices:
        lo = s.lo
        while lo < s.hi:
            take = min(s.hi - lo, chunk_tiles - n)
            cur.append(RecordSlice(s.shot, s.chn, lo, lo + take))
            lo += take
            n += take
            if n == chunk_tiles:
                plans.append(cur)
                cur, n = [], 0
    if cur:
        plans.append(cur)
    return plans


def _read_chunk(
    store: SpectrogramStore, plan: List[RecordSlice], ps: PatchSpec
) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble one canonical chunk as (n, F, W, 1) float32 pairs.

    Each record's tiles are written straight into a preallocated chunk
    tensor (one strided transpose-copy per record) instead of
    per-record materialize + concatenate — measured 2x on the host
    pipeline (the copies, not h5py, dominate the page-cached read)."""
    n = sum(s.n_tiles for s in plan)
    xo = yo = None
    pos = 0
    w = ps.tile_time
    for s in plan:
        x, y = store.read_column_slice(s.shot, s.chn, s.lo * w, s.hi * w)
        k, f = s.n_tiles, x.shape[0]
        if xo is None:
            xo = np.empty((n, f, w, 1), np.float32)
            yo = np.empty_like(xo)
        xo[pos:pos + k, ..., 0] = x.reshape(f, k, w).transpose(1, 0, 2)
        yo[pos:pos + k, ..., 0] = y.reshape(f, k, w).transpose(1, 0, 2)
        pos += k
    return xo, yo


def _stream_cache_budget_bytes() -> int:
    """Host-RAM budget for the chunk cache: SPECENH_STREAM_CACHE_GB, else
    60% of /proc/meminfo MemAvailable (0 where unreadable)."""
    env = os.environ.get("SPECENH_STREAM_CACHE_GB")
    if env is not None:
        return int(float(env) * 2**30)
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(int(line.split()[1]) * 1024 * 0.6)
    except OSError:
        pass
    return 0


def estimate_resident_bytes(n_tiles: int, ps: PatchSpec = PatchSpec()) -> int:
    """Device bytes of the resident fit's (x, y) float32 tile tensors."""
    return 2 * 4 * n_tiles * ps.tile_freq * ps.tile_time


# ---------------------------------------------------------------------------
# host chunks to the device
# ---------------------------------------------------------------------------


def _bf16(a) -> torch.Tensor:
    """A host chunk as ``torch.bfloat16``, rounded to nearest even (as
    ``ml_dtypes.bfloat16``); a bf16 chunk (the bf16 tile cache's) as it is."""
    if torch.is_tensor(a) and a.dtype == torch.bfloat16:
        return a
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _host_tiles(a) -> torch.Tensor:
    """A (k, F, W, 1) host chunk (numpy float32 or a bf16 tensor) as a
    (k, F, W) CPU tensor sharing its memory."""
    t = a if torch.is_tensor(a) else torch.from_numpy(a)
    return t.reshape(t.shape[:3])


class _Staging:
    """Pinned host buffers for one chunk's (x, y), and the event of the
    upload that last read them."""

    def __init__(self, shape, dtype):
        self.x = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.y = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.copied = torch.cuda.Event()

    def fill(self, hx, hy, rows=None) -> int:
        """Copy a host chunk, or its ``rows`` (gathered straight into the
        pinned buffer), into the buffers; returns the tiles copied."""
        self.copied.synchronize()  # its previous upload has read it
        if rows is None:
            n = hx.shape[0]
            self.x[:n].copy_(_host_tiles(hx))
            self.y[:n].copy_(_host_tiles(hy))
            return n
        idx = torch.from_numpy(rows)
        n = len(rows)
        torch.index_select(_host_tiles(hx), 0, idx, out=self.x[:n])
        torch.index_select(_host_tiles(hy), 0, idx, out=self.y[:n])
        return n


class _ChunkStream:
    """Host chunks to float32 (k, F, W) device tensors.  On a CPU device
    they are the host arrays themselves.  On the card a reader thread
    assembles the chunks (store reads, cache hits) and copies each into
    one of two pinned staging buffers; the caller's thread uploads it on a
    side stream (``copy_(non_blocking=True)``) that the compute stream
    waits on, widens a bf16 chunk to float32 on the compute stream, and
    before uploading chunk k waits until the compute stream is done with
    chunk k - 2, so at most two chunks are on the device.  A chunk given
    as (x, y, rows) goes up as its ``rows`` alone (a rank's block on a
    mesh), gathered on the host into the staging buffer: ``max_tiles``
    bounds the rows."""

    def __init__(self, dev: torch.device, max_tiles: int, tile_shape, dtype):
        self.dev = dev
        self.dtype = dtype
        if dev.type == "cuda":
            self.copy_stream = torch.cuda.Stream(dev)
            self.slots = [_Staging((max_tiles, *tile_shape), dtype) for _ in range(2)]

    def run(self, chunks: Iterator) -> Iterator:
        """(tag, device x, device y) for each (tag, (host x, host y[,
        rows])) of ``chunks``; the generator must be run to its end or
        closed."""
        if self.dev.type != "cuda":
            for tag, (hx, hy, *rows) in chunks:
                hx, hy = _host_tiles(hx), _host_tiles(hy)
                if rows and rows[0] is not None:
                    idx = torch.from_numpy(rows[0])
                    hx, hy = hx[idx], hy[idx]
                yield tag, hx.float(), hy.float()
            return
        free: "queue.Queue" = queue.Queue()
        ready: "queue.Queue" = queue.Queue()
        for s in self.slots:
            free.put(s)
        stop = threading.Event()

        def reader():
            try:
                for tag, (hx, hy, *rows) in chunks:
                    slot = None
                    while slot is None:
                        if stop.is_set():
                            return
                        try:
                            slot = free.get(timeout=0.1)
                        except queue.Empty:
                            pass
                    ready.put((tag, slot, slot.fill(hx, hy, *rows)))
                ready.put(None)
            except BaseException as e:  # handed to the consumer, which raises it
                ready.put(e)

        thread = threading.Thread(target=reader, name="stream-reader", daemon=True)
        thread.start()
        compute = torch.cuda.current_stream(self.dev)
        done: collections.deque = collections.deque()
        try:
            while True:
                item = ready.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                tag, slot, n = item
                if len(done) == 2:
                    done.popleft().synchronize()  # chunk k - 2's steps are done
                with torch.cuda.stream(self.copy_stream):
                    xd = torch.empty((n, *slot.x.shape[1:]), dtype=self.dtype,
                                     device=self.dev)
                    yd = torch.empty_like(xd)
                    xd.copy_(slot.x[:n], non_blocking=True)
                    yd.copy_(slot.y[:n], non_blocking=True)
                    slot.copied.record(self.copy_stream)
                free.put(slot)
                compute.wait_stream(self.copy_stream)
                xd.record_stream(compute)
                yd.record_stream(compute)
                yield tag, xd.float(), yd.float()
                ev = torch.cuda.Event()
                ev.record(compute)
                done.append(ev)
        finally:
            stop.set()
            thread.join()


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A small host array on ``dev``: on the card from pinned memory,
    non-blocking (a pageable copy would wait for the queued kernels)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _cache_budget(cache: str, mesh=None) -> float:
    """Host RAM for one process's chunk cache: unbounded for 'always',
    else ``_stream_cache_budget_bytes`` (a host's), shared equally by the
    ranks of ``mesh`` on this host (``parallel.mesh.local_size``): each
    rank caches the whole chunks it streams, in its own process."""
    if cache == "always":
        return float("inf")
    budget = _stream_cache_budget_bytes()
    if mesh is not None:
        from specenh_torch.parallel.mesh import local_size

        budget //= local_size(mesh)
    return budget


def _open_tile_cache(mesh, store, slices, base: str, split: str, ps: PatchSpec, dtype: str,
                     verbose: bool):
    """``data.tilecache.open_or_build``; on a mesh the host's local rank 0
    builds a missing cache (one writer a file) while the host's other
    ranks wait at a barrier, then open what it wrote."""
    from specenh_torch.data.tilecache import open_or_build

    if mesh is None:
        return open_or_build(store, slices, base, split, ps, dtype, verbose=verbose)
    from specenh_torch.parallel.data_parallel import barrier
    from specenh_torch.parallel.mesh import local_rank

    builds = local_rank(mesh) == 0
    reader = open_or_build(store, slices, base, split, ps, dtype,
                           verbose=verbose) if builds else None
    barrier(mesh)
    if reader is None:
        reader = open_or_build(store, slices, base, split, ps, dtype, verbose=verbose)
    return reader


# ---------------------------------------------------------------------------
# the streamed fit
# ---------------------------------------------------------------------------


def fit_streaming(
    state: TrainState,
    store: SpectrogramStore,
    plan: StreamPlan,
    cfg: TrainConfig = TrainConfig(),
    epochs: Optional[int] = None,
    chunk_tiles: int = 4096,
    ps: PatchSpec = PatchSpec(),
    metrics_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    epoch_fn=None,
    mesh=None,
    cache: str = "auto",
    cache_dtype: Optional[str] = None,
    tile_cache: Optional[str] = None,
    verbose: bool = False,
) -> Tuple[TrainState, Dict[str, list]]:
    """Keras-fit equivalent over a streamed store, on ``state.device``:
    returns (state, history) with ``train.fit``'s keys ('loss',
    'val_loss', 'new_epochs' and, after an early stop, 'stopped_epoch').

    ``chunk_tiles`` bounds what the device holds: two chunks of (x, y)
    (the default 4096 tiles is ~1.1 GB).  It is rounded up to a multiple
    of the batch.  ``epoch_fn`` is the engine (``train.train_epoch``'s
    signature), run on each chunk; the validation pass is
    ``train.eval_epoch``.

    ``mesh`` (a ``parallel.mesh.Mesh``, ``state`` on its rank's device)
    trains data-parallel, every rank streaming the same chunks: the batch
    is GLOBAL, rounded up to a multiple of the ranks (a short chunk's
    batch too, its padding masked), and each rank uploads only its
    contiguous block of every batch of a chunk, its rows gathered on the
    host, so a card holds two chunks' blocks.  The engine is ``epoch_fn``
    with ``make_dp_epoch_programs``' contract (``dp_kernel_epoch_for``),
    else the dp autograd epoch; validation is the dp eval.  Parameters
    start from rank 0's (one broadcast); rank 0 writes the metrics,
    checkpoints and ``run_meta.json``.  A mesh of one trains the
    unsharded stream bit for bit.

    ``cache``: 'auto' keeps chunks in host RAM while they fit
    ``SPECENH_STREAM_CACHE_GB`` (default 60 % of MemAvailable), so epochs
    after the first stream from memory; on a mesh that budget is a host's,
    split equally among its ranks (``LOCAL_WORLD_SIZE``), each of which
    caches the whole chunks in its own process; 'always' ignores the
    budget; 'never' reshuffles records across chunk boundaries every epoch
    and reads the store every epoch.  ``cache_dtype='bf16'`` holds and
    uploads chunks as bfloat16 (module docstring).  ``tile_cache`` (a base
    path) keeps the canonical tile stream on disk in the chunk dtype
    (``data.tilecache``): the first run builds ``<base>.<split>.tiles`` in
    one pass over the store, later runs read contiguous slabs of it; on a
    mesh one rank a host builds it while the host's others wait.

    With ``checkpoint_dir`` every epoch saves the state
    (``train._save_checkpoint``), ``history.json``, and ``run_meta.json``
    with 'streamed', 'chunk_tiles' and 'devices' (the mesh's size, else
    1); ``resume=True`` continues from the latest epoch, and a checkpoint
    of another device count raises."""
    epochs = cfg.epochs if epochs is None else epochs
    dev = state.device
    n = plan.n_tiles("train")
    if n == 0:
        raise ValueError("streaming plan has no training tiles")
    bs = min(cfg.batch_size, n)
    n_dev = 1
    if mesh is not None:
        if dev != mesh.device:
            raise ValueError(f"the state is on {dev}, this rank's device is {mesh.device}")
        n_dev = mesh.size
        bs = max(bs, n_dev)
        bs += (-bs) % n_dev
    lead = mesh is None or mesh.rank == 0
    chunk_tiles = min(chunk_tiles, n)
    chunk_tiles += (-chunk_tiles) % bs

    if checkpoint_dir:
        checkpoint_dir = os.path.abspath(checkpoint_dir)

    run_meta = {
        "n": int(n), "seed": int(cfg.seed), "batch_size": int(bs),
        "shuffle": bool(cfg.shuffle), "chunk_tiles": int(chunk_tiles),
        "streamed": True, "devices": int(n_dev),
    }
    history: Dict[str, list] = {"loss": [], "val_loss": []}
    # every read of the checkpoint directory happens before the ranks
    # agree, every write (rank 0's) after it
    start_epoch = 0
    last = latest_checkpoint_epoch(checkpoint_dir) if resume and checkpoint_dir else None
    if last is not None:
        check_run_meta(checkpoint_dir, run_meta, optional_keys=("devices",))
        state = restore_checkpoint(state, checkpoint_dir, last)
        start_epoch = last + 1
        hpath = os.path.join(checkpoint_dir, "history.json")
        if os.path.exists(hpath):
            with open(hpath) as fh:
                saved = json.load(fh)
            history["loss"] = list(saved.get("loss", []))[:start_epoch]
            history["val_loss"] = list(saved.get("val_loss", []))[:start_epoch]
        if verbose and lead:
            print(f"stream-resumed from epoch {last}")
    if mesh is not None:
        from specenh_torch.parallel.data_parallel import (_agree, _block, _broadcast_params,
                                                          _local_rows, make_dp_epoch_programs)

        _agree(mesh, "[n, batch size, chunk tiles, seed, last checkpoint]", n, bs,
               chunk_tiles, cfg.seed, -1 if last is None else last)
        _broadcast_params(mesh, state.model)
        dp_train, eval_fn = make_dp_epoch_programs(mesh)
        train_fn = epoch_fn if epoch_fn is not None else dp_train
    else:
        train_fn = epoch_fn if epoch_fn is not None else train_epoch
        eval_fn = eval_epoch
    if checkpoint_dir and lead:
        write_run_meta(checkpoint_dir, run_meta)
    writer = open(metrics_path, "a") if metrics_path and lead else None

    have_val = plan.n_tiles("tune") > 0

    if cache not in ("auto", "always", "never"):
        raise ValueError(f"cache must be 'auto'|'always'|'never', got {cache!r}")
    if cache_dtype not in (None, "f32", "bf16"):
        raise ValueError(f"cache_dtype must be None|'f32'|'bf16', got {cache_dtype!r}")
    bf16 = cache_dtype == "bf16"
    use_cache = cache != "never"
    cache_budget = _cache_budget(cache, mesh)
    chunk_plans = (
        {"train": _chunk_plans(plan.train, chunk_tiles),
         "tune": _chunk_plans(plan.tune, chunk_tiles)}
        if use_cache else None
    )
    chunk_cache: Dict[str, Dict[int, tuple]] = {"train": {}, "tune": {}}
    cache_bytes = [0]

    tile_readers: Dict[str, object] = {}
    chunk_offs: Dict[str, np.ndarray] = {}
    if tile_cache is not None:
        if not use_cache:
            raise ValueError(
                "tile_cache requires canonical chunk composition; it cannot "
                "combine with cache='never' (per-epoch record reshuffle)"
            )
        tc_dtype = "bf16" if bf16 else "f32"
        for split, slices in (("train", plan.train), ("tune", plan.tune)):
            if not slices:
                continue
            tile_readers[split] = _open_tile_cache(mesh, store, slices, tile_cache, split, ps,
                                                   tc_dtype, verbose and lead)
            sizes = [sum(s.n_tiles for s in p) for p in chunk_plans[split]]
            chunk_offs[split] = np.concatenate([[0], np.cumsum(sizes)])

    # a chunk's batches read at most chunk_tiles / n_dev of its rows on a rank
    stream = _ChunkStream(dev, chunk_tiles // n_dev, plan.tile_shape,
                          torch.bfloat16 if bf16 else torch.float32)

    def host_chunks(split: str, slices, rng, train: bool):
        """The split's host chunks in this epoch's order; the order is
        drawn from ``rng`` now, the chunks are read as they are asked
        for (on the reader thread)."""
        if use_cache:
            # canonical chunk composition; the epoch shuffles the chunk
            # order (and the tile order within each chunk, by the caller);
            # a miss reads the store (or the tile cache) and keeps the
            # chunk while the budget allows
            plans = chunk_plans[split]
            corder = (rng.permutation(len(plans)) if (train and cfg.shuffle)
                      else np.arange(len(plans)))
            reader = tile_readers.get(split)

            def gen():
                cmap = chunk_cache[split]
                for j in corder:
                    j = int(j)
                    hit = cmap.get(j)
                    if hit is None:
                        if reader is not None:
                            off = chunk_offs[split]
                            hit = reader.read(int(off[j]), int(off[j + 1]))
                        else:
                            hit = _read_chunk(store, plans[j], ps)
                        if bf16:
                            hit = (_bf16(hit[0]), _bf16(hit[1]))
                        sz = hit[0].nbytes + hit[1].nbytes
                        if cache_bytes[0] + sz <= cache_budget:
                            cmap[j] = hit
                            cache_bytes[0] += sz
                    yield hit

            return gen()
        order = (rng.permutation(len(slices)) if (train and cfg.shuffle)
                 else np.arange(len(slices)))
        chunks = _iter_chunks(store, list(slices), ps, chunk_tiles, order)
        return ((_bf16(x), _bf16(y)) for x, y in chunks) if bf16 else chunks

    def batched(split: str, chunks, rng, train: bool):
        """(tag, (x, y, rows)) for each host chunk: the tag holds the
        chunk's global batches (drawn from ``rng`` in chunk order, as the
        chunks arrive) and this rank's share of them; ``rows`` are the
        chunk's rows its share reads (None: all, off a mesh)."""
        for x, y in chunks:
            nc = x.shape[0]
            perm = rng.permutation(nc) if (train and cfg.shuffle) else np.arange(nc)
            if mesh is None:
                bi, bm = _epoch_batches(nc, min(bs, nc), perm)
                yield (split, bm, bi, bm), (x, y, None)
                continue
            # the chunk's batch stays a device multiple (a short final
            # chunk's may exceed nc: its padding is masked)
            bi, bm = _epoch_batches(nc, min(bs, nc + (-nc) % n_dev), perm)
            blk = _block(mesh, bi.shape[1])
            rows, mine = _local_rows(bi[:, blk], bm[:, blk])
            yield (split, bm, mine, bm[:, blk]), (x, y, rows)

    def run_epoch(epoch: int) -> Dict[str, float]:
        """Stream the epoch's train chunks, then its tune chunks, through
        the device in one pipeline; returns each split's mask-weighted
        mean loss.  Each split's generator is default_rng([seed, epoch]),
        as in the JAX package, so a resume replays the shuffle."""
        nonlocal state
        splits = [("train", plan.train, True)] + ([("tune", plan.tune, False)] if have_val
                                                   else [])
        rngs = {s: np.random.default_rng([cfg.seed, epoch]) for s, _, _ in splits}
        sources = [batched(s, host_chunks(s, sl, rngs[s], tr), rngs[s], tr)
                   for s, sl, tr in splits]
        losses: Dict[str, list] = {s: [] for s, _, _ in splits}
        masks: Dict[str, list] = {s: [] for s, _, _ in splits}
        for (split, bm, bi, bm_mine), xd, yd in stream.run(c for it in sources for c in it):
            args = (xd, yd, _to_device(bi, dev), _to_device(bm_mine, dev))
            if split == "train":
                state, out = train_fn(state, *args)
            else:
                out = eval_fn(state, *args)
            losses[split].append(out)  # left on the device
            masks[split].append(bm.sum(axis=1, keepdims=True))  # each batch's weight
        return {s: float(weighted_epoch_mean(torch.cat(losses[s]), np.concatenate(masks[s])))
                for s in losses}

    # opt-in early stopping (cfg.patience, as train.fit): seeded from a
    # restored history, so a resume counts stale epochs as the full run;
    # on a mesh val_loss is global, so every rank decides the same
    best_val = min(history["val_loss"], default=np.inf)
    stale = 0
    if cfg.patience is not None and history["val_loss"]:
        b = int(np.argmin(history["val_loss"]))
        stale = len(history["val_loss"]) - 1 - b
        if stale >= cfg.patience:  # the uninterrupted run stopped here
            history["stopped_epoch"] = start_epoch - 1
            start_epoch = epochs

    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        means = run_epoch(epoch)
        epoch_loss = means["train"]
        history["loss"].append(epoch_loss)
        val = means.get("tune")
        if val is not None:
            history["val_loss"].append(val)
        dt = time.perf_counter() - t0
        if verbose and lead:
            msg = f"epoch {epoch + 1}/{epochs} loss={epoch_loss:.5f}"
            if val is not None:
                msg += f" val_loss={val:.5f}"
            src = "streamed"
            if use_cache:
                n_pin = sum(len(c) for c in chunk_cache.values())
                n_all = sum(len(p) for p in chunk_plans.values())
                src = (f"streamed, cache {n_pin}/{n_all} chunks "
                       f"{cache_bytes[0] / 2**30:.1f} GB")
            print(msg + f" ({dt:.2f}s, {src})")
        if writer:
            writer.write(json.dumps({
                "epoch": epoch, "loss": epoch_loss, "val_loss": val, "sec": dt,
                "streamed": True, "devices": int(n_dev),
            }) + "\n")
            writer.flush()
        if checkpoint_dir and lead:
            _save_checkpoint(state, checkpoint_dir, epoch)
            with open(os.path.join(checkpoint_dir, "history.json"), "w") as fh:
                json.dump(history, fh)
        if cfg.patience is not None and val is not None:
            if val < best_val:
                best_val, stale = val, 0
            else:
                stale += 1
            if stale >= cfg.patience:
                history["stopped_epoch"] = epoch
                if checkpoint_dir and lead:
                    with open(os.path.join(checkpoint_dir, "history.json"), "w") as fh:
                        json.dump(history, fh)
                if verbose and lead:
                    print(f"early stopping: val_loss stale for "
                          f"{cfg.patience} epochs (best {best_val:.5f})")
                break
    if writer:
        writer.close()
    if mesh is not None:
        # no rank returns before rank 0's files are written
        _agree(mesh, "[epochs in the history, stopped epoch]", len(history["loss"]),
               history.get("stopped_epoch", -1))
    # as train.fit: 0 when resume found a finished run
    history["new_epochs"] = max(0, epochs - start_epoch)
    return state, history
