"""HDF5 spectrogram dataset store + resumable campaign manifest: a copy of
``specenh.io.store``, so a store written by either package reads in the
other.  h5py is imported inside the calls that open a file, so serving and
training never load it.

Schema is byte-compatible with the reference's
(spec_denoising/pipeline_data.py:90-116):

    <file>.hdf5
      ece_<shot>/chn_<n>/spec          (256, 3905) float
      ece_<shot>/chn_<n>/f             (256,)      float
      ece_<shot>/chn_<n>/t             (3905,)     float
      ece_<shot>/chn_<n>/pipeline_out  (256, 3905) float

Improvements over the reference (SURVEY.md section 5):
* idempotent writes — re-running on a shot overwrites instead of crashing on
  create_group of an existing group (the reference's append-mode quirk);
* a JSONL manifest of completed (shot, channel) pairs => a crashed campaign
  resumes where it stopped (elastic restart for free);
* per-shot error quarantine lives in the campaign code
  (specenh_torch.pipeline), not here.
"""

from __future__ import annotations

import glob
import json
import os
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "SpectrogramStore",
    "StoreWriterPool",
    "CampaignManifest",
    "consolidate_shards",
    "retire_stale_manifest",
]


def _free_corrupt_name(path: str) -> str:
    cand, i = path + ".corrupt", 1
    while os.path.exists(cand):
        cand = f"{path}.corrupt{i}"
        i += 1
    return cand


# h5py wraps every open failure in OSError; only ACTUAL file corruption may
# trigger the append-mode quarantine.  Lock contention ("unable to lock
# file", "file is already open"), permissions, or ENOSPC must propagate —
# quarantining a healthy store because another process holds it would
# silently restart the campaign from scratch.
_CORRUPT_MARKERS = (
    "file signature not found",
    "truncated file",
    "bad superblock",
    "unable to read superblock",
    "bad object header",
)


def _is_corrupt_hdf5_error(e: OSError) -> bool:
    msg = str(e).lower()
    return any(m in msg for m in _CORRUPT_MARKERS)


def retire_stale_manifest(store, manifest_path: str) -> None:
    """If ``store`` just quarantined a corrupt file, the manifest's "done"
    records describe data that no longer exists — move it next to the
    quarantined store so the campaign rebuilds from scratch instead of
    silently skipping everything."""
    if getattr(store, "quarantined", None) and os.path.exists(manifest_path):
        os.replace(manifest_path, store.quarantined + ".manifest.jsonl")


class SpectrogramStore:
    """Thin h5py wrapper with the reference schema.

    A campaign killed mid-write (SIGTERM, OOM, node preemption) can leave
    a truncated HDF5 that h5py refuses to open at all — which would brick
    every later resume.  In append mode the store QUARANTINES such a file
    (renames it to ``<path>.corrupt``) and starts fresh, recording the
    moved path in ``self.quarantined`` so a campaign can retire the
    paired manifest too (its "done" records point at lost data).  Read
    modes never destroy evidence: the OSError propagates.

    Sharded layout: a :class:`StoreWriterPool` with N>1 writers persists
    into the base file plus sidecar files ``<path>.shard1``, ``.shard2``,
    …  In READ mode the store opens any such sidecars automatically and
    presents the UNION (base first, shards in index order — duplicates
    resolve to the earliest file), so downstream consumers (sweep, train,
    assemble_from_store) never see the sharding.  An unreadable sidecar in
    read mode is an error like any other read-mode corruption.
    """

    def __init__(self, path: str, mode: str = "a"):
        import h5py

        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        self.path = path
        self.quarantined: Optional[str] = None
        try:
            self._f = h5py.File(path, mode)
        except OSError as e:
            if (
                mode != "a"
                or not os.path.exists(path)
                or not _is_corrupt_hdf5_error(e)
            ):
                raise
            self.quarantined = _free_corrupt_name(path)
            os.replace(path, self.quarantined)
            warnings.warn(
                f"unreadable HDF5 store quarantined to {self.quarantined}; "
                "starting a fresh store (a crashed campaign likely truncated it)"
            )
            self._f = h5py.File(path, mode)
        self._shards: List = []
        self._owners: Dict = {}
        if mode == "r":
            # writer-pool sidecars, shard index order (shard1, shard2, ...)
            sidecars = sorted(
                (p for p in glob.glob(glob.escape(path) + ".shard*")
                 if p[len(path) + 6:].isdigit()),
                key=lambda p: int(p[len(path) + 6:]),
            )
            self._shards = [h5py.File(p, "r") for p in sidecars]
            if self._shards:
                # resolve each top-level group to ONE file.  A shot group
                # duplicated across files (a crash left a partial write,
                # the retry landed elsewhere) resolves to the file with
                # the MOST channels; ties to the earliest file (base
                # first) — metadata-only scan, no data reads.
                best: Dict[str, int] = {}
                for f in self._files():
                    for k in f.keys():
                        n = len(f[k])
                        if n > best.get(k, -1):
                            best[k] = n
                            self._owners[k] = f

    # -- shard resolution -----------------------------------------------------

    def _files(self):
        yield self._f
        yield from self._shards

    def _file_of(self, name: str):
        """The h5py file holding group ``name``.  Top-level shot groups
        resolve through the owner map (most-complete file wins); deeper
        names fall back to a scan when absent from the owner."""
        if self._owners:
            f = self._owners.get(name.split("/", 1)[0])
            if f is not None and name in f:
                return f
        for f in self._files():
            if name in f:
                return f
        # preserve h5py's KeyError semantics for missing groups
        return self._f

    # -- writing ------------------------------------------------------------

    def write_channel(
        self,
        shot: str,
        chn: int,
        spec: np.ndarray,
        f: np.ndarray,
        t: np.ndarray,
        pipeline_out: np.ndarray,
        prefix: str = "ece",
    ) -> None:
        name = f"{prefix}_{shot}/chn_{chn}"
        if name in self._f:
            del self._f[name]  # idempotent overwrite
        grp = self._f.create_group(name)
        grp.create_dataset("spec", data=np.asarray(spec))
        grp.create_dataset("f", data=np.asarray(f))
        grp.create_dataset("t", data=np.asarray(t))
        grp.create_dataset("pipeline_out", data=np.asarray(pipeline_out))

    # -- reading (hyperparam_scan.py:130-141 access pattern) -----------------

    def shots(self) -> List[str]:
        # name-sorted like a single h5py file iterates, so the union order
        # is independent of HOW the data was sharded across writers —
        # seeded shot sampling (plan_stream_split, assemble_from_store)
        # must pick the same subset for --writers 1 and --writers 8
        seen = set()
        for f in self._files():
            seen.update(f.keys())
        return sorted(seen)

    def channels_of(self, shot_group: str) -> List[int]:
        grp = self._file_of(shot_group)[shot_group]
        return sorted(int(n.split("_")[1]) for n in grp.keys())

    def has_channel(self, shot_group: str, chn: int) -> bool:
        name = f"{shot_group}/chn_{chn}"
        return any(name in f for f in self._files())

    def spec_shape(self, shot_group: str, chn: int) -> Tuple[int, ...]:
        """Shape of one channel's spectrogram WITHOUT reading the data
        (h5py dataset metadata) — the streaming split plan sizes every
        record from this."""
        name = f"{shot_group}/chn_{chn}"
        return tuple(self._file_of(name)[name]["spec"].shape)

    def read_channel(self, shot_group: str, chn: int) -> Dict[str, np.ndarray]:
        name = f"{shot_group}/chn_{chn}"
        grp = self._file_of(name)[name]
        return {k: np.asarray(grp[k]) for k in ("spec", "f", "t", "pipeline_out")}

    def read_axes(self, shot_group: str, chn: int) -> Dict[str, np.ndarray]:
        """Just the (f, t) axis vectors — KBs, not the MB-scale spec data.
        The artifact stages use this when the tile data itself comes from
        the pre-tiled cache (cli.cmd_train --tile-cache)."""
        name = f"{shot_group}/chn_{chn}"
        grp = self._file_of(name)[name]
        return {k: np.asarray(grp[k]) for k in ("f", "t")}

    def read_column_slice(
        self, shot_group: str, chn: int, c0: int, c1: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Columns [c0, c1) of one record's (spec, pipeline_out) as float32
        (the streaming trainer's unit IO); goes through the shard-union
        like every other accessor.

        IO shape: an HDF5 column slice of a row-major dataset is one small
        read PER ROW — measured 0.08 GB/s cold on this class of disk vs
        0.96 GB/s for the whole contiguous dataset (12x).  So any slice
        covering >= 1/4 of the columns reads the whole record and trims in
        memory (break-even is ~8%); genuinely thin slices (mid-channel
        split boundaries) keep the partial read."""
        name = f"{shot_group}/chn_{chn}"
        grp = self._file_of(name)[name]
        n_cols = grp["spec"].shape[-1]
        if 4 * (c1 - c0) >= n_cols:
            return (
                np.asarray(grp["spec"][()][:, c0:c1], dtype=np.float32),
                np.asarray(grp["pipeline_out"][()][:, c0:c1], dtype=np.float32),
            )
        return (
            np.asarray(grp["spec"][:, c0:c1], dtype=np.float32),
            np.asarray(grp["pipeline_out"][:, c0:c1], dtype=np.float32),
        )

    def read_spec_and_labels(
        self, shot_group: str, channels: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        specs, labels = [], []
        for chn in channels:
            name = f"{shot_group}/chn_{chn}"
            grp = self._file_of(name)[name]
            specs.append(np.asarray(grp["spec"]))
            labels.append(np.asarray(grp["pipeline_out"]))
        return np.stack(specs), np.stack(labels)

    def iter_channels(self) -> Iterator[Tuple[str, int]]:
        for shot in self.shots():  # name-sorted, layout-independent
            for chn_name in self._file_of(shot)[shot]:
                yield shot, int(chn_name.split("_")[1])

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
        for f in self._shards:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StoreWriterPool:
    """N parallel HDF5 stores for write-bound campaigns (once the device is
    fast, persisting a shot takes longer than computing it).

    HDF5 serializes all writers on one file, so the pool gives each writer
    thread its OWN file: the base ``path`` plus ``<path>.shard1`` …
    ``<path>.shard{N-1}`` sidecars.  Shots route deterministically
    (``shard_of``: stable CRC32 of the shot id, mod N) so a shot
    reprocessed after a crash overwrites IN PLACE instead of duplicating
    across shards (and ``SpectrogramStore('r')``'s union view resolves any
    straddlers that do occur — e.g. after changing ``--writers`` — to the
    most-complete copy).  Each store in ``stores`` must be touched by
    exactly one thread; the pool itself only constructs/flushes/closes.
    """

    def __init__(self, path: str, writers: int = 1):
        if writers < 1:
            raise ValueError(f"writers must be >= 1, got {writers}")
        self.path = path
        self.writers = writers
        self.stores = [SpectrogramStore(path)] + [
            SpectrogramStore(f"{path}.shard{k}") for k in range(1, writers)
        ]
        self._owns_stores = True
        self._qs: list = []
        self._threads: list = []
        self.errors: list = []

    @classmethod
    def from_stores(cls, stores) -> "StoreWriterPool":
        """Wrap caller-owned store(s) in a pool (close() stays with the
        caller) — lets single-store call sites share the writer-thread
        machinery below."""
        pool = cls.__new__(cls)
        pool.path = stores[0].path
        pool.writers = len(stores)
        pool.stores = list(stores)
        pool._owns_stores = False
        pool._qs, pool._threads, pool.errors = [], [], []
        return pool

    # -- writer-thread runner -------------------------------------------------
    #
    # The shared scaffolding for write-bound daemons
    # (pipeline.build_dataset_streaming): one thread per shard store, items
    # routed by shard_of, bounded queues for backpressure.  ``handle(store,
    # item)`` owns ALL per-item bookkeeping including its own per-item
    # error handling (quarantine-and-continue).  If handle itself raises —
    # e.g. even recording the failure failed on a full disk — the thread
    # records the error and keeps DRAINING its queue (discarding items) so
    # producers never block on a dead writer's full queue; join() reports.

    def start(self, handle) -> None:
        import queue
        import threading

        if self._threads:
            raise RuntimeError("writer pool already started")
        self.errors = []
        self._qs = [queue.Queue(maxsize=2) for _ in self.stores]

        def writer(own_store, q):
            dead = False
            while True:
                item = q.get()
                if item is None:
                    return
                if dead:
                    continue  # drain so submit() never blocks forever
                try:
                    handle(own_store, item)
                except Exception as e:
                    self.errors.append(e)
                    dead = True

        self._threads = [
            threading.Thread(
                target=writer, args=(s, q), name=f"store-writer-{k}",
                daemon=True,
            )
            for k, (s, q) in enumerate(zip(self.stores, self._qs))
        ]
        for t in self._threads:
            t.start()

    def submit(self, shot, item) -> None:
        self._qs[self.shard_of(shot)].put(item)

    def join(self) -> list:
        """Retire the writer threads (finish in-flight work first); safe to
        call twice.  Returns recorded catastrophic errors — caller decides
        whether to raise (call it in a ``finally`` BEFORE the stores close,
        then ``raise_if_failed()`` on the normal path)."""
        for q in self._qs:
            q.put(None)
        for t in self._threads:
            t.join()
        self._qs, self._threads = [], []
        return self.errors

    def raise_if_failed(self) -> None:
        if self.errors:
            raise RuntimeError(
                f"{len(self.errors)} writer thread(s) failed fatally"
            ) from self.errors[0]

    @property
    def quarantined(self) -> Optional[str]:
        """First quarantined shard path, if any (retire_stale_manifest
        contract: the manifest's 'done' records died with that file)."""
        for s in self.stores:
            if s.quarantined:
                return s.quarantined
        return None

    def shard_of(self, shot) -> int:
        import zlib

        return zlib.crc32(str(shot).encode()) % self.writers

    def flush(self):
        for s in self.stores:
            s.flush()

    def close(self):
        if self._owns_stores:
            for s in self.stores:
                s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def consolidate_shards(
    path: str, out_path: Optional[str] = None, remove: bool = True
) -> int:
    """Fold a writer-pool store (base + ``<path>.shardK`` sidecars) into
    ONE HDF5 file, resolving duplicate shot groups exactly like the union
    read view (most-complete copy wins).  ``out_path=None`` consolidates
    into the base file and (with ``remove``) deletes the absorbed
    sidecars; with ``out_path`` the originals are left untouched.
    Idempotent.  Returns channels copied."""
    import h5py

    union = SpectrogramStore(path, "r")
    try:
        plan = [
            (shot, union._file_of(shot).filename) for shot in union.shots()
        ]
        shard_paths = [f.filename for f in union._shards]
    finally:
        union.close()

    dest = path if out_path is None else out_path
    n = 0
    with h5py.File(dest, "a") as out:
        for shot, src_path in plan:
            if os.path.samefile(src_path, dest):
                continue  # already lives in the destination
            with h5py.File(src_path, "r") as src:
                if shot in out:
                    del out[shot]
                src.copy(shot, out, name=shot)
                n += len(out[shot])
    if remove and out_path is None:
        for p in shard_paths:
            os.remove(p)
    return n


class CampaignManifest:
    """Append-only JSONL journal of completed work units; survives crashes.

    The reference has no resume story — a SLURM task that dies mid-campaign
    leaves a half-written HDF5 and must be re-run whole (SURVEY.md section 5).
    """

    def __init__(self, path: str):
        self.path = path
        self._done: set = set()
        self._failed: Dict[str, str] = {}
        self._failed_shot_set: set = set()
        if os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    key = (rec["shot"], rec.get("chn"))
                    if rec["status"] == "done":
                        self._done.add(key)
                    else:
                        self._failed[key] = rec.get("error", "")
                        self._failed_shot_set.add(rec["shot"])
        self._fh = open(path, "a")

    def is_done(self, shot: str, chn: Optional[int] = None) -> bool:
        return (shot, chn) in self._done

    def mark_done(self, shot: str, chn: Optional[int] = None):
        self._done.add((shot, chn))
        self._fh.write(json.dumps({"shot": shot, "chn": chn, "status": "done"}) + "\n")
        self._fh.flush()

    def mark_failed(self, shot: str, error: str, chn: Optional[int] = None):
        self._failed[(shot, chn)] = error
        self._failed_shot_set.add(shot)
        self._fh.write(
            json.dumps({"shot": shot, "chn": chn, "status": "failed", "error": error})
            + "\n"
        )
        self._fh.flush()

    @property
    def failed(self) -> Dict[tuple, str]:
        """(shot, chn) -> error message for every recorded failure."""
        return dict(self._failed)

    @property
    def failed_shots(self) -> set:
        """Shot ids with any recorded failure (for skip-once quarantine).
        Maintained incrementally — callers probe it once per shot in
        campaign loops."""
        return self._failed_shot_set

    def close(self):
        self._fh.close()
