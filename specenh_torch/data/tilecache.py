"""Pre-tiled on-disk tile cache for streamed campaigns (the counterpart of
``specenh.data.tilecache``).

The HDF5 store is the durable artifact; re-reading and re-tiling it costs
every run one pass over the store.  Workflows that revisit one dataset
many times (sweeps, resumed campaigns, repeated recipes) persist the
canonical tile stream once:

* one flat binary file per split, ``<base>.<split>.tiles``: the magic
  ``SPTC0001``, a little-endian ``<BQII`` header (length of the dtype
  name, n, F, W), the dtype name, then the x tiles and the y tiles as two
  contiguous (n, F, W) arrays.  The layout is the JAX package's, so for
  the same plan and dtype the port writes the same bytes;
* ``dtype='bf16'`` stores bfloat16 as raw 16-bit words (round to nearest
  even, as ``ml_dtypes``), written and read through a ``uint16`` memmap
  viewed as ``torch.bfloat16``: the card's software has no ``ml_dtypes``;
* a JSON sidecar, ``<base>.<split>.json``, fingerprints the exact slice
  plan, the patch geometry, the dtype and the store's identity.  A cache
  that does not match is rebuilt, never reused; a build that died before
  the sidecar was written is rebuilt.

The store's identity is where the port departs from the JAX package on
purpose: JAX keys each store file on ``path:size:mtime_ns``, which a copy
made with ``cp -p`` keeps, so a store restored that way over a cached one
serves the old tiles.  The port adds the inode and ``st_ctime_ns``, which
no copy can set, so its sidecar's fingerprint differs from JAX's.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from specenh_torch.config import PatchSpec

__all__ = [
    "plan_fingerprint",
    "store_identity",
    "build_tile_cache",
    "open_tile_cache",
    "open_or_build",
    "TileCacheReader",
]


def store_identity(store) -> str:
    """Identity string binding a cache to the backing store files:
    ``path:size:mtime_ns:inode:ctime_ns`` for the base HDF5 file and every
    ``.shardK`` sidecar (the writer-pool layout ``io.store`` reads).  A
    store rewritten in place, or a copy put in its place with ``cp -p``
    (which keeps size and mtime), changes the identity, so the cache
    rebuilds instead of serving stale tiles."""
    path = getattr(store, "path", None)
    if not path or not os.path.exists(path):
        return str(path)
    # glob.escape: a store path holding [, ], ? or * is not a pattern
    shards = sorted(
        (p for p in glob.glob(glob.escape(path) + ".shard*")
         if p[len(path) + 6:].isdigit()),
        key=lambda p: int(p[len(path) + 6:]),
    )
    parts = []
    for p in [path] + shards:
        st = os.stat(p)
        parts.append(f"{p}:{st.st_size}:{st.st_mtime_ns}:{st.st_ino}:{st.st_ctime_ns}")
    return ";".join(parts)


_MAGIC = b"SPTC0001"
# the stored words of each dtype name; bf16 is raw 16-bit words
_WORDS = {"f32": np.float32, "bf16": np.uint16}


def _words(name: str) -> np.dtype:
    if name not in _WORDS:
        raise ValueError(f"tile cache dtype must be 'f32' or 'bf16', got {name!r}")
    return np.dtype(_WORDS[name])


def _as_words(a: np.ndarray, name: str) -> np.ndarray:
    """Float32 tiles as the stored words of ``name``: bf16 rounds to
    nearest even (``torch.bfloat16``, as ``ml_dtypes.bfloat16``)."""
    if name == "f32":
        return a.astype(np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _paths(base: str, split: str) -> Tuple[str, str]:
    return f"{base}.{split}.tiles", f"{base}.{split}.json"


def plan_fingerprint(
    store_id: str, slices: Sequence, ps: PatchSpec, dtype: str
) -> str:
    """Digest of everything the cached bytes depend on."""
    doc = {
        "store": store_id,
        "slices": [(s.shot, int(s.chn), int(s.lo), int(s.hi)) for s in slices],
        "ps": [ps.tile_freq, ps.tile_time, ps.step],
        "dtype": dtype,
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()
    ).hexdigest()


class TileCacheReader:
    """Memmap view over one split's pre-tiled (x, y) tensors."""

    def __init__(self, bin_path: str):
        with open(bin_path, "rb") as fh:
            magic = fh.read(8)
            if magic != _MAGIC:
                raise ValueError(f"{bin_path}: not a tile cache (magic {magic!r})")
            dlen, n, f, w = struct.unpack("<BQII", fh.read(17))
            dname = fh.read(dlen).decode()
            self._off = fh.tell()
        self.dtype_name = dname
        self.n, self.f, self.w = int(n), int(f), int(w)
        dt = _words(dname)
        count = self.n * self.f * self.w
        shape = (self.n, self.f, self.w)
        self._x = np.memmap(bin_path, dtype=dt, mode="r", offset=self._off, shape=shape) \
            if self.n else np.zeros(shape, dt)
        self._y = np.memmap(bin_path, dtype=dt, mode="r",
                            offset=self._off + count * dt.itemsize, shape=shape) \
            if self.n else np.zeros(shape, dt)

    def read(self, lo: int, hi: int):
        """Tiles [lo, hi) as (k, F, W, 1) copies in the stored dtype: numpy
        float32, or ``torch.bfloat16`` tensors for 'bf16'."""
        return self.read_x(lo, hi), self.read_y(lo, hi)

    def _copy(self, a: np.ndarray):
        a = np.array(a)[..., None]  # one contiguous, writable copy
        if self.dtype_name == "bf16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return a

    def read_x(self, lo: int, hi: int):
        """Just the spec tiles (consumers that never touch the labels skip
        the label copy)."""
        return self._copy(self._x[lo:hi])

    def read_y(self, lo: int, hi: int):
        return self._copy(self._y[lo:hi])


def build_tile_cache(
    store,
    slices: Sequence,
    base: str,
    split: str,
    ps: PatchSpec = PatchSpec(),
    dtype: str = "f32",
    store_id: Optional[str] = None,
    chunk_tiles: int = 4096,
    verbose: bool = False,
) -> str:
    """One pass over ``store``: write the canonical tile stream of
    ``slices`` to ``<base>.<split>.tiles`` (+ fingerprint sidecar).
    Returns the binary path.  The sidecar is written last, so a file left
    by an interrupted build counts as absent."""
    from specenh_torch.train_stream import _chunk_plans, _read_chunk

    bin_path, meta_path = _paths(base, split)
    os.makedirs(os.path.dirname(os.path.abspath(bin_path)), exist_ok=True)
    if os.path.exists(meta_path):
        os.remove(meta_path)  # invalidate any previous build first
    n = sum(s.n_tiles for s in slices)
    plans = _chunk_plans(list(slices), chunk_tiles)
    dt = _words(dtype)
    pos = 0
    with open(bin_path, "wb") as fh:
        # the first chunk gives (F, W) for the header
        first = _read_chunk(store, plans[0], ps) if plans else None
        f = first[0].shape[1] if first is not None else ps.tile_freq
        w = ps.tile_time
        fh.write(_MAGIC)
        dname = dtype.encode()
        fh.write(struct.pack("<BQII", len(dname), n, f, w))
        fh.write(dname)
        off = fh.tell()
    count = n * f * w
    mx = np.memmap(bin_path, dtype=dt, mode="r+", offset=off, shape=(n, f, w)) \
        if n else None
    my = np.memmap(bin_path, dtype=dt, mode="r+",
                   offset=off + count * dt.itemsize, shape=(n, f, w)) \
        if n else None
    for j, plan in enumerate(plans):
        x, y = first if (j == 0 and first is not None) \
            else _read_chunk(store, plan, ps)
        k = len(x)
        mx[pos:pos + k] = _as_words(x[..., 0], dtype)
        my[pos:pos + k] = _as_words(y[..., 0], dtype)
        pos += k
        if verbose:
            print(f"tile-cache {split}: {pos}/{n} tiles", flush=True)
    if mx is not None:
        mx.flush()
        my.flush()
        del mx, my
    sid = store_id if store_id is not None else store_identity(store)
    with open(meta_path, "w") as fh:
        json.dump({"fingerprint": plan_fingerprint(sid, slices, ps, dtype),
                   "n": n, "f": f, "w": w, "dtype": dtype}, fh)
    return bin_path


def open_or_build(
    store,
    slices: Sequence,
    base: str,
    split: str,
    ps: PatchSpec = PatchSpec(),
    dtype: str = "f32",
    chunk_tiles: int = 4096,
    verbose: bool = False,
) -> "TileCacheReader":
    """Reader for ``slices``' canonical tile stream, building the cache
    first if absent/stale (the usual entry point: fit_streaming's
    train/tune/test readers and the CLI artifact stages)."""
    sid = store_identity(store)
    r = open_tile_cache(base, split, sid, slices, ps, dtype)
    if r is None:
        if verbose:
            print(f"building tile cache ({split}, {dtype}) at {base} ...")
        build_tile_cache(store, slices, base, split, ps, dtype,
                         store_id=sid, chunk_tiles=chunk_tiles)
        r = open_tile_cache(base, split, sid, slices, ps, dtype)
    return r


def open_tile_cache(
    base: str,
    split: str,
    store_id: str,
    slices: Sequence,
    ps: PatchSpec = PatchSpec(),
    dtype: str = "f32",
) -> Optional[TileCacheReader]:
    """The split's reader IF a complete cache with the matching
    fingerprint exists; None otherwise (caller builds)."""
    bin_path, meta_path = _paths(base, split)
    if not (os.path.exists(bin_path) and os.path.exists(meta_path)):
        return None
    try:
        with open(meta_path) as fh:
            meta = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if meta.get("fingerprint") != plan_fingerprint(store_id, slices, ps, dtype):
        return None
    return TileCacheReader(bin_path)
