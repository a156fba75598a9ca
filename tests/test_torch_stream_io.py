"""The streamed trainer's host side against the JAX package, exactly: the
record readers (``data.grain_pipeline``), the chunk plans and chunk reads
(``train_stream._chunk_plans``, ``_iter_chunks``, ``_read_chunk``), and the
tile cache (``data.tilecache``), whose files the port writes byte for byte
as JAX does, in float32 and in bf16.  And the stale-cache hazard the port
does not copy: a store put in place with ``cp -p`` (same size, same mtime)
keeps JAX's store identity, so JAX serves the old tiles; the port's
identity also holds the inode and the ctime, so it rebuilds."""

import json
import os
import shutil

import numpy as np
import pytest

from specenh.config import PatchSpec as JPatchSpec, TrainConfig as JTrainConfig
from specenh.data import grain_pipeline as jgp
from specenh.data import tilecache as jtc
from specenh import train_stream as jts
from specenh_torch.config import PatchSpec, TrainConfig
from specenh_torch.data import grain_pipeline as tgp
from specenh_torch.data import tilecache as ttc
from specenh_torch import train_stream as tts
from specenh_torch.io.store import SpectrogramStore

PS, JPS = PatchSpec(32, 16, 16, 5), JPatchSpec(32, 16, 16, 5)


def _write(path, seed):
    rng = np.random.default_rng(seed)
    with SpectrogramStore(path) as st:
        for shot in ("101", "102", "103"):
            for chn in (1, 2):
                s = rng.random((32, 83)).astype(np.float32)
                st.write_channel(shot, chn, s, np.arange(32.0), np.arange(83.0), s * 0.5)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream_io") / "s.hdf5")
    _write(path, 7)
    st = SpectrogramStore(path, "r")
    yield st
    st.close()


def _equal(a, b):
    """Two streams of (x, y) pairs, equal in number, order and bits."""
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for (ax, ay), (bx, by) in zip(a, b):
        assert ax.dtype == bx.dtype == np.float32
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_record_readers_equal_jax(store):
    """channel_records, iter_record_slices (in a given order), tile_dataset
    (shuffled, sharded) and iter_tile_batches (shuffled, a short last
    batch) yield JAX's arrays."""
    assert tgp.channel_records(store) == jgp.channel_records(store)
    shots = store.shots()[1:]
    assert tgp.channel_records(store, shots) == jgp.channel_records(store, shots)
    plan = tts.plan_stream_split(store, num_samples=3, ps=PS, seed=3)
    order = np.random.default_rng(0).permutation(len(plan.train))
    _equal(tgp.iter_record_slices(store, plan.train, PS, order),
           jgp.iter_record_slices(store, plan.train, JPS, order))
    for kw in (dict(seed=4), dict(seed=1, shard_index=1, shard_count=2)):
        _equal(tgp.tile_dataset(store, ps=PS, **kw), jgp.tile_dataset(store, ps=JPS, **kw))
    _equal(tgp.iter_tile_batches(store, 7, ps=PS, seed=2),
           jgp.iter_tile_batches(store, 7, ps=JPS, seed=2))


@pytest.mark.parametrize("chunk_tiles", [4, 8, 1000])
def test_chunk_plans_and_reads_equal_jax(store, chunk_tiles):
    """The canonical chunk plans of each split, every chunk read from them,
    and the record-order chunks of ``cache='never'`` are JAX's."""
    cfg = TrainConfig(seed=1)
    plan = tts.plan_stream_split(store, num_samples=3, ps=PS, cfg=cfg, seed=3)
    jplan = jts.plan_stream_split(store, num_samples=3, ps=JPS, cfg=JTrainConfig(seed=1),
                                  seed=3)
    for split in ("train", "tune", "test"):
        slices = getattr(plan, split)
        assert [tuple(vars(s).values()) for s in slices] == \
            [tuple(vars(s).values()) for s in getattr(jplan, split)]
        plans = tts._chunk_plans(slices, chunk_tiles)
        jplans = jts._chunk_plans(getattr(jplan, split), chunk_tiles)
        assert [[tuple(vars(s).values()) for s in p] for p in plans] == \
            [[tuple(vars(s).values()) for s in p] for p in jplans]
        _equal((tts._read_chunk(store, p, PS) for p in plans),
               (jts._read_chunk(store, p, JPS) for p in jplans))
        order = np.random.default_rng(chunk_tiles).permutation(len(slices))
        _equal(tts._iter_chunks(store, slices, PS, chunk_tiles, order),
               jts._iter_chunks(store, getattr(jplan, split), JPS, chunk_tiles, order))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tile_cache_bytes_equal_jax(store, tmp_path, dtype):
    """For one plan and store identity, the port's ``.tiles`` file is JAX's
    byte for byte and so is its sidecar; the readers give the same tiles
    (the port's bf16 as ``torch.bfloat16``); a changed plan or dtype, or a
    missing sidecar, reads as absent."""
    plan = tts.plan_stream_split(store, num_samples=3, ps=PS, cfg=TrainConfig(seed=1), seed=3)
    sid = "store-id"
    for mod, ps, tag in ((ttc, PS, "t"), (jtc, JPS, "j")):
        mod.build_tile_cache(store, plan.train, str(tmp_path / tag), "train", ps, dtype,
                             store_id=sid, chunk_tiles=4)
    for ext in ("tiles", "json"):
        assert (tmp_path / f"t.train.{ext}").read_bytes() == \
            (tmp_path / f"j.train.{ext}").read_bytes(), ext
    r = ttc.open_tile_cache(str(tmp_path / "t"), "train", sid, plan.train, PS, dtype)
    jr = jtc.open_tile_cache(str(tmp_path / "j"), "train", sid, plan.train, JPS, dtype)
    assert (r.n, r.f, r.w, r.dtype_name) == (jr.n, jr.f, jr.w, jr.dtype_name) == \
        (plan.n_tiles("train"), 32, 16, dtype)
    for got, want in zip(r.read(3, 11), jr.read(3, 11)):
        got = got.float().numpy() if dtype == "bf16" else got
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    other = "bf16" if dtype == "f32" else "f32"
    base = str(tmp_path / "t")
    assert ttc.open_tile_cache(base, "train", sid, plan.train, PS, other) is None
    assert ttc.open_tile_cache(base, "train", sid, plan.train[:-1], PS, dtype) is None
    os.remove(base + ".train.json")
    assert ttc.open_tile_cache(base, "train", sid, plan.train, PS, dtype) is None


def test_stale_cache_after_cp_p_rebuilds(tmp_path):
    """A second store of the same shapes and size, given the first one's
    mtime and copied over it with ``shutil.copy2`` (``cp -p``): JAX's
    ``store_identity`` does not change and its ``open_or_build`` serves
    the old tiles; the port's identity changes (inode, ctime), so its
    ``open_or_build`` rebuilds from the new store."""
    path, other = str(tmp_path / "s.hdf5"), str(tmp_path / "other.hdf5")
    _write(path, 7)
    _write(other, 8)
    assert os.path.getsize(path) == os.path.getsize(other)
    st = os.stat(path)
    os.utime(other, ns=(st.st_atime_ns, st.st_mtime_ns))
    with SpectrogramStore(path, "r") as s:
        plan = tts.plan_stream_split(s, num_samples=3, ps=PS, seed=3)
    readers = {}
    for tag, mod, ps in (("t", ttc, PS), ("j", jtc, JPS)):
        with SpectrogramStore(path, "r") as s:
            readers[tag] = [mod.store_identity(s)]
            mod.open_or_build(s, plan.train, str(tmp_path / tag), "train", ps, "f32")
    shutil.copy2(other, path)  # cp -p: the other store's bytes, the same size and mtime
    with SpectrogramStore(path, "r") as s:
        fresh = tts._read_chunk(s, plan.train, PS)[0]
        for tag, mod, ps in (("t", ttc, PS), ("j", jtc, JPS)):
            readers[tag].append(mod.store_identity(s))
            r = mod.open_or_build(s, plan.train, str(tmp_path / tag), "train", ps, "f32")
            readers[tag].append(np.asarray(r.read_x(0, r.n), np.float32))
    j_before, j_after, j_tiles = readers["j"]
    t_before, t_after, t_tiles = readers["t"]
    assert j_before == j_after and not np.array_equal(j_tiles, fresh)  # JAX: stale
    assert t_before != t_after  # the port: a new identity ...
    np.testing.assert_array_equal(t_tiles, fresh)  # ... and the new store's tiles
    with open(tmp_path / "t.train.json") as fh, open(tmp_path / "j.train.json") as jfh:
        assert json.load(fh)["fingerprint"] != json.load(jfh)["fingerprint"]
