"""The port's copies of the host IO (specenh_torch.io: shot readers, SPEC
binaries, the HDF5 store and manifest, the native reader) against the JAX
package's: the same files read alike, a store written by either package
reads in the other, the writer pool's sharded union, the manifest's
resume, and the native reader equal to the Python one."""

import os
import pickle

import h5py
import numpy as np
import pytest

from specenh.io import binfmt as jbinfmt
from specenh.io import shots as jshots
from specenh.io import store as jstore
from specenh_torch.io import binfmt, native, shots, store
from specenh_torch.io.native import NativePrefetcher, read_shot


def _write_ece_pkl(path, n_channels=3, n=30_000, seed=0):
    rng = np.random.default_rng(seed)
    data = {shots.ece_key(c + 1): rng.standard_normal(n).astype(np.float32)
            for c in range(n_channels)}
    with open(path, "wb") as fh:
        pickle.dump(data, fh)
    return data


def test_keys_and_shot_numbers_match_jax():
    for c in (1, 7, 12, 40):
        assert shots.ece_key(c) == jshots.ece_key(c) and shots.bes_key(c) == jshots.bes_key(c)
    for p in ("/a/b/ece_176053.pkl", "c/122117_BES.x", "ece_1.bin"):
        assert shots.shot_number_from_path(p) == jshots.shot_number_from_path(p)


def test_read_ece_channels_matches_jax(tmp_path):
    p = str(tmp_path / "ece_1.pkl")
    data = _write_ece_pkl(p)
    got = shots.read_ece_channels(p, [1, 3], n_samples=10_000)
    np.testing.assert_array_equal(got, jshots.read_ece_channels(p, [1, 3], n_samples=10_000))
    np.testing.assert_array_equal(got[1], data[shots.ece_key(3)][:10_000])


def test_read_bes_channels_matches_jax(tmp_path):
    p = str(tmp_path / "bes_5.pkl")
    rng = np.random.default_rng(2)
    data = {shots.bes_key(c): {"data.BES": rng.standard_normal(500 + c)} for c in (1, 2)}
    with open(p, "wb") as fh:
        pickle.dump(data, fh)
    got = shots.read_bes_channels(p, [1, 2])
    assert got.shape == (2, 501) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jshots.read_bes_channels(p, [1, 2]))


@pytest.mark.parametrize("kind", ["garbage", "empty", "missing-file", "missing-key"])
def test_unreadable_shot_raises_shot_read_error(tmp_path, kind):
    p = tmp_path / "ece_2.pkl"
    if kind == "garbage":
        p.write_bytes(b"not a pickle at all")
    elif kind == "empty":
        p.write_bytes(b"")
    elif kind == "missing-key":
        _write_ece_pkl(str(p), n_channels=2)
    chans = [99] if kind == "missing-key" else [1]
    with pytest.raises(shots.ShotReadError):
        shots.read_ece_channels(str(p), chans)
    with pytest.raises(jshots.ShotReadError):
        jshots.read_ece_channels(str(p), chans)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shot_bin_round_trip(tmp_path, writer):
    """A SPEC binary written by either package reads in both."""
    traces = np.random.default_rng(3).standard_normal((3, 1000)).astype(np.float32)
    p = str(tmp_path / "shot.bin")
    (binfmt if writer == "port" else jbinfmt).write_shot_bin(p, traces)
    np.testing.assert_array_equal(binfmt.read_shot_bin(p), traces)
    np.testing.assert_array_equal(jbinfmt.read_shot_bin(p), traces)
    assert open(p, "rb").read(4) == b"SPEC"


def test_shot_bin_rejects_garbage(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"x" * 64)
    with pytest.raises(ValueError):
        binfmt.read_shot_bin(str(p))
    with pytest.raises(ValueError):
        binfmt.write_shot_bin(str(p), np.zeros(4, np.float32))


def test_convert_ece_pickle(tmp_path):
    pkl = str(tmp_path / "ece_9.pkl")
    _write_ece_pkl(pkl, n_channels=3, n=2000)
    traces = binfmt.convert_ece_pickle(pkl, str(tmp_path / "ece_9.bin"), [1, 2, 3])
    np.testing.assert_array_equal(jbinfmt.read_shot_bin(str(tmp_path / "ece_9.bin")), traces)
    np.testing.assert_array_equal(traces, jshots.read_ece_channels(pkl, [1, 2, 3]))


def _records(rng, n_shots=3, n_ch=2, shape=(8, 12)):
    out = {}
    for s in range(n_shots):
        for c in range(1, n_ch + 1):
            out[(str(100 + s), c)] = (rng.random(shape).astype(np.float32),
                                     np.arange(shape[0], dtype=np.float64),
                                     np.arange(shape[1], dtype=np.float64) / 10,
                                     rng.random(shape).astype(np.float32))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_reads_across_packages(tmp_path, writer):
    """The reference schema ece_<shot>/chn_<n>/{spec,f,t,pipeline_out}:
    what one package writes, the other reads record for record."""
    path = str(tmp_path / "ds.hdf5")
    recs = _records(np.random.default_rng(4))
    w_mod, r_mod = (store, jstore) if writer == "port" else (jstore, store)
    with w_mod.SpectrogramStore(path) as st:
        for (shot, chn), r in recs.items():
            st.write_channel(shot, chn, *r)
        st.write_channel("100", 1, *recs[("100", 1)])  # idempotent overwrite
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["ece_100", "ece_101", "ece_102"]
        assert sorted(f["ece_100/chn_1"].keys()) == ["f", "pipeline_out", "spec", "t"]
    with r_mod.SpectrogramStore(path, "r") as st:
        assert st.shots() == ["ece_100", "ece_101", "ece_102"]
        assert list(st.iter_channels()) == [(f"ece_{s}", c) for s, c in recs]
        for (shot, chn), (spec, f, t, lab) in recs.items():
            d = st.read_channel(f"ece_{shot}", chn)
            for k, v in zip(("spec", "f", "t", "pipeline_out"), (spec, f, t, lab)):
                np.testing.assert_array_equal(d[k], v)
        x, y = st.read_spec_and_labels("ece_101", [1, 2])
        np.testing.assert_array_equal(x[1], recs[("101", 2)][0])
        np.testing.assert_array_equal(y[0], recs[("101", 1)][3])


def test_writer_pool_union_and_consolidate(tmp_path):
    """Two writer threads into the base file and a shard: the read view
    is one union, in both packages; consolidating folds it into one file."""
    path = str(tmp_path / "pool.hdf5")
    recs = _records(np.random.default_rng(5), n_shots=6, n_ch=1)
    pool = store.StoreWriterPool(path, writers=2)

    def handle(own, item):
        (shot, chn), r = item
        own.write_channel(shot, chn, *r)
        own.flush()

    pool.start(handle)
    with pool:
        for key, r in recs.items():
            pool.submit(key[0], (key, r))
        pool.join()
    pool.raise_if_failed()
    assert (tmp_path / "pool.hdf5.shard1").exists()
    assert {pool.shard_of(s) for s, _ in recs} == {0, 1}
    want = sorted(f"ece_{s}" for s, _ in recs)
    for mod in (store, jstore):
        with mod.SpectrogramStore(path, "r") as st:
            assert st.shots() == want
            np.testing.assert_array_equal(st.read_channel("ece_103", 1)["spec"],
                                          recs[("103", 1)][0])
    assert store.consolidate_shards(path) == 6 - sum(
        pool.shard_of(s) == 0 for s, _ in recs)
    assert not (tmp_path / "pool.hdf5.shard1").exists()
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == want


def test_manifest_resume(tmp_path):
    p = str(tmp_path / "m.jsonl")
    m = store.CampaignManifest(p)
    m.mark_done("100")
    m.mark_failed("101", "corrupt")
    m.close()
    for mod in (store, jstore):
        m2 = mod.CampaignManifest(p)
        assert m2.is_done("100") and not m2.is_done("101")
        assert m2.failed_shots == {"101"}
        assert "corrupt" in list(m2.failed.values())[0]
        m2.close()


def test_truncated_store_is_quarantined(tmp_path):
    path = str(tmp_path / "ds.hdf5")
    with store.SpectrogramStore(path) as st:
        st.write_channel("1", 1, *_records(np.random.default_rng(6), 1, 1)[("100", 1)])
    (tmp_path / "ds.hdf5.manifest.jsonl").write_text('{"shot": "1", "chn": null, "status": "done"}\n')
    os.truncate(path, 96)
    with pytest.raises(OSError):
        store.SpectrogramStore(path, "r")
    with pytest.warns(UserWarning, match="quarantined"):
        st = store.SpectrogramStore(path)
    store.retire_stale_manifest(st, path + ".manifest.jsonl")
    st.close()
    assert st.quarantined == path + ".corrupt"
    assert (tmp_path / "ds.hdf5.corrupt.manifest.jsonl").exists()
    assert not (tmp_path / "ds.hdf5.manifest.jsonl").exists()


def _bins(tmp_path, n=4, c=3, s=2048):
    out = {}
    for i in range(n):
        traces = np.random.default_rng(10 + i).standard_normal((c, s)).astype(np.float32)
        p = str(tmp_path / f"ece_{200 + i}.bin")
        binfmt.write_shot_bin(p, traces)
        out[p] = traces
    return out


def test_native_reader_matches_python(tmp_path):
    assert native.native_available(), "the native reader did not build (g++)"
    bins = _bins(tmp_path)
    for p, traces in bins.items():
        np.testing.assert_array_equal(read_shot(p, 3, 2048), binfmt.read_shot_bin(p))
        short = read_shot(p, 5, 1024)  # truncated and zero-padded, as the JAX reader
        np.testing.assert_array_equal(short[:3], traces[:, :1024])
        assert (short[3:] == 0).all()
    bad = tmp_path / "ece_299.bin"
    bad.write_bytes(b"x" * 64)
    paths = [*bins, str(bad)]
    seen = {}
    with NativePrefetcher(paths, n_channels=3, n_samples=2048, n_threads=3) as pf:
        for idx, traces in pf:
            seen[idx] = traces
    assert sorted(seen) == list(range(len(paths)))
    assert seen[len(paths) - 1] is None
    for i, p in enumerate(bins):
        np.testing.assert_array_equal(seen[i], bins[p])


def test_python_reader_without_the_library(tmp_path, monkeypatch):
    """Without the native library the prefetcher reads in Python, in order,
    with the same results and the same quarantine signal."""
    monkeypatch.setattr(native, "load_native", lambda build=True: None)
    bins = _bins(tmp_path, n=2)
    (tmp_path / "ece_299.bin").write_bytes(b"x" * 64)
    paths = [*bins, str(tmp_path / "ece_299.bin")]
    with NativePrefetcher(paths, 3, 2048) as pf:
        got = list(pf)
    assert [i for i, _ in got] == [0, 1, 2] and got[2][1] is None
    for (_, traces), want in zip(got, bins.values()):
        np.testing.assert_array_equal(traces, want)
