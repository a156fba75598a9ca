"""The port's dataset build (specenh_torch.pipeline, data.dataset on the
CPU) against the JAX package's: ``process_shot_fn``, the ``build_dataset``
campaign (quarantine, resume, a truncated store), the streaming campaign
over SPEC binaries with one and two writers, and ``assemble_from_store``
from the same store and seed."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from specenh.config import Config as JConfig
from specenh.config import SpecParams as JSpecParams
from specenh.config import TrainConfig as JTrainConfig
from specenh.data.dataset import assemble_from_store as jassemble
from specenh.ops.enhance import pipeline_stages as jstages
from specenh.pipeline import build_dataset as jbuild
from specenh.pipeline import process_shot_fn as jprocess
from specenh.io.store import SpectrogramStore as JStore
from specenh_torch.config import Config, SpecParams, TrainConfig
from specenh_torch.data.dataset import assemble_from_store
from specenh_torch.io.binfmt import write_shot_bin
from specenh_torch.io.shots import ece_key
from specenh_torch.io.store import SpectrogramStore
from specenh_torch.ops.enhance import pipeline_stages
from specenh_torch.ops.stft import spectrogram_freqs, spectrogram_times
from specenh_torch.pipeline import build_dataset, build_dataset_streaming, process_shot_fn
from tests.test_torch_enhance import _assert_composed_matches

SP = SpecParams(cut_shot=0.05)  # 25k samples -> 256 x 96
CFG = Config(spec=SP)
JCFG = JConfig(spec=JSpecParams(cut_shot=0.05))
# the campaigns: 35k samples -> 256 x 135, one training tile a channel
CSP = SpecParams(cut_shot=0.07)
CCFG = Config(spec=CSP)
JCCFG = JConfig(spec=JSpecParams(cut_shot=0.07))
SHOTS = ("111", "222")


def _traces(seed, n_channels=2, sp=CSP):
    return np.random.default_rng(seed).standard_normal(
        (n_channels, sp.n_samples)).astype(np.float32)


def _labels_match_jax(specs, labels):
    """``labels`` are the port's pipeline on ``specs``; JAX's pipeline on
    the same specs agrees (up to the row-mean uint8 flips)."""
    s = torch.as_tensor(specs)
    got = pipeline_stages(s)
    np.testing.assert_array_equal(np.asarray(labels), got["final"].numpy())
    _assert_composed_matches(got, jstages(jnp.asarray(s.numpy())))


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """Two readable ECE pickles and a corrupt one, and JAX's store of them."""
    d = tmp_path_factory.mktemp("campaign")
    files = []
    for i, shot in enumerate(SHOTS):
        p = str(d / f"ece_{shot}.pkl")
        with open(p, "wb") as fh:
            pickle.dump({ece_key(c + 1): t for c, t in enumerate(_traces(i))}, fh)
        files.append(p)
    bad = d / "ece_333.pkl"
    bad.write_bytes(b"garbage")
    files.append(str(bad))
    summary = jbuild(JCCFG, files, channels=[1, 2], store_path=str(d / "jax.hdf5"),
                     verbose=False)
    assert summary == {"done": 2, "skipped": 0, "failed": 1}
    return d, files


def test_process_shot_fn_matches_jax():
    x = _traces(0, sp=SP)
    specs, labels = process_shot_fn(CFG, device="cpu")(x)
    assert specs.shape == labels.shape == (2, 256, SP.n_frames)
    assert specs.device.type == labels.device.type == "cpu"
    jspecs, _ = jprocess(JCFG)(jnp.asarray(x))
    np.testing.assert_allclose(specs.numpy(), np.asarray(jspecs), rtol=0, atol=1e-4)
    _labels_match_jax(specs, labels)
    specs_t, labels_t = process_shot_fn(CFG, device="cpu")(torch.from_numpy(x))
    assert torch.equal(specs_t, specs) and torch.equal(labels_t, labels)


def test_process_shot_fn_other_geometry_takes_the_matmul_front():
    """nperseg 256 is no geometry of K1: the plain STFT computes the specs."""
    cfg = Config(spec=SpecParams(nperseg=256, noverlap=128, cut_shot=0.05))
    specs, labels = process_shot_fn(cfg, device="cpu")(_traces(1, sp=cfg.spec))
    assert specs.shape == labels.shape == (2, 128, cfg.spec.n_frames)
    assert bool(torch.isfinite(labels).all())


def test_process_shot_fn_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CUDA path runs instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process_shot_fn(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_dataset(CFG, [], store_path="unused.hdf5")


def _check_store_against_jax(port_path, jax_path, channels=(1, 2)):
    with SpectrogramStore(port_path, "r") as st, JStore(jax_path, "r") as js:
        assert st.shots() == js.shots()
        for shot in st.shots():
            assert st.channels_of(shot) == list(channels)
            for chn in channels:
                got, want = st.read_channel(shot, chn), js.read_channel(shot, chn)
                np.testing.assert_allclose(got["spec"], want["spec"], rtol=0, atol=1e-4)
                np.testing.assert_array_equal(got["f"], want["f"])
                np.testing.assert_array_equal(got["t"], want["t"])
                np.testing.assert_array_equal(got["f"], spectrogram_freqs(CSP))
                np.testing.assert_array_equal(got["t"], spectrogram_times(CSP))
                _labels_match_jax(got["spec"], got["pipeline_out"])


def test_build_dataset_campaign(campaign):
    """The campaign's summaries, as JAX's (tests/test_io.py): quarantine,
    resume, and a truncated store quarantined with its manifest; the store
    against JAX's store of the same pickles."""
    d, files = campaign
    store_path = str(d / "port.hdf5")
    kw = dict(channels=[1, 2], store_path=store_path, verbose=False, device="cpu")
    assert build_dataset(CCFG, files, **kw) == {"done": 2, "skipped": 0, "failed": 1}
    _check_store_against_jax(store_path, str(d / "jax.hdf5"))
    assert build_dataset(CCFG, files, **kw) == {"done": 0, "skipped": 3, "failed": 0}
    os.truncate(store_path, 96)
    with pytest.warns(UserWarning, match="quarantined"):
        assert build_dataset(CCFG, files, **kw) == {"done": 2, "skipped": 0, "failed": 1}
    assert os.path.exists(store_path + ".corrupt")
    assert os.path.exists(store_path + ".corrupt.manifest.jsonl")
    _check_store_against_jax(store_path, str(d / "jax.hdf5"))


@pytest.mark.parametrize("writers", [1, 2])
def test_build_dataset_streaming(campaign, tmp_path, writers):
    """SPEC binaries of the same traces through the prefetcher: the store
    equals the pickle campaign's bit for bit; an unreadable binary is
    quarantined; a resume skips everything."""
    d, _ = campaign
    bins = []
    for i, shot in enumerate(SHOTS):
        bins.append(str(tmp_path / f"ece_{shot}.bin"))
        write_shot_bin(bins[-1], _traces(i))
    (tmp_path / "ece_333.bin").write_bytes(b"x" * 64)
    bins.append(str(tmp_path / "ece_333.bin"))
    path = str(tmp_path / "stream.hdf5")
    kw = dict(store_path=path, writers=writers, verbose=False, device="cpu")
    assert build_dataset_streaming(CCFG, bins, 2, **kw) == {"done": 2, "skipped": 0, "failed": 1}
    assert os.path.exists(path + ".shard1") == (writers == 2)
    assert build_dataset_streaming(CCFG, bins, 2, **kw) == {"done": 0, "skipped": 3, "failed": 0}
    in_memory = str(tmp_path / "mem.hdf5")
    build_dataset(CCFG, [p.replace(".bin", ".pkl").replace(str(tmp_path), str(d))
                        for p in bins[:2]],
                  channels=[1, 2], store_path=in_memory, verbose=False, device="cpu")
    with SpectrogramStore(path, "r") as st, SpectrogramStore(in_memory, "r") as mem:
        assert st.shots() == mem.shots() == ["ece_111", "ece_222"]
        for shot, chn in mem.iter_channels():
            a, b = st.read_channel(shot, chn), mem.read_channel(shot, chn)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _random_store(path, n_shots=5, n_ch=2, shape=(256, 300)):
    rng = np.random.default_rng(7)
    with SpectrogramStore(path) as st:
        for s in range(n_shots):
            for c in range(1, n_ch + 1):
                st.write_channel(str(1000 + s), c, rng.random(shape).astype(np.float32),
                                 np.arange(shape[0]), np.arange(shape[1]),
                                 rng.random(shape).astype(np.float32))


@pytest.mark.parametrize("split_by", ["tile", "shot"])
def test_assemble_from_store_matches_jax(tmp_path, split_by):
    path = str(tmp_path / "ds.hdf5")
    _random_store(path)
    with SpectrogramStore(path, "r") as st, JStore(path, "r") as js:
        for num, chans in ((4, None), (9, [2])):
            got = assemble_from_store(st, num, chans, cfg=TrainConfig(split_by=split_by), seed=3)
            want = jassemble(js, num, chans, cfg=JTrainConfig(split_by=split_by), seed=3)
            for k in ("x_train", "x_tune", "x_test", "y_train", "y_tune", "y_test"):
                a, b = getattr(got, k), getattr(want, k)
                assert a.dtype == b.dtype == np.float32 and a.shape[1:] == (256, 128)
                np.testing.assert_array_equal(a, b, err_msg=k)
            assert len(got.x_train) > 0 and len(got.x_tune) > 0


def test_assemble_from_store_too_few_shots_for_a_shot_split(tmp_path):
    path = str(tmp_path / "ds.hdf5")
    _random_store(path, n_shots=2)
    with SpectrogramStore(path, "r") as st:
        with pytest.raises(ValueError, match="too few"):
            assemble_from_store(st, 2, cfg=TrainConfig(split_by="shot"), seed=0)


def test_slice_from_pickles_to_training_tiles(campaign):
    """The whole slice: the port's campaign store -> assemble_from_store,
    against the JAX package's store -> its assemble_from_store, same seed:
    the same tiles in the same order, specs within 1e-4, labels as the
    pipeline's comparison allows."""
    d, files = campaign
    path = str(d / "slice.hdf5")
    build_dataset(CCFG, files, channels=[1, 2], store_path=path, verbose=False, device="cpu")
    cfg = TrainConfig(split_fracs=(0.5, 0.75))
    with SpectrogramStore(path, "r") as st, JStore(str(d / "jax.hdf5"), "r") as js:
        got = assemble_from_store(st, 2, cfg=cfg, seed=1)
        want = jassemble(js, 2, cfg=JTrainConfig(split_fracs=(0.5, 0.75)), seed=1)
    assert len(got.x_train) == len(want.x_train) > 0
    for k in ("x_train", "x_tune", "x_test"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=1e-4)
    for k in ("y_train", "y_tune", "y_test"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and float(np.abs(a - b).max()) <= 2 / 255
