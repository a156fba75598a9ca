"""The port's streamed trainer (``specenh_torch.train_stream.fit_streaming``)
and streamed sweep (``sweep.sweep_fit_serial_streamed``) against the JAX
package on the CPU, on the JAX streaming tests' fixture: 3 shots x 2
channels of (32, 83), ``PatchSpec(32, 16, 16, 5)`` (5 tiles a channel, 30
in all: 18 train, 7 tune, 5 test), a (4, 4) model on the module engine
from the same Flax-initialised weights, batch 4, chunks of 8.

- Against JAX's ``fit_streaming``, rtol 1e-4 (``tests/test_torch_train.py``'s
  bound: float32 sums in other orders through a dozen Adam steps), one case
  per mode: the cache shuffled, ``cache='never'``, bf16 chunks, the tile
  cache, a partial cache budget, a resume, early stopping.
- The identity contract, bit for bit: with ``shuffle=False`` and
  ``chunk_tiles >= n`` the streamed trajectory is the resident ``fit``'s,
  and the streamed sweep is the resident ``sweep_fit_serial``'s, its
  configs after the first reading no store data through the tile cache.
- On the training kernels' plain twins at 256 x 128 (4 tiles): bf16 chunks
  give the float32 chunks' step bit for bit, and streamed equals resident.
"""

import json
import os

import numpy as np
import pytest
import threadpoolctl
import torch

from specenh import train as jtrain
from specenh import train_stream as jts
from specenh.config import ModelConfig as JModelConfig, PatchSpec as JPatchSpec
from specenh.config import TrainConfig as JTrainConfig
from specenh_torch import ModelConfig, TrainConfig
from specenh_torch import sweep as tsweep
from specenh_torch import train as ttrain
from specenh_torch import train_stream as tts
from specenh_torch.config import PatchSpec
from specenh_torch.io.store import SpectrogramStore
from specenh_torch.models.convert import state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS thread in this module: the suite runs a worker
    per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


PS, JPS = PatchSpec(32, 16, 16, 5), JPatchSpec(32, 16, 16, 5)
TINY = dict(filters=(4, 4), kernels=((3, 3), (3, 3)), input_shape=(32, 16, 1))


def _write(path, seed=7, width=83, freq=32, shots=("101", "102", "103")):
    rng = np.random.default_rng(seed)
    with SpectrogramStore(path) as st:
        for shot in shots:
            for chn in (1, 2):
                s = rng.random((freq, width)).astype(np.float32)
                st.write_channel(shot, chn, s, np.arange(float(freq)), np.arange(float(width)),
                                 s * 0.5)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The JAX streaming tests' store, written by the port (the same
    schema), read by both packages."""
    path = str(tmp_path_factory.mktemp("stream") / "s.hdf5")
    _write(path)
    st = SpectrogramStore(path, "r")
    yield st
    st.close()


def _cfgs(**kw):
    base = dict(epochs=3, seed=1, shuffle=True, batch_size=4)
    base.update(kw)
    return JTrainConfig(**base), TrainConfig(**base)


def _plans(store, jc, tc):
    return (jts.plan_stream_split(store, num_samples=3, ps=JPS, cfg=jc, seed=3),
            tts.plan_stream_split(store, num_samples=3, ps=PS, cfg=tc, seed=3))


def _states(jc, tc):
    """JAX's initial state and the port's from the same weights."""
    js = jtrain.create_state(JModelConfig(**TINY), jc)
    st = ttrain.create_state(ModelConfig(**TINY), tc, device="cpu")
    st.model.load_state_dict(state_dict_from_flax(js.params, ModelConfig(**TINY)))
    return js, st


def _assert_close(th, jh):
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    np.testing.assert_allclose(th["val_loss"], jh["val_loss"], rtol=1e-4)
    assert th["new_epochs"] == jh["new_epochs"]
    assert th.get("stopped_epoch") == jh.get("stopped_epoch")


# mode -> (TrainConfig overrides, fit_streaming keywords)
MODES = {
    "cache-auto-shuffled": ({}, {}),
    "cache-never": ({}, dict(cache="never")),
    "bf16-chunks": ({}, dict(cache_dtype="bf16")),
    "tile-cache": ({}, dict(tile_cache="TC")),
    "partial-budget": ({}, dict(cache="auto")),
    "early-stop": (dict(epochs=8, learning_rate=0.0, patience=1), {}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fit_streaming_matches_jax(store, tmp_path, monkeypatch, mode):
    """Each mode's loss and val_loss per epoch within rtol 1e-4 of JAX's:
    the same chunk composition, chunk order and tile order (the
    default_rng([seed, epoch]) stream), the same Adam.  The partial budget
    keeps one chunk of the three in RAM (the others are read every
    epoch); early stopping (lr 0: every epoch after the first is stale)
    stops both at epoch 1."""
    over, kw = MODES[mode]
    jc, tc = _cfgs(**over)
    jplan, tplan = _plans(store, jc, tc)
    if mode == "partial-budget":
        monkeypatch.setenv("SPECENH_STREAM_CACHE_GB", str(1.5 * 2 * 8 * 32 * 16 * 4 / 2**30))
    js, st = _states(jc, tc)
    jkw = {**kw, "tile_cache": str(tmp_path / "j")} if "tile_cache" in kw else kw
    tkw = {**kw, "tile_cache": str(tmp_path / "t")} if "tile_cache" in kw else kw
    _, jh = jts.fit_streaming(js, store, jplan, jc, chunk_tiles=8, ps=JPS, **jkw)
    _, th = tts.fit_streaming(st, store, tplan, tc, chunk_tiles=8, ps=PS, **tkw)
    _assert_close(th, jh)
    if mode == "early-stop":
        assert th["stopped_epoch"] == 1 and len(th["loss"]) == 2


def test_fit_streaming_resume_matches_jax(store, tmp_path):
    """Two epochs, a checkpoint, then a resume to four: the port's resumed
    history is its uninterrupted run's bit for bit and JAX's uninterrupted
    run's to rtol 1e-4; run_meta.json carries 'streamed', 'chunk_tiles'
    and 'devices', as JAX's."""
    jc, tc = _cfgs(epochs=4, seed=2)
    jplan, tplan = _plans(store, jc, tc)
    js, _ = _states(jc, tc)
    _, jh = jts.fit_streaming(js, store, jplan, jc, chunk_tiles=8, ps=JPS)
    _, full = tts.fit_streaming(_states(jc, tc)[1], store, tplan, tc, chunk_tiles=8, ps=PS)
    ck = str(tmp_path / "ck")
    tts.fit_streaming(_states(jc, tc)[1], store, tplan, tc, epochs=2, chunk_tiles=8, ps=PS,
                      checkpoint_dir=ck)
    st, res = tts.fit_streaming(_states(jc, tc)[1], store, tplan, tc, chunk_tiles=8, ps=PS,
                                checkpoint_dir=ck, resume=True)
    assert res["loss"] == full["loss"] and res["val_loss"] == full["val_loss"]
    assert res["new_epochs"] == 2
    _assert_close(full, jh)
    with open(os.path.join(ck, "run_meta.json")) as fh:
        meta = json.load(fh)
    assert meta == {"n": 18, "seed": 2, "batch_size": 4, "shuffle": True, "chunk_tiles": 8,
                    "streamed": True, "devices": 1}


def _resident(store, plan, split):
    return tts._read_chunk(store, getattr(plan, split), PS)


def test_streamed_equals_resident_fit(store, tmp_path):
    """shuffle=False, chunk_tiles >= n: the streamed fit is the resident
    fit, losses and parameters bit for bit; the metrics lines carry JAX's
    keys."""
    _, tc = _cfgs(shuffle=False)
    _, tplan = _plans(store, *_cfgs(shuffle=False))
    x, y = _resident(store, tplan, "train")
    xv, yv = _resident(store, tplan, "tune")
    s1, h1 = ttrain.fit(_states(*_cfgs(shuffle=False))[1], x, y, xv, yv, cfg=tc)
    mp = str(tmp_path / "m.jsonl")
    s2, h2 = tts.fit_streaming(_states(*_cfgs(shuffle=False))[1], store, tplan, tc,
                               chunk_tiles=10_000, ps=PS, metrics_path=mp)
    assert h1["loss"] == h2["loss"] and h1["val_loss"] == h2["val_loss"]
    for a, b in zip(s1.model.state_dict().values(), s2.model.state_dict().values()):
        assert torch.equal(a, b)
    with open(mp) as fh:
        lines = [json.loads(ln) for ln in fh]
    assert [sorted(ln) for ln in lines] == [["devices", "epoch", "loss", "sec", "streamed",
                                             "val_loss"]] * 3
    assert all(ln["streamed"] is True and ln["devices"] == 1 for ln in lines)


def test_streamed_sweep_equals_resident_sweep(store, tmp_path, monkeypatch):
    """shuffle=False, chunk_tiles >= n: ``sweep_fit_serial_streamed`` with
    a tile cache gives ``sweep_fit_serial``'s histories and parameters per
    config bit for bit; the store is read once, by the first config's
    tile-cache build (configs 2.. read none)."""
    _, tc = _cfgs(shuffle=False, epochs=2)
    _, tplan = _plans(store, *_cfgs(shuffle=False))
    configs = [ModelConfig(**TINY), ModelConfig(**{**TINY, "filters": (8, 4)})]
    x, y = _resident(store, tplan, "train")
    xv, yv = _resident(store, tplan, "tune")
    ref = tsweep.sweep_fit_serial(configs, x, y, xv, yv, tc, device="cpu")
    reads = []
    orig = SpectrogramStore.read_column_slice
    monkeypatch.setattr(SpectrogramStore, "read_column_slice",
                        lambda self, *a: reads.append(a) or orig(self, *a))
    got = tsweep.sweep_fit_serial_streamed(configs, store, tplan, tc, chunk_tiles=10_000,
                                           ps=PS, tile_cache=str(tmp_path / "tc"),
                                           device="cpu")
    one_pass = sum(len(p) for split in (tplan.train, tplan.tune)
                   for p in tts._chunk_plans(split, 4096))
    assert len(reads) == one_pass
    np.testing.assert_array_equal(got.train_history, ref.train_history)
    np.testing.assert_array_equal(got.val_history, ref.val_history)
    assert got.best_index == ref.best_index
    for k, v in ref.stacked_params.items():
        assert torch.equal(got.stacked_params[k], v), k


def test_mesh_and_bad_arguments_raise(store):
    """A ``mesh`` whose rank's device is not the state's raises before any
    collective, and the envelope refuses a mesh not over its "sweep" axis
    (the meshes train in ``tests/test_torch_mesh_train.py``); the JAX
    package's argument checks, with its words."""
    from specenh_torch.parallel.mesh import Mesh

    jc, tc = _cfgs()
    _, tplan = _plans(store, jc, tc)
    st = _states(jc, tc)[1]
    away = Mesh(None, 0, 2, ("data",), torch.device("meta"), "gloo")
    with pytest.raises(ValueError, match="this rank's device is meta"):
        tts.fit_streaming(st, store, tplan, tc, mesh=away)
    x = np.zeros((4, 32, 16, 1), np.float32)
    with pytest.raises(ValueError, match="over a 'sweep' mesh, not \\('data',\\)"):
        tsweep.sweep_fit([ModelConfig(**TINY)], x, x, x, x, tc, mesh=away)
    with pytest.raises(ValueError, match="cache must be"):
        tts.fit_streaming(st, store, tplan, tc, cache="sometimes")
    with pytest.raises(ValueError, match="canonical chunk composition"):
        tts.fit_streaming(st, store, tplan, tc, cache="never", tile_cache="x")


# ---------------------------------------------------------------------------
# the training kernels' twins at full width
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """1 shot x 2 channels of (256, 2 x 128 + 3): 4 tiles, split 2/1/1."""
    path = str(tmp_path_factory.mktemp("wide") / "w.hdf5")
    _write(path, seed=5, width=259, freq=256, shots=("101",))
    st = SpectrogramStore(path, "r")
    yield st
    st.close()


def test_kernel_twins_bf16_chunks_equal_f32_chunks(wide):
    """On the kernel engine (K5's plain twins here) a streamed epoch from
    float32 chunks is the resident fit's bit for bit, and one from bf16
    chunks trains to the same losses and parameters bit for bit (the
    kernels round their tile operands to bf16 as they load them).  Only
    val_loss moves: the validation pass is the float32 module on the
    bf16-rounded tune tiles."""
    cfg = ModelConfig()
    tc = TrainConfig(epochs=1, seed=0, shuffle=False, batch_size=2)
    plan = tts.plan_stream_split(wide, num_samples=1, cfg=tc, seed=0)
    assert (plan.n_tiles("train"), plan.n_tiles("tune")) == (2, 1)
    x, y = tts._read_chunk(wide, plan.train, PatchSpec())
    xv, yv = tts._read_chunk(wide, plan.tune, PatchSpec())

    def state():
        return ttrain.create_state(cfg, tc, generator=torch.Generator().manual_seed(0),
                                   device="cpu")

    s0, h0 = ttrain.fit(state(), x, y, xv, yv, cfg=tc, epoch_fn=ttrain.kernel_epoch_for(cfg, tc))
    for tag in ("f32", "bf16"):
        s, h = tts.fit_streaming(state(), wide, plan, tc, ps=PatchSpec(), cache_dtype=tag,
                                 epoch_fn=ttrain.kernel_epoch_for(cfg, tc))
        assert h["loss"] == h0["loss"], tag
        for a, b in zip(s.model.state_dict().values(), s0.model.state_dict().values()):
            assert torch.equal(a, b), tag
        if tag == "f32":
            assert h["val_loss"] == h0["val_loss"]
        else:
            assert h["val_loss"] != h0["val_loss"]
            assert h["val_loss"] == pytest.approx(h0["val_loss"], rel=1e-3)
