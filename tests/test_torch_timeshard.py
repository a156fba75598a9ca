"""The port's time-sharded long-shot path (``specenh_torch.parallel.timeshard``)
on the CPU, against the JAX package's on its 8-device ``("time",)`` mesh of
the conftest's virtual devices.

The port's 8 shards run in one process on the lock-step thread exchange of
``tests/_torch_exchange.py``; the cases and tolerances are JAX's own
(``tests/test_parallel.py``): the sharded spectrogram at 5e-5 with its
duplicated tail equal (hop 256 and 128), the sharded pipeline at 1e-5
(uint8 and float blur, one and two channels), the composed shot at
``cut_shot=0.6`` (one tile a shard) in float32 against JAX's Flax program
at 1e-5 and in bf16 at max 5e-2 / mean 2e-3, the guards with JAX's words.
A world of one over a gloo group is the port's unsharded ``spectrogram``,
``classical_pipeline`` and ``ae_kernel_enhance_specs`` bit for bit; eight
shards are the unsharded pipeline within JAX's 1e-5."""

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

from specenh.config import ModelConfig as JModelConfig, PipelineConfig as JPipelineConfig
from specenh.config import SpecParams as JSpecParams
from specenh.models.autoencoder import make_model as flax_model
from specenh.ops.stft import spectrogram as jspectrogram
from specenh.parallel import timeshard as jts
from specenh.parallel.mesh import make_mesh as jmake_mesh
from specenh_torch.config import ModelConfig, PipelineConfig, SpecParams
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel
from specenh_torch.ops.enhance import classical_pipeline
from specenh_torch.ops.stft import spectrogram
from specenh_torch.parallel import timeshard as tts
from specenh_torch.parallel.mesh import make_mesh
from tests._torch_exchange import run_shards
from tests.conftest import synth_trace

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

N = 8
SHOT = JSpecParams(cut_shot=0.6)
T_SHOT = jts.usable_samples_tiled(SHOT.n_samples, N, SHOT)  # 262 144: one tile a shard


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch and one BLAS thread in this module: the suite runs a worker
    per core, and the shards run on threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tmesh8():
    return jmake_mesh(N, ("time",))


def _shards(fn, x, n=N):
    """``fn(ex, block)`` on n thread shards of ``x``'s last axis, the
    outputs (one tensor or a tuple) concatenated along their last axis."""
    outs = run_shards(n, lambda ex: fn(ex, tts.shard_of(ex, torch.from_numpy(x))))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[i] for o in outs], -1).numpy() for i in range(len(outs[0])))
    return torch.cat(outs, -1).numpy()


@pytest.mark.parametrize("noverlap,seed", [(256, 5), (384, 8)], ids=["hop256", "hop128"])
def test_sharded_spectrogram_matches_jax(tmesh8, noverlap, seed):
    """8 shards of a ``cut_shot=0.2`` trace (98 304 samples at hop 256, 48
    frames a shard): JAX's sharded spectrogram and its unsharded one on the
    first n_frames columns within 5e-5; the last rank's r - 1 dataless
    frames (1 at hop 256, 3 at hop 128) equal the last valid one."""
    jsp = JSpecParams(cut_shot=0.2, noverlap=noverlap)
    sp = SpecParams(cut_shot=0.2, noverlap=noverlap)
    x = synth_trace(JSpecParams(cut_shot=0.2), seed=seed)
    x = x[: jts.usable_samples(jsp.n_samples, N, jsp)]
    assert tts.usable_samples(sp.n_samples, N, sp) == x.size
    got = _shards(lambda ex, b: tts.sharded_spectrogram(b, sp, ex), x)
    jgot = np.asarray(jts.sharded_spectrogram(jnp.asarray(x), jsp, tmesh8))
    want = np.asarray(jspectrogram(jnp.asarray(x), JSpecParams(cut_shot=x.size / jsp.fs,
                                                                noverlap=noverlap)))
    r = sp.nperseg // sp.hop
    nf = want.shape[-1]
    assert got.shape == jgot.shape == (256, nf + r - 1)
    np.testing.assert_allclose(got, jgot, atol=5e-5)
    np.testing.assert_allclose(got[..., :nf], want, atol=5e-5)
    for j in range(1, r):
        np.testing.assert_array_equal(got[..., -j], got[..., -r])


@pytest.mark.parametrize("seed,channels,emulate", [(6, None, True), (7, 2, True), (9, None, False)],
                         ids=["uint8", "uint8-2ch", "float"])
def test_sharded_enhance_matches_jax(tmesh8, seed, channels, emulate):
    """The label pipeline on 8 shards of JAX's sharded spectrogram: JAX's
    sharded pipeline within 1e-5, and the port's unsharded
    ``classical_pipeline`` within 1e-5."""
    jsp = JSpecParams(cut_shot=0.2)
    x = synth_trace(jsp, seed=seed, n_channels=channels)
    x = x[..., : jts.usable_samples(jsp.n_samples, N, jsp)]
    spec = jts.sharded_spectrogram(jnp.asarray(x), jsp, tmesh8)
    jcfg, cfg = JPipelineConfig(emulate_uint8=emulate), PipelineConfig(emulate_uint8=emulate)
    want = np.asarray(jts.sharded_enhance(spec, tmesh8, jcfg))
    spec = np.array(spec)
    got = _shards(lambda ex, b: tts.sharded_enhance(b, ex, cfg), spec)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, classical_pipeline(torch.from_numpy(spec), cfg).numpy(),
                               atol=1e-5)


@pytest.fixture(scope="module")
def shot():
    """JAX's composed long shot (the Flax program, seed-2 weights) on a
    (T,) and a (2, T) trace of T = 262 144, and the weights."""
    jsp = JSpecParams(cut_shot=T_SHOT / SHOT.fs)
    xs = synth_trace(SHOT, seed=12, n_channels=2)[:, :T_SHOT]
    params = flax_model(JModelConfig()).init(jax.random.PRNGKey(2),
                                             np.zeros((1, 256, 128, 1), np.float32))
    fn = jts.make_sharded_enhance_shot(JModelConfig(), jsp, jmake_mesh(N, ("time",)))
    want = {c: tuple(np.asarray(a) for a in fn(params, jnp.asarray(xs[0] if c == 1 else xs)))
            for c in (1, 2)}
    return xs, state_dict_from_flax(params, ModelConfig()), want


def _model(sd):
    m = make_model(ModelConfig(), generator=torch.Generator().manual_seed(0), device="cpu")
    m.load_state_dict(sd)
    return m.eval()


@pytest.mark.parametrize("dtype,use_kernel,channels", [
    ("float32", "auto", 1), ("float32", False, 2), ("bf16", True, 2), ("bf16", False, 1)])
def test_composed_long_shot_matches_jax(shot, dtype, use_kernel, channels):
    """``make_sharded_enhance_shot`` on 8 shards (one 128-frame tile each)
    against JAX's Flax program: spectrogram within 5e-5, labels within
    1e-5; the enhanced output in float32 within 1e-5, in bf16 (the
    kernels' twins, or the module computing in bf16) at max 5e-2 and mean
    2e-3.  The AE runs in ``dtype`` on either route, and passing the
    prepared weights gives the same bits."""
    xs, sd, want = shot
    x = xs[0] if channels == 1 else xs
    model = _model(sd)
    sp = SpecParams(cut_shot=T_SHOT / SHOT.fs)
    tdtype = None if dtype == "float32" else torch.bfloat16

    def body(ex, b):
        fn = tts.make_sharded_enhance_shot(ModelConfig(), sp, ex, dtype=tdtype,
                                           use_kernel=use_kernel)
        wts = fn.prepare(model)
        if use_kernel is not False:
            assert wts.dtype == (tdtype or torch.float32)
        out = fn(wts, b)
        assert all(torch.equal(a, o) for a, o in zip(fn(model, b), out))
        return out

    spec, labels, enh = _shards(body, x)
    ws, wl, we = want[channels]
    assert spec.shape == labels.shape == enh.shape == ws.shape
    np.testing.assert_allclose(spec, ws, atol=5e-5)
    np.testing.assert_allclose(labels, wl, atol=1e-5)
    d = np.abs(enh - we)
    if dtype == "float32":
        assert d.max() <= 1e-5
    else:
        assert d.max() < 5e-2 and d.mean() < 2e-3, (d.max(), d.mean())


def test_world_of_one_is_unsharded(shot):
    """A gloo world of one on a ``("time",)`` mesh: the spectrogram is the
    port's ``spectrogram`` on its first n_frames columns bit for bit (the
    last column a copy), the labels ``classical_pipeline`` of it and the
    enhanced output ``ae_kernel_enhance_specs`` of it (bf16 twins), bit for
    bit; ``shard_of`` and ``gather_shards`` are the identity."""
    xs, sd, _ = shot
    model = _model(sd)
    sp = SpecParams(cut_shot=T_SHOT / SHOT.fs)
    x = torch.from_numpy(xs)
    mesh = make_mesh(1, ("time",), device="cpu")
    try:
        assert mesh.shape == {"time": 1}
        fn = tts.make_sharded_enhance_shot(ModelConfig(), sp, mesh)
        wts = fn.prepare(model)
        out = fn(wts, tts.shard_of(mesh, x))
        spec, labels, enh = tts.gather_shards(mesh, *out)
        alone = tts.sharded_spectrogram(x, sp, mesh)
        lab_alone = tts.sharded_enhance(alone, mesh)
    finally:
        mesh.close()
    want = spectrogram(x, sp)
    nf = want.shape[-1]
    assert torch.equal(spec[..., :nf], want) and torch.equal(spec[..., -1], spec[..., -2])
    assert torch.equal(alone, spec) and torch.equal(lab_alone, labels)
    assert torch.equal(labels, classical_pipeline(spec))
    assert torch.equal(enh, ae_kernel.ae_kernel_enhance_specs(wts, spec, spec.shape[-1] // 128))


def test_guards_word_for_word(tmesh8):
    """The checks of ``make_sharded_enhance_shot``, ``sharded_spectrogram``
    and ``sharded_enhance`` raise JAX's words where JAX has them; a block
    of the wrong length and a mesh of another axis raise."""
    sp = SpecParams(cut_shot=T_SHOT / SHOT.fs)
    jsp = JSpecParams(cut_shot=T_SHOT / SHOT.fs)
    with pytest.raises(ValueError, match="^make_sharded_enhance_shot requires a mesh$"):
        tts.make_sharded_enhance_shot(ModelConfig(), sp)
    cases = [  # (port call on a shard, JAX call, message)
        (lambda ex: tts.make_sharded_enhance_shot(ModelConfig(), sp, ex, n_samples=T_SHOT + 256),
         lambda: jts.make_sharded_enhance_shot(JModelConfig(), jsp, tmesh8, n_samples=T_SHOT + 256),
         r"T=262400 not divisible by n_dev\*hop=2048; trim with usable_samples_tiled\(\)"),
        (lambda ex: tts.make_sharded_enhance_shot(ModelConfig(), sp, ex, n_samples=T_SHOT // 2),
         lambda: jts.make_sharded_enhance_shot(JModelConfig(), jsp, tmesh8, n_samples=T_SHOT // 2),
         "frames/shard 64 not a whole number of 128-frame tiles"),
        (lambda ex: tts.make_sharded_enhance_shot(ModelConfig(input_shape=(128, 128, 1)), sp, ex),
         lambda: jts.make_sharded_enhance_shot(JModelConfig(input_shape=(128, 128, 1)), jsp,
                                               tmesh8),
         r"model input \(128, 128\) != tile geometry \(256, 128\)"),
        (lambda ex: tts.sharded_spectrogram(torch.zeros(300), sp, ex),
         lambda: jts.sharded_spectrogram(jnp.zeros(2400), jsp, tmesh8),
         r"T=2400 not divisible by n_dev\*hop=2048; trim with usable_samples\(\)"),
        (lambda ex: tts.sharded_spectrogram(torch.zeros(256), sp, ex),
         lambda: jts.sharded_spectrogram(jnp.zeros(2048), jsp, tmesh8),
         "each shard must hold at least nperseg/hop=2 frames; got 1"),
        (lambda ex: tts.sharded_enhance(torch.zeros(256, 10), ex),
         lambda: jts.sharded_enhance(jnp.zeros((256, 80)), tmesh8),
         "time shard width 10 < max halo 16; use fewer devices or a longer shot"),
    ]
    for port, jax_call, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jax_call()
        with pytest.raises(ValueError, match=msg):
            run_shards(N, port)
    fn = run_shards(1, lambda ex: tts.make_sharded_enhance_shot(ModelConfig(), sp, ex))[0]
    with pytest.raises(ValueError, match=r"\(T,\) or \(C, T\)"):
        run_shards(1, lambda ex: fn(None, torch.zeros(2, 2, T_SHOT)))
    with pytest.raises(ValueError, match="block must hold T/n_dev = 262144 samples"):
        run_shards(1, lambda ex: fn(None, torch.zeros(T_SHOT // 2)))
    with pytest.raises(ValueError, match="mesh's axis is 'data', not 'time'"):
        run_shards(2, lambda ex: tts.sharded_enhance(torch.zeros(256, 64), ex),
                   axis_names=("data",))
    with pytest.raises(NotImplementedError):
        run_shards(1, lambda ex: tts.make_sharded_enhance_shot(
            ModelConfig(filters=(16, 32, 128), kernels=((5, 5),) * 3, out_kernel=(5, 5)), sp,
            ex, use_kernel=True))


def test_usable_samples_match_jax():
    """``usable_samples`` and ``usable_samples_tiled`` are JAX's numbers."""
    for n, d in ((1_000_000, 1), (2_000_000, 1), (2_000_000, 2), (300_000, 8), (98_765, 3)):
        for hop in (256, 128):
            sp, jsp = SpecParams(noverlap=512 - hop), JSpecParams(noverlap=512 - hop)
            assert tts.usable_samples(n, d, sp) == jts.usable_samples(n, d, jsp)
            assert tts.usable_samples_tiled(n, d, sp) == jts.usable_samples_tiled(n, d, jsp)
    assert tts.usable_samples_tiled(2_000_000, 1, SpecParams()) == 1_998_848
    assert tts.usable_samples_tiled(2_000_000, 2, SpecParams()) == 1_966_080
