"""The port's sweeps (specenh_torch.sweep) and its tile-batch predictor
(bench.harness.make_production_predict_fn) against the JAX package on the
CPU: the grids, the envelope, the glorot draws and the masked embedding
bit for bit after the layout conversion, the masked forward against the
standalone module, ``sweep_fit`` and ``sweep_fit_serial`` trajectories,
resume and its guards, the marginal report and ``loss_comparisons.npz``.
Inputs from numpy seeds at JAX's small (64, 32, 1) tiles, and at full
width on 2-5 tiles where a kernel family covers the geometry (the CPU runs
the kernels' plain twins).

Tolerances: the same draws and layouts bit for bit; the envelope's grouped
convs against the standalone module atol 2e-6 (float32 sums in another
order); trajectories against JAX rtol 1e-4 (float32, Adam through 9
steps); a resumed run bit for bit the uninterrupted one."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from specenh import sweep as jsweep
from specenh.bench import harness as jharness
from specenh.config import ModelConfig as JModelConfig
from specenh.config import SweepConfig as JSweepConfig
from specenh.config import TrainConfig as JTrainConfig
from specenh.models.autoencoder import make_model as flax_model
from specenh_torch import ModelConfig, SweepConfig, TrainConfig
from specenh_torch import sweep as tsweep
from specenh_torch.bench import harness as tharness
from specenh_torch.models.autoencoder import make_model
from specenh_torch.models.convert import state_dict_from_flax
from specenh_torch.ops import ae_kernel as tak

SMALL = (64, 32, 1)
RTOL = 1e-4


def _pair(**kw):
    """The same ModelConfig in both packages."""
    return JModelConfig(**kw), ModelConfig(**kw)


def _cfgs(*specs, shape=SMALL):
    """[(filters, kernel, out_kernel)] -> (JAX configs, port configs)."""
    pairs = [_pair(filters=f, kernels=((k, k),) * len(f), out_kernel=(o, o), input_shape=shape)
             for f, k, o in specs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _data(n, seed=0, shape=SMALL):
    rng = np.random.default_rng(seed)
    x = rng.random((n, *shape)).astype(np.float32)
    return x, (x > 0.5).astype(np.float32)


def _jax_stacked_to_port(stacked):
    """A JAX stacked envelope (HWIO kernels) in the port's state_dict
    layout, as models/convert.py converts one config."""
    out = {}
    for name, d in stacked["params"].items():
        key = tsweep._key(name)
        k = np.asarray(d["kernel"])
        k = (k[:, ::-1, ::-1].transpose(0, 3, 4, 1, 2) if name.startswith("dec_deconv")
             else k.transpose(0, 4, 3, 1, 2))
        out[key + ".weight"] = np.ascontiguousarray(k)
        out[key + ".bias"] = np.asarray(d["bias"])
    return out


def _asdicts(cfgs):
    return [dataclasses.asdict(c) for c in cfgs]


def test_grids_and_envelope_match_jax():
    """expand_grid_2layer/3layer (default and edited axes) and
    envelope_config give JAX's configs; even kernels and mixed depths
    raise as JAX's do."""
    kw2 = dict(ker1_vals=((3, 3), (5, 5)), ker2_vals=((3, 3),), ker3_vals=((7, 7),),
               conv1_vals=(8, 16), conv2_vals=(8,))
    kw3 = dict(ker_vals_3layer=((3, 3),), conv1_vals_3layer=(4,),
               conv2_vals_3layer=(4, 8), conv3_vals_3layer=(4,))
    for kw in ({}, kw2, kw3):
        for fn in ("expand_grid_2layer", "expand_grid_3layer"):
            (jc, js), (tc, ts) = (getattr(jsweep, fn)(JSweepConfig(**kw)),
                                  getattr(tsweep, fn)(SweepConfig(**kw)))
            assert ts == js and _asdicts(tc) == _asdicts(jc), (fn, kw)
    jc, tc = _cfgs(((8, 4), 3, 3), ((4, 8), 7, 5))
    assert dataclasses.asdict(tsweep.envelope_config(tc)) == \
        dataclasses.asdict(jsweep.envelope_config(jc))
    for bad in ([((4, 4), 4, 3), ((4, 4), 5, 3)], [((4, 4), 3, 3), ((4, 4, 4), 3, 3)]):
        jc, tc = _cfgs(*bad)
        with pytest.raises(ValueError) as je:
            jsweep.envelope_config(jc)
        with pytest.raises(ValueError) as te:
            tsweep.envelope_config(tc)
        assert str(te.value) == str(je.value)


def test_stacked_params_extract_embed_match_jax():
    """init_stacked_params (params and masks), extract_config_params and
    embed_config_params equal JAX's bit for bit in the port's layout."""
    jc, tc = _cfgs(((4, 8), 3, 3), ((8, 8), 5, 7), ((8, 4), 7, 5))
    jenv, tenv = jsweep.envelope_config(jc), tsweep.envelope_config(tc)
    jp, jm = jsweep.init_stacked_params(jc, jenv, seed=3)
    tp, tm = tsweep.init_stacked_params(tc, tenv, seed=3)
    for want, got in ((_jax_stacked_to_port(jp), tp), (_jax_stacked_to_port(jm), tm)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    rng = np.random.default_rng(6)
    for i in range(3):
        small = jsweep.extract_config_params(jp, i, jc[i], jenv)
        got = tsweep.extract_config_params(tp, i, tc[i], tenv)
        want = state_dict_from_flax(small, tc[i])
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        noise = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), small)
        jp2 = jsweep.embed_config_params(jp, i, jc[i], jenv, noise)
        tp2 = tsweep.embed_config_params(tp, i, tc[i], tenv, state_dict_from_flax(noise, tc[i]))
        for k, v in _jax_stacked_to_port(jp2).items():
            np.testing.assert_array_equal(tp2[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("inner", [3, 5])
def test_masked_forward_equals_standalone(inner):
    """A k3 or k5 config centred in a k7 envelope, in every conv and
    transposed conv, with narrower filters: the envelope's grouped forward
    on its masked slot is the standalone module's forward (atol 2e-6)."""
    _, tc = _cfgs(((4, 8), inner, inner), ((8, 8), 7, 7))
    env = tsweep.envelope_config(tc)
    stacked, masks = tsweep.init_stacked_params(tc, env, seed=3)
    x = torch.from_numpy(_data(4)[0][..., 0])
    masked = {k: stacked[k] * masks[k] for k in stacked}
    z = tsweep._envelope_logits(masked, env, len(tc), x, torch.float32)
    for i, cfg in enumerate(tc):
        model = make_model(cfg, generator=torch.Generator().manual_seed(0))
        model.load_state_dict(tsweep.extract_config_params(stacked, i, cfg, env))
        torch.testing.assert_close(z[:, i], model(x, logits=True), rtol=0, atol=2e-6)


SWEEP_CASES = {
    # two configs of different filters and kernels, shuffled batches of 8
    "plain": dict(tc=dict(batch_size=8, seed=0), epochs=3),
    # lr 0: every config stale after its first epoch, patience 1 stops both
    # packages after the second
    "patience": dict(tc=dict(batch_size=8, seed=0, learning_rate=0.0, patience=1), epochs=6),
}


@pytest.fixture(scope="module")
def sweep_data():
    x, y = _data(32)
    return x[:24], y[:24], x[24:], y[24:]


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_fit_matches_jax(sweep_data, case):
    """The envelope engine against JAX's sweep_fit in float32: the same
    histories (rtol 1e-4), the same epochs, the same best config."""
    c = SWEEP_CASES[case]
    jc, tc = _cfgs(((4, 4), 3, 3), ((8, 8), 5, 5))
    jr = jsweep.sweep_fit(jc, *sweep_data, JTrainConfig(**c["tc"]), epochs=c["epochs"])
    tr = tsweep.sweep_fit(tc, *sweep_data, TrainConfig(**c["tc"]), epochs=c["epochs"],
                          device="cpu")
    assert tr.val_history.shape == jr.val_history.shape
    np.testing.assert_allclose(tr.train_history, jr.train_history, rtol=RTOL)
    np.testing.assert_allclose(tr.val_history, jr.val_history, rtol=RTOL)
    assert tr.best_index == jr.best_index
    if case == "plain":
        assert (tr.val_history[-1] < tr.val_history[0]).all()
        want = state_dict_from_flax(jr.best_params, tc[jr.best_index])
        for k in want:
            torch.testing.assert_close(tr.best_params[k], want[k], rtol=0, atol=1e-4)


def test_sweep_fit_serial_matches_jax(sweep_data):
    """The serial engine at the small geometry (no kernel family covers
    it: the module's autograd engine) against JAX's Flax engine, and
    against the port's own envelope: rtol 1e-4."""
    jc, tc = _cfgs(((4, 4), 3, 3), ((8, 8), 5, 5))
    tcfg = dict(batch_size=8, seed=0)
    jr = jsweep.sweep_fit_serial(jc, *sweep_data, JTrainConfig(**tcfg), epochs=3,
                                 engine="flax")
    tr = tsweep.sweep_fit_serial(tc, *sweep_data, TrainConfig(**tcfg), epochs=3, device="cpu")
    np.testing.assert_allclose(tr.train_history, jr.train_history, rtol=RTOL)
    np.testing.assert_allclose(tr.val_history, jr.val_history, rtol=RTOL)
    assert tr.best_index == jr.best_index
    env = tsweep.sweep_fit(tc, *sweep_data, TrainConfig(**tcfg), epochs=3, device="cpu")
    np.testing.assert_allclose(tr.val_history, env.val_history, rtol=RTOL)
    for i, cfg in enumerate(tc):
        got = tsweep.extract_config_params(tr.stacked_params, i, cfg, tr.env)
        if i == tr.best_index:
            for k, v in tr.best_params.items():
                torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_serial_kernel_engine_matches_jax_flax():
    """A covered config at full width (the flagship, 3 training and 2
    validation tiles, 1 epoch): the port's kernel engine in float32 (its
    CPU twins) against JAX's Flax engine, rtol 1e-4; the engine chosen is
    the kernels'."""
    x, y = _data(5, seed=2, shape=(256, 128, 1))
    jc, tc = _cfgs(((32, 32), 3, 3), shape=(256, 128, 1))
    args = (x[:3], y[:3], x[3:], y[3:])
    jr = jsweep.sweep_fit_serial(jc, *args, JTrainConfig(batch_size=2, seed=1), epochs=1,
                                 engine="flax")
    tr = tsweep.sweep_fit_serial(tc, *args, TrainConfig(batch_size=2, seed=1), epochs=1,
                                 dtype=torch.float32, device="cpu", verbose=True)
    np.testing.assert_allclose(tr.train_history, jr.train_history, rtol=RTOL)
    np.testing.assert_allclose(tr.val_history, jr.val_history, rtol=RTOL)
    assert tak.supports(tc[0])


@pytest.mark.parametrize("engine", ["envelope", "serial"])
def test_resume_equals_uninterrupted(sweep_data, tmp_path, engine):
    """One epoch, checkpointed, then a resumed run to three: the histories
    and the stacked parameters of the uninterrupted run, bit for bit."""
    _, tc = _cfgs(((4, 4), 3, 3), ((8, 8), 5, 5))
    fit = tsweep.sweep_fit if engine == "envelope" else tsweep.sweep_fit_serial
    cfg = TrainConfig(batch_size=8, seed=0)
    full = fit(tc, *sweep_data, cfg, epochs=3, device="cpu")
    ck = str(tmp_path / "ck")
    fit(tc, *sweep_data, cfg, epochs=1, checkpoint_dir=ck, device="cpu")
    res = fit(tc, *sweep_data, cfg, epochs=3, checkpoint_dir=ck, resume=True, device="cpu")
    np.testing.assert_array_equal(res.train_history, full.train_history)
    np.testing.assert_array_equal(res.val_history, full.val_history)
    for k, v in full.stacked_params.items():
        torch.testing.assert_close(res.stacked_params[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("change", ["dataset", "grid"])
def test_resume_guards(sweep_data, tmp_path, change):
    """Resuming an envelope sweep with another dataset size, or with the
    grid reordered (same count, same envelope), raises."""
    _, tc = _cfgs(((4, 4), 3, 3), ((8, 8), 3, 3))
    x, y, xv, yv = sweep_data
    cfg = TrainConfig(batch_size=8, seed=0)
    ck = str(tmp_path / "ck")
    tsweep.sweep_fit(tc, x, y, xv, yv, cfg, epochs=1, checkpoint_dir=ck, device="cpu")
    if change == "dataset":
        x, y = x[:16], y[:16]
    else:
        tc = tc[::-1]
    with pytest.raises(ValueError, match="run parameters changed"):
        tsweep.sweep_fit(tc, x, y, xv, yv, cfg, epochs=2, checkpoint_dir=ck, resume=True,
                         device="cpu")


def test_requires_tune_split():
    _, tc = _cfgs(((4, 4), 3, 3))
    x, y = _data(8)
    for fit in (tsweep.sweep_fit, tsweep.sweep_fit_serial):
        for empty in (np.zeros((0, *SMALL), np.float32), None):
            with pytest.raises(ValueError, match="non-empty tune split"):
                fit(tc, x, y, empty, empty, TrainConfig(), device="cpu")


def test_marginal_report_and_loss_comparisons_match_jax(tmp_path):
    """The marginal means and loss_comparisons.npz (keys and values)."""
    rng = np.random.default_rng(1)
    vals, times = rng.random(12), rng.random(12)
    names = ["ker1", "conv1"]
    jrep, trep = jsweep.marginal_report(vals, (3, 4), names), \
        tsweep.marginal_report(vals, (3, 4), names)
    assert set(trep) == set(jrep)
    for k in jrep:
        np.testing.assert_array_equal(trep[k], jrep[k])
    jsweep.save_loss_comparisons(str(tmp_path / "j.npz"), vals, times, (3, 4), names)
    tsweep.save_loss_comparisons(str(tmp_path / "t.npz"), vals, times, (3, 4), names)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files) == \
            ["conv1_loss", "conv1_time", "ker1_loss", "ker1_time"]
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])


@pytest.fixture(scope="module")
def tiles():
    return np.random.default_rng(3).random((2, 256, 128, 1)).astype(np.float32)


@pytest.mark.parametrize("filters", [(32, 32), (16, 32)], ids=["covered", "uncovered"])
def test_production_predict_fn_matches_jax(tiles, filters):
    """On converted Flax weights, float32 and bf16: the covered flagship
    geometry on the kernels' twins, the uncovered (16, 32) on the module,
    against JAX's Flax predictor (atol 1e-5 in float32, 2e-2 in bf16);
    use_kernel=True on the uncovered geometry raises in both packages;
    prepare is idempotent."""
    jcfg, tcfg = _pair(filters=filters)
    params = flax_model(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 128, 1)))
    model = make_model(tcfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params, tcfg))
    want32 = np.asarray(jharness.make_production_predict_fn(jcfg, dtype=jnp.float32)(
        params, jnp.asarray(tiles)))
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        fn = tharness.make_production_predict_fn(tcfg, dtype=dtype, device="cpu")
        w = fn.prepare(model)
        assert fn.prepare(w) is w
        assert isinstance(w, tak.AEKernelWeights) == (filters == (32, 32))
        got = fn(w, tiles)
        assert got.shape == tiles.shape
        np.testing.assert_allclose(got.numpy(), want32, rtol=0, atol=atol)
        np.testing.assert_allclose(fn(model, tiles[..., 0]).numpy(), got.numpy()[..., 0],
                                   rtol=0, atol=0)
    if filters == (16, 32):
        with pytest.raises(NotImplementedError):
            jharness.make_production_predict_fn(jcfg, use_kernel=True)
        with pytest.raises(NotImplementedError):
            tharness.make_production_predict_fn(tcfg, use_kernel=True, device="cpu")
        kw = tak.build_kernel_weights(make_model(ModelConfig(),
                                                 generator=torch.Generator().manual_seed(0)))
        with pytest.raises(TypeError):
            tharness.make_production_predict_fn(tcfg, device="cpu").prepare(kw)
