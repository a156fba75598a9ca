"""The frozen reference against the port's plain paths at a small size on
the CPU: the STFT against the port's float64 matmul STFT and SciPy's
recipe, the forward and the loss against the port's module, three Keras
Adam steps against the port's autograd engine, the validation loss against
the port's ``evaluate``, the check's batches against those ``fit`` feeds."""

from __future__ import annotations

import ast
import json

import numpy as np
import pytest
import torch

from benchmark.core import inputs, port
from benchmark.kinds import train as train_kind
from benchmark.reference import ae as ref_ae
from benchmark.reference import lowp
from benchmark.reference import stft as ref_stft
from benchmark.tests.tiny import ROOT, tiny_run


def _cfg(name):
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    cfg["spec"]["cut_shot"] = 0.2
    cfg["patch"]["tiles_per_spec"] = 3
    return cfg


def _traces(cfg, seed=7, channels=2):
    mix = json.loads((ROOT / "benchmark/traffic/serve.json").read_text())
    return inputs.shots(2, channels, cfg["spec"], mix["shot"], seed, "cpu")[0]


def test_stft_equals_the_ports_plain_stft_and_scipys_recipe():
    from specenh_torch.bench.reference import spectrogram_ref
    from specenh_torch.config import SpecParams
    from specenh_torch.ops.stft import spectrogram

    cfg = _cfg("flagship")
    x = _traces(cfg)
    ours = ref_stft.spectrogram(x, cfg["spec"])
    sp = SpecParams(**cfg["spec"])
    assert ours.shape == (2, 256, sp.n_frames)
    torch.testing.assert_close(ours, spectrogram(x, sp), rtol=0, atol=2e-6)
    scipy_spec = spectrogram_ref(x[1].double().numpy(), sp)[0]   # SciPy in float64
    np.testing.assert_allclose(ours[1].numpy(), scipy_spec, rtol=0, atol=2e-6)


def test_stft_control_is_lower():
    cfg = _cfg("flagship")
    x = _traces(cfg)
    gap = (ref_stft.spectrogram(x, cfg["spec"], lower=torch.bfloat16)
           - ref_stft.spectrogram(x, cfg["spec"])).abs().max()
    assert 1e-4 < gap < 0.5


@pytest.mark.parametrize("name", ["flagship", "deep3"])
def test_forward_and_loss_equal_the_ports_module(name):
    from specenh_torch.models.autoencoder import make_model
    from specenh_torch.train import bce_from_logits


    cfg = _cfg(name)
    _, model_cfg = port.configs(cfg)
    w = inputs.glorot_weights(cfg["model"], 99, "cpu")
    model = make_model(model_cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(w)
    x = torch.rand(3, 256, 128, generator=torch.Generator().manual_seed(1))
    y = (0.8 * x + 0.1).clamp(0, 1)
    depth = len(cfg["model"]["filters"])
    with torch.no_grad():
        z = ref_ae.logits(w, x, depth)
        torch.testing.assert_close(z, model(x, logits=True), rtol=1e-5, atol=1e-5)
        mask = torch.tensor([1.0, 1.0, 0.0])
        torch.testing.assert_close(ref_ae.bce_from_logits(z, y, mask),
                                   bce_from_logits(z, y, mask), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["flagship", "deep3"])
def test_three_adam_steps_equal_the_ports_autograd_engine(name):
    from specenh_torch import train as T

    cfg = _cfg(name)
    _, model_cfg = port.configs(cfg)
    w = inputs.glorot_weights(cfg["model"], 5, "cpu")
    g = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(3):
        x = torch.rand(2, 256, 128, generator=g)
        batches.append((x, (0.8 * x + 0.1).clamp(0, 1), torch.ones(2)))
    losses, grad, after = ref_ae.train_steps(w, batches, len(cfg["model"]["filters"]),
                                             cfg["train"])
    state = T.create_state(model_cfg, port.train_config(cfg), device="cpu")
    state.model.load_state_dict(w)
    for k, (x, y, m) in enumerate(batches):
        state, loss = T.train_step(state, x, y, m)
        assert float(loss) == pytest.approx(losses[k], rel=1e-5)
        if k == 0:
            for n, p in state.model.named_parameters():
                torch.testing.assert_close(state.optimizer.state[p]["exp_avg"] / 0.1, grad[n],
                                           rtol=1e-4, atol=1e-9)
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), after[-1][n], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["flagship", "deep3"])
def test_validation_loss_equals_the_ports_evaluate(name):
    from specenh_torch import train as T
    from specenh_torch.config import TrainConfig

    cfg = _cfg(name)
    m = cfg["model"]
    weights = inputs.glorot_weights(m, 5, "cpu")
    _, model_cfg = port.configs(cfg)
    state = T.create_state(model_cfg, TrainConfig(batch_size=2), device="cpu")
    state.model.load_state_dict(weights)
    g = torch.Generator().manual_seed(4)
    x = torch.rand(5, *m["input_shape"][:2], generator=g)
    y = (0.8 * x + 0.1).clamp(0, 1)
    ours = ref_ae.mean_bce(weights, x, y, len(m["filters"]), block=2)
    assert ours == pytest.approx(T.evaluate(state, x, y, bs=2), rel=1e-5)


def test_the_check_rebuilds_the_batches_fit_feeds():
    from specenh_torch import train as T

    run = tiny_run("flagship-train")
    train_kind.setup(run)
    fed = []

    def epoch(state, x, y, batch_idx, batch_mask):
        fed.extend((x[i], m) for i, m in zip(batch_idx, batch_mask))
        return state, torch.zeros(batch_idx.shape[0])

    tcfg = port.train_config(run.config, seed=run.state["check_seed"])
    T.fit(run.state["program"], *run.state["check"], None, None, tcfg, epochs=1, epoch_fn=epoch)
    ours = train_kind._check_batches(run)
    assert len(ours) == len(fed) == run.mix["check"]["steps"]
    for (x, _, m), (fx, fm) in zip(ours, fed):
        torch.testing.assert_close(m, fm, rtol=0, atol=0)
        torch.testing.assert_close(x, fx, rtol=0, atol=0)
    assert 0 < float(ours[-1][2].sum()) < run.config["train"]["batch_size"]


def test_fp8_rounds_and_passes_gradients():
    x = torch.linspace(-1, 1, 101, requires_grad=True)
    q = lowp.fp8(x)
    assert 0 < float((q - x).detach().abs().max()) < 0.07
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones(101))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark/reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top in {"torch", "numpy", "math", "typing", "__future__", "benchmark"}, (f, name)
            assert not name.startswith("benchmark.") or name.startswith("benchmark.reference"), \
                (f, name)
