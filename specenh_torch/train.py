"""Training loop of the denoising autoencoder (the counterpart of
``specenh.train``), Keras ``autoencoder.fit`` semantics
(VAE/hyperparam_scan.py:177-184):

* Adam with Keras defaults (lr 1e-3, betas (0.9, 0.999), eps 1e-7):
  ``torch.optim.Adam`` updates by lr * m_hat / (sqrt(v_hat) + eps), as optax;
* sigmoid-BCE from logits, masked over the padded last batch;
* a per-epoch shuffle from ``np.random.default_rng(cfg.seed).permutation``
  (the JAX package's stream, so the batch order is the same), a validation
  pass per epoch, Keras-style ``history``;
* per-epoch checkpoints of the module and the optimizer (``epoch_NNNN/``),
  ``metrics.jsonl``, ``history.json`` and ``run_meta.json``, resume with
  shuffle replay, opt-in early stopping (``cfg.patience``).

The default engine (``train_epoch``) is torch autograd on the ``nn.Module``,
in float32 or, with ``create_state(dtype=torch.bfloat16)``, in bf16 with
float32 master weights;
``kernel_epoch_for`` gives the engine on the hand-written CUDA training
kernels (``ops.ae_train_kernel``: K5 at depth 2, K7 at depth 3).  Tiles
are (N, 256, 128) or the JAX layout (N, 256, 128, 1); everything runs on
``state.device``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from specenh_torch.config import ModelConfig, TrainConfig
from specenh_torch.models.autoencoder import ConvAutoencoder, make_model
from specenh_torch.utils.logging import span

__all__ = [
    "TrainState", "create_state", "bce_from_logits", "train_step",
    "train_epoch", "eval_epoch", "eval_loss", "evaluate", "kernel_epoch_for", "fit",
    "predict", "restore_checkpoint", "latest_checkpoint_epoch",
    "write_run_meta", "check_run_meta", "weighted_epoch_mean", "save_model",
    "load_model",
]


@dataclasses.dataclass
class TrainState:
    """The module, its Adam optimizer and the step count."""

    model: ConvAutoencoder
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.model.out_conv.weight.device


def create_state(model_cfg: ModelConfig = ModelConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype=None) -> TrainState:
    """A glorot-initialised module (from ``generator``, default seeded with
    ``train_cfg.seed``) on ``device`` and its Adam optimizer.
    ``dtype=torch.bfloat16`` trains the autograd engine with bfloat16
    activations, the parameters and the optimizer state staying float32
    (the JAX package's ``create_state(dtype=jnp.bfloat16)``); None is
    float32."""
    gen = torch.Generator().manual_seed(train_cfg.seed) if generator is None else generator
    model = make_model(model_cfg, generator=gen, device=device, dtype=dtype)
    opt = torch.optim.Adam(model.parameters(), lr=train_cfg.learning_rate,
                           betas=(train_cfg.beta1, train_cfg.beta2),
                           eps=train_cfg.adam_eps)
    return TrainState(model, opt)


def bce_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross-entropy from logits (stable); with ``mask`` (B,),
    the mean over the real examples only."""
    per = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if mask is None:
        return per.mean()
    w = mask.reshape((-1,) + (1,) * (per.ndim - 1)).to(per.dtype)
    return (per * w).sum() / (w.sum() * per[0].numel())


def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor):
    """One autograd step of the module; returns (state, loss)."""
    with span("train.step", key=state.step):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with span("step.loss"):
            loss = bce_from_logits(state.model(x, logits=True), y, mask)
            loss.backward()
        with span("step.adam"):
            state.optimizer.step()
        state.step += 1
    return state, loss.detach()


def train_epoch(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                batch_idx: torch.Tensor, batch_mask: torch.Tensor):
    """One epoch: ``batch_idx`` (n_batches, bs) indexes the shuffled
    batches, padded slots masked by ``batch_mask``.  Returns (state,
    per-batch losses) with the losses left on the device."""
    losses = []
    for idx, m in zip(batch_idx, batch_mask):
        state, loss = train_step(state, x[idx], y[idx], m)
        losses.append(loss)
    return state, torch.stack(losses)


@torch.no_grad()
def eval_loss(state: TrainState, x: torch.Tensor, y: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The module's masked mean BCE on one batch, left on the device."""
    state.model.eval()
    return bce_from_logits(state.model(x, logits=True), y, mask)


@torch.no_grad()
def eval_epoch(state: TrainState, x: torch.Tensor, y: torch.Tensor,
               batch_idx: torch.Tensor, batch_mask: torch.Tensor) -> torch.Tensor:
    return torch.stack([eval_loss(state, x[idx], y[idx], m)
                        for idx, m in zip(batch_idx, batch_mask)])


def _batches(n: int, bs: int, perm: np.ndarray):
    """Yield (index-array, mask) pairs of size bs (the last one padded with
    index 0 and mask 0)."""
    for i in range(0, n, bs):
        idx = perm[i : i + bs]
        m = np.ones(len(idx), np.float32)
        if len(idx) < bs:
            pad = bs - len(idx)
            idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
            m = np.concatenate([m, np.zeros(pad, np.float32)])
        yield idx, m


def _epoch_batches(n: int, bs: int, perm: np.ndarray):
    """All of an epoch's batches as stacked (n_batches, bs) arrays."""
    idxs, masks = zip(*_batches(n, bs, perm))
    return np.stack(idxs).astype(np.int64), np.stack(masks)


def weighted_epoch_mean(losses, batch_mask) -> np.ndarray:
    """Mask-weighted mean of an epoch's per-batch losses: the padded last
    batch counts by its real examples (Keras's epoch mean)."""
    losses = (losses.detach().cpu().numpy() if torch.is_tensor(losses)
              else np.asarray(losses))
    w = np.asarray(batch_mask).sum(axis=1)
    w = w.reshape(w.shape + (1,) * (losses.ndim - 1))
    return (losses * w).sum(axis=0) / w.sum()


def write_run_meta(checkpoint_dir: str, meta: Dict[str, Any]) -> None:
    """Record the run parameters the shuffle-stream replay depends on."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "run_meta.json"), "w") as fh:
        json.dump(meta, fh)


def check_run_meta(checkpoint_dir: str, meta: Dict[str, Any],
                   optional_keys=()) -> None:
    """Refuse to resume when the dataset size, seed or batching differ from
    the checkpointed run (the replayed shuffle would diverge).  A key of
    ``optional_keys`` absent from the saved file is tolerated; present in
    either but different raises."""
    path = os.path.join(checkpoint_dir, "run_meta.json")
    if not os.path.exists(path):
        return
    with open(path) as fh:
        saved = json.load(fh)
    diffs = {k: (saved.get(k), v) for k, v in meta.items()
             if saved.get(k) != v and not (k in optional_keys and k not in saved)}
    for k in optional_keys:
        if k in saved and k not in meta:
            diffs[k] = (saved[k], None)
    if diffs:
        raise ValueError(
            f"cannot resume from {checkpoint_dir}: run parameters changed "
            f"since the checkpointed run: {diffs} (saved, current) — the "
            "replayed shuffle stream would not match the original run")


def latest_checkpoint_epoch(checkpoint_dir: str) -> Optional[int]:
    """Highest epoch_NNNN under ``checkpoint_dir``, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    epochs = [int(d.split("_")[1]) for d in os.listdir(checkpoint_dir)
              if d.startswith("epoch_") and d.split("_")[1].isdigit()]
    return max(epochs) if epochs else None


def _save_checkpoint(state: TrainState, checkpoint_dir: str, epoch: int) -> None:
    d = os.path.join(checkpoint_dir, f"epoch_{epoch:04d}")
    os.makedirs(d, exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(), "step": state.step},
               os.path.join(d, "state.pt"))


def restore_checkpoint(state: TrainState, checkpoint_dir: str, epoch: int) -> TrainState:
    """Restore the module, the optimizer and the step saved by ``fit``."""
    ck = torch.load(os.path.join(checkpoint_dir, f"epoch_{epoch:04d}", "state.pt"),
                    map_location=state.device, weights_only=True)
    state.model.load_state_dict(ck["model"])
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    return state


def kernel_epoch_for(model_cfg: ModelConfig, train_cfg: TrainConfig,
                     dtype=None, pre_layout: bool = False):
    """Epoch function on the hand-written CUDA training kernels: pass as
    ``fit(..., epoch_fn=...)``.  Depth 2 runs K5 (or K5b with
    ``pre_layout=True``), depth 3 K7, which has no pre-cast variant
    (``pre_layout=True`` raises there).
    ``dtype`` is the kernels' (bf16 by default).  The optimizer is the
    state's (``create_state`` builds it from ``train_cfg``).  A geometry
    no kernel covers raises, and so does a kernel that fails to build or
    launch (there is no fallback)."""
    dtype = torch.bfloat16 if dtype is None else dtype
    from specenh_torch.ops.ae_train_kernel import kernel_train_epoch_fn

    return kernel_train_epoch_fn(model_cfg, dtype=dtype, pre_layout=pre_layout)


def _as_tiles(a, device) -> torch.Tensor:
    t = torch.as_tensor(a, dtype=torch.float32, device=device)
    return (t[..., 0] if t.ndim == 4 else t).contiguous()


def fit(state: TrainState, x_train, y_train, x_val=None, y_val=None,
        cfg: TrainConfig = TrainConfig(), epochs: Optional[int] = None,
        metrics_path: Optional[str] = None,
        checkpoint_dir: Optional[str] = None, resume: bool = False,
        epoch_fn=None, verbose: bool = False):
    """Keras-fit equivalent.  Returns (state, history) with history keys
    'loss' and 'val_loss' (per-epoch means), 'new_epochs' (epochs trained
    by this call) and, after an early stop, 'stopped_epoch'.

    With ``checkpoint_dir`` and ``resume=True`` training continues from
    the latest saved epoch, the shuffle stream replayed.  ``epoch_fn``
    swaps the engine (same signature as ``train_epoch``), e.g.
    ``kernel_epoch_for(...)``.

    Spans (recorded while ``utils.logging.recording()`` is on): ``fit``;
    ``fit.epoch`` keyed by the epoch, and in it ``fit.batches`` (the
    shuffle and the batches' upload), ``fit.steps`` (the engine's
    ``train.step`` spans), ``fit.loss_sync``, ``fit.validate`` and
    ``fit.record`` (history, metrics line, checkpoint)."""
    with span("fit"):
        return _fit(state, x_train, y_train, x_val, y_val, cfg, epochs, metrics_path,
                    checkpoint_dir, resume, epoch_fn, verbose)


def _fit(state, x_train, y_train, x_val, y_val, cfg, epochs, metrics_path, checkpoint_dir,
         resume, epoch_fn, verbose):
    epochs = cfg.epochs if epochs is None else epochs
    dev = state.device
    x_train, y_train = _as_tiles(x_train, dev), _as_tiles(y_train, dev)
    n = x_train.shape[0]
    bs = min(cfg.batch_size, n)
    rng = np.random.default_rng(cfg.seed)
    history: Dict[str, Any] = {"loss": [], "val_loss": []}
    writer = open(metrics_path, "a") if metrics_path else None
    if checkpoint_dir:
        checkpoint_dir = os.path.abspath(checkpoint_dir)

    run_meta = {"n": int(n), "seed": int(cfg.seed), "batch_size": int(bs),
                "shuffle": bool(cfg.shuffle)}
    start_epoch = 0
    if resume and checkpoint_dir:
        last = latest_checkpoint_epoch(checkpoint_dir)
        if last is not None:
            check_run_meta(checkpoint_dir, run_meta)
            state = restore_checkpoint(state, checkpoint_dir, last)
            start_epoch = last + 1
            for _ in range(start_epoch):  # replay the shuffle stream
                if cfg.shuffle:
                    rng.permutation(n)
            hpath = os.path.join(checkpoint_dir, "history.json")
            if os.path.exists(hpath):
                with open(hpath) as fh:
                    saved_hist = json.load(fh)
                history["loss"] = list(saved_hist.get("loss", []))[:start_epoch]
                history["val_loss"] = list(saved_hist.get("val_loss", []))[:start_epoch]
            if verbose:
                print(f"resumed from epoch {last}")
    if checkpoint_dir:
        write_run_meta(checkpoint_dir, run_meta)

    # early stopping after `patience` epochs without a val_loss improvement,
    # keeping the final weights; seeded from a restored history, so a
    # resume counts stale epochs as the uninterrupted run did
    best_val = min(history["val_loss"], default=np.inf)
    stale = 0
    if cfg.patience is not None and history["val_loss"]:
        stale = len(history["val_loss"]) - 1 - int(np.argmin(history["val_loss"]))
        if stale >= cfg.patience:  # the uninterrupted run stopped here
            history["stopped_epoch"] = start_epoch - 1
            start_epoch = epochs

    for epoch in range(start_epoch, epochs):
        with span("fit.epoch", key=epoch):
            t0 = time.perf_counter()
            with span("fit.batches"):
                perm = rng.permutation(n) if cfg.shuffle else np.arange(n)
                batch_idx, batch_mask = _epoch_batches(n, bs, perm)
                idx_d = torch.from_numpy(batch_idx).to(dev)
                mask_d = torch.from_numpy(batch_mask).to(dev)
            with span("fit.steps"):
                state, losses = (epoch_fn or train_epoch)(state, x_train, y_train, idx_d, mask_d)
            with span("fit.loss_sync"):
                epoch_loss = float(weighted_epoch_mean(losses, batch_mask))
            history["loss"].append(epoch_loss)

            val = None
            if x_val is not None and len(x_val):
                with span("fit.validate"):
                    val = evaluate(state, x_val, y_val, bs)
                history["val_loss"].append(val)
            with span("fit.record"):
                dt = time.perf_counter() - t0
                if verbose:
                    msg = f"epoch {epoch + 1}/{epochs} loss={epoch_loss:.5f}"
                    if val is not None:
                        msg += f" val_loss={val:.5f}"
                    print(msg + f" ({dt:.2f}s)")
                if writer:
                    writer.write(json.dumps({"epoch": epoch, "loss": epoch_loss,
                                             "val_loss": val, "sec": dt}) + "\n")
                    writer.flush()
                if checkpoint_dir:
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
                        if checkpoint_dir:
                            with open(os.path.join(checkpoint_dir, "history.json"), "w") as fh:
                                json.dump(history, fh)
                        if verbose:
                            print(f"early stopping: val_loss stale for {cfg.patience} "
                                  f"epochs (best {best_val:.5f})")
                        break
    if writer:
        writer.close()
    history["new_epochs"] = max(0, epochs - start_epoch)
    return state, history


def evaluate(state: TrainState, x, y, bs: int = 128) -> float:
    """Mask-weighted mean BCE of the module over (x, y), in order."""
    dev = state.device
    x, y = _as_tiles(x, dev), _as_tiles(y, dev)
    n = x.shape[0]
    batch_idx, batch_mask = _epoch_batches(n, min(bs, n), np.arange(n))
    losses = eval_epoch(state, x, y, torch.from_numpy(batch_idx).to(dev),
                        torch.from_numpy(batch_mask).to(dev))
    return float(weighted_epoch_mean(losses, batch_mask))


@torch.no_grad()
def predict(state: TrainState, x, bs: int = 512) -> torch.Tensor:
    """Keras ``model.predict``: sigmoid probabilities, in batches of ``bs``,
    in x's layout."""
    state.model.eval()
    x = torch.as_tensor(x, dtype=torch.float32, device=state.device)
    return torch.cat([state.model(x[i : i + bs]) for i in range(0, x.shape[0], bs)])


def save_model(state: TrainState, path: str, model_cfg: ModelConfig) -> None:
    """The module's weights (``params.pt``) and ``model_config.json``, one
    directory per variant (hyperparam_scan.py:191)."""
    os.makedirs(path, exist_ok=True)
    torch.save(state.model.state_dict(), os.path.join(path, "params.pt"))
    with open(os.path.join(path, "model_config.json"), "w") as fh:
        json.dump({"filters": list(model_cfg.filters),
                   "kernels": [list(k) for k in model_cfg.kernels],
                   "out_kernel": list(model_cfg.out_kernel),
                   "input_shape": list(model_cfg.input_shape)}, fh)


def load_model(path: str, train_cfg: TrainConfig = TrainConfig(), device="cuda"):
    """Counterpart of Keras ``load_model``: (state, model_cfg)."""
    with open(os.path.join(path, "model_config.json")) as fh:
        d = json.load(fh)
    model_cfg = ModelConfig(filters=tuple(d["filters"]),
                            kernels=tuple(tuple(k) for k in d["kernels"]),
                            out_kernel=tuple(d["out_kernel"]),
                            input_shape=tuple(d["input_shape"]))
    state = create_state(model_cfg, train_cfg, device=device)
    state.model.load_state_dict(torch.load(os.path.join(path, "params.pt"),
                                           map_location=state.device,
                                           weights_only=True))
    return state, model_cfg
