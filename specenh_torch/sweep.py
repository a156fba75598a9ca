"""Hyperparameter sweeps (the counterpart of ``specenh.sweep``).

The reference sweeps as a SLURM array, one process per kernel size
(VAE/hyperparam_scan.py:122-123), or as serial nested loops over (ker1,
ker2, ker3, conv1, conv2) (VAE/manual_scan.py:183-252) and (ker, conv1,
conv2, conv3) (VAE/manual_scan_3layers.py).  Three engines here:

* ``sweep_fit_serial``: one ``train.fit`` per config, each at its own
  geometry's cost, on the CUDA training kernels (``kernel_epoch_for``)
  wherever a kernel family covers the geometry (``ae_kernel.kernel_depth``),
  else on the module's autograd engine in the sweep's dtype (the JAX
  package trains those configs on Flax);
* ``sweep_fit_serial_streamed``: ``sweep_fit_serial`` over a streamed
  store, one ``train_stream.fit_streaming`` per config, for grids whose
  tiles the card cannot hold;
* ``sweep_fit``, the envelope: every config embedded in the largest
  geometry of the grid (widest filters, largest kernels) with masked
  weights, all trained at once by grouped convolutions (one group per
  config) on torch autograd.  A centred odd kernel zero-padded to a larger
  odd one computes the same 'same'-padded conv, and masking the weights in
  the forward pass gives the masked entries exactly zero gradient, so one
  ``torch.optim.Adam`` over the stacked tensors is per-config Adam and each
  config trains as it would alone.

Over a ``parallel.mesh.Mesh`` the serial engines train each config
data-parallel (a "data" mesh, ``parallel.dp_fit`` or
``fit_streaming(mesh=)``) and the envelope shards its config axis (a
"sweep" mesh: each rank trains its slice of the grid).

Every config starts from the same glorot draws in both engines and in the
JAX package (``init_stacked_params``: numpy, ``seed * 100_003 + i``).
Parameters are the port's ``state_dict`` layout: the stacked envelope is a
dict of the module's keys to tensors with a leading config axis.

Artifacts follow the reference: the per-config final val losses (best
model on the lowest, manual_scan.py:216-224), per-parameter marginal means
(``loss_comparisons.npz``, manual_scan.py:302-364) and per-config
prediction times (``config_pred_times``, manual_scan.py:226-248).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from specenh_torch.config import ModelConfig, SweepConfig, TrainConfig
from specenh_torch.models.autoencoder import conv_transpose_same, make_model
from specenh_torch.ops.ae_kernel import supports, supports3
from specenh_torch.parallel.collectives import gather_blocks
from specenh_torch.train import (_as_tiles, _epoch_batches, check_run_meta, create_state,
                                 fit, kernel_epoch_for, latest_checkpoint_epoch,
                                 weighted_epoch_mean, write_run_meta)

__all__ = [
    "SweepResult",
    "expand_grid_2layer",
    "expand_grid_3layer",
    "envelope_config",
    "init_stacked_params",
    "sweep_fit",
    "sweep_fit_serial",
    "sweep_fit_serial_streamed",
    "extract_config_params",
    "embed_config_params",
    "marginal_report",
    "save_loss_comparisons",
    "config_pred_times",
]


# ---------------------------------------------------------------------------
# config grids
# ---------------------------------------------------------------------------


def expand_grid_2layer(sw: SweepConfig) -> Tuple[List[ModelConfig], Tuple[int, ...]]:
    """manual_scan.py grid: (ker1, ker2, ker3, conv1, conv2)."""
    cfgs = [
        ModelConfig(filters=(c1, c2), kernels=(k1, k2), out_kernel=k3)
        for k1, k2, k3, c1, c2 in itertools.product(
            sw.ker1_vals, sw.ker2_vals, sw.ker3_vals, sw.conv1_vals, sw.conv2_vals
        )
    ]
    shape = (
        len(sw.ker1_vals), len(sw.ker2_vals), len(sw.ker3_vals),
        len(sw.conv1_vals), len(sw.conv2_vals),
    )
    return cfgs, shape


def expand_grid_3layer(sw: SweepConfig) -> Tuple[List[ModelConfig], Tuple[int, ...]]:
    """manual_scan_3layers.py grid: (ker, conv1, conv2, conv3), from the
    ``*_3layer`` axes (manual_scan_3layers.py:119-123; the shipped scan is
    the single deep3 config)."""
    kers = list(sw.ker_vals_3layer)
    cfgs = [
        ModelConfig(filters=(c1, c2, c3), kernels=(k, k, k), out_kernel=k)
        for k, c1, c2, c3 in itertools.product(
            kers, sw.conv1_vals_3layer, sw.conv2_vals_3layer, sw.conv3_vals_3layer
        )
    ]
    shape = (len(kers), len(sw.conv1_vals_3layer),
             len(sw.conv2_vals_3layer), len(sw.conv3_vals_3layer))
    return cfgs, shape


def envelope_config(configs: Sequence[ModelConfig]) -> ModelConfig:
    """The smallest architecture that contains every config of the sweep.
    Kernels must be odd (an even kernel centred in a larger one computes a
    shifted conv under 'same' padding) and depths equal."""
    for c in configs:
        for k in (*c.kernels, c.out_kernel):
            if k[0] % 2 == 0 or k[1] % 2 == 0:
                raise ValueError(
                    f"sweep kernels must be odd for exact envelope embedding; got {k}"
                )
    depth = {c.depth for c in configs}
    if len(depth) != 1:
        raise ValueError("all sweep configs must share depth")
    d = depth.pop()
    filters = tuple(max(c.filters[i] for c in configs) for i in range(d))
    kernels = tuple(
        (max(c.kernels[i][0] for c in configs), max(c.kernels[i][1] for c in configs))
        for i in range(d)
    )
    out_kernel = (max(c.out_kernel[0] for c in configs),
                  max(c.out_kernel[1] for c in configs))
    return ModelConfig(filters=filters, kernels=kernels, out_kernel=out_kernel,
                       input_shape=configs[0].input_shape)


# ---------------------------------------------------------------------------
# masked parameter embedding
# ---------------------------------------------------------------------------


def _layer_geometry(cfg: ModelConfig):
    """Per layer (name, kernel, cin, cout) in module order, under the JAX
    package's layer names."""
    geo = []
    cin = cfg.input_shape[-1]
    for i in range(cfg.depth):
        geo.append((f"enc_conv{i}", cfg.kernels[i], cin, cfg.filters[i]))
        cin = cfg.filters[i]
    for i in reversed(range(cfg.depth)):
        geo.append((f"dec_deconv{i}", cfg.kernels[i], cin, cfg.filters[i]))
        cin = cfg.filters[i]
    geo.append(("out_conv", cfg.out_kernel, cin, 1))
    return geo


def _key(name: str) -> str:
    """The module's state_dict prefix of a JAX layer name."""
    if name.startswith("enc_conv"):
        return f"enc_convs.{name[len('enc_conv'):]}"
    if name.startswith("dec_deconv"):
        return f"dec_deconvs.{name[len('dec_deconv'):]}"
    return name


def _to_port(name: str, hwio: np.ndarray) -> np.ndarray:
    """An HWIO kernel in the module's layout: a conv's (out, in, kh, kw), a
    transposed conv's torch kernel (in, out, kh, kw), flipped in space as
    ``models/convert.py`` flips Flax's."""
    if name.startswith("dec_deconv"):
        return hwio[::-1, ::-1].transpose(2, 3, 0, 1)
    return hwio.transpose(3, 2, 0, 1)


def _glorot(rng: np.random.Generator, shape) -> np.ndarray:
    """Keras/Flax glorot_uniform on an HWIO conv kernel: fan from the
    receptive field x channels."""
    kh, kw, cin, cout = shape
    fan_in, fan_out = kh * kw * cin, kh * kw * cout
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def _placed(big_shape, small, off):
    out = np.zeros(big_shape, np.float32)
    out[tuple(slice(o, o + s) for o, s in zip(off, small.shape))] = small
    return out


def init_stacked_params(configs: Sequence[ModelConfig], env: ModelConfig, seed: int = 0,
                        device="cpu", first: int = 0):
    """(stacked params, stacked masks), state_dict keys to tensors (n_cfg,
    ...): each config drawn at its own geometry (its glorot fan; the JAX
    package's numpy draws in HWIO), centred in the envelope's kernel
    window, in its leading channels, zero elsewhere.  ``configs`` are the
    grid's from index ``first`` on (a rank's slice of a sharded grid): a
    config's draws depend on its index in the whole grid."""
    env_geo = {g[0]: (g[1], g[2], g[3]) for g in _layer_geometry(env)}
    p_stack: Dict[str, List[np.ndarray]] = {}
    m_stack: Dict[str, List[np.ndarray]] = {}
    for ci, cfg in enumerate(configs, start=first):
        rng = np.random.default_rng(seed * 100_003 + ci)
        for name, k, cin, cout in _layer_geometry(cfg):
            ek, ecin, ecout = env_geo[name]
            big_k = (ek[0], ek[1], ecin, ecout)
            off = ((ek[0] - k[0]) // 2, (ek[1] - k[1]) // 2, 0, 0)
            kern = _placed(big_k, _glorot(rng, (k[0], k[1], cin, cout)), off)
            kmask = _placed(big_k, np.ones((k[0], k[1], cin, cout), np.float32), off)
            bmask = _placed((ecout,), np.ones(cout, np.float32), (0,))
            key = _key(name)
            for stack, w, b in ((p_stack, kern, np.zeros(ecout, np.float32)),
                                (m_stack, kmask, bmask)):
                stack.setdefault(key + ".weight", []).append(_to_port(name, w))
                stack.setdefault(key + ".bias", []).append(b)

    def tensors(stack):
        return {k: torch.from_numpy(np.ascontiguousarray(np.stack(v))).to(device)
                for k, v in stack.items()}

    return tensors(p_stack), tensors(m_stack)


def _window(name: str, k, cin: int, cout: int, ek) -> Tuple[slice, ...]:
    """The slice of one config's weight in the envelope's (port-layout)
    weight: its channels and its centred kernel window."""
    oh, ow = (ek[0] - k[0]) // 2, (ek[1] - k[1]) // 2
    ch = (slice(0, cin), slice(0, cout)) if name.startswith("dec_deconv") \
        else (slice(0, cout), slice(0, cin))
    return (*ch, slice(oh, oh + k[0]), slice(ow, ow + k[1]))


def extract_config_params(stacked, idx: int, cfg: ModelConfig, env: ModelConfig):
    """Config ``idx`` cropped out of the stacked envelope: a ``state_dict``
    for ``make_model(cfg)`` (the crop is the mask's support)."""
    env_geo = {g[0]: g[1] for g in _layer_geometry(env)}
    out = {}
    for name, k, cin, cout in _layer_geometry(cfg):
        key = _key(name)
        w = stacked[key + ".weight"][idx]
        out[key + ".weight"] = w[_window(name, k, cin, cout, env_geo[name])].clone()
        out[key + ".bias"] = stacked[key + ".bias"][idx][:cout].clone()
    return out


def embed_config_params(stacked, idx: int, cfg: ModelConfig, env: ModelConfig, params):
    """Inverse of ``extract_config_params``: a new stacked dict whose config
    ``idx`` is ``params`` (a ``state_dict`` of ``cfg``) placed as at init,
    zero outside its window and channels."""
    env_geo = {g[0]: g[1] for g in _layer_geometry(env)}
    out = dict(stacked)
    for name, k, cin, cout in _layer_geometry(cfg):
        key = _key(name)
        for suffix in (".weight", ".bias"):
            full = stacked[key + suffix].clone()
            slot = torch.zeros_like(full[idx])
            src = params[key + suffix].to(slot.device, slot.dtype)
            if suffix == ".weight":
                slot[_window(name, k, cin, cout, env_geo[name])] = src
            else:
                slot[:cout] = src
            full[idx] = slot
            out[key + suffix] = full
    return out


# ---------------------------------------------------------------------------
# the envelope engine
# ---------------------------------------------------------------------------


@dataclass
class SweepResult:
    configs: List[ModelConfig]
    env: ModelConfig
    val_losses: np.ndarray  # (n_cfg,) final-epoch val loss
    train_history: np.ndarray  # (epochs, n_cfg)
    val_history: np.ndarray  # (epochs, n_cfg)
    best_index: int
    best_params: dict  # state_dict of the best config
    stacked_params: dict
    masks: dict


def _require_tune(x_val) -> None:
    if x_val is None or len(x_val) == 0:
        raise ValueError(
            "sweep requires a non-empty tune split (x_val/y_val): final "
            "val_loss drives model selection (manual_scan.py:216-224); "
            "sample more shots or adjust split fractions"
        )


def _envelope_logits(p: Dict[str, torch.Tensor], env: ModelConfig, n: int,
                     x: torch.Tensor, dtype) -> torch.Tensor:
    """Every config's logits at once, (B, n, H, W) float32, from (B, H, W)
    tiles and the (masked) stacked parameters: the first conv reads the
    shared input with all n configs' filters, every later layer is a
    grouped conv with one group per config.  Computed in ``dtype``, each
    weight and bias cast to it (as ``Conv2dSame``)."""
    def w_b(key):
        w, b = p[key + ".weight"], p[key + ".bias"]
        return w.reshape(-1, *w.shape[2:]).to(dtype), b.reshape(-1).to(dtype)

    h = x[:, None].to(dtype)
    for i in range(env.depth):
        w, b = w_b(f"enc_convs.{i}")
        kh, kw = w.shape[-2:]
        h = F.conv2d(h, w, b, padding=(kh // 2, kw // 2), groups=1 if i == 0 else n)
        h = F.max_pool2d(F.relu(h), 2)
    for i in reversed(range(env.depth)):
        w, b = w_b(f"dec_deconvs.{i}")
        h = F.relu(conv_transpose_same(h, w, b, groups=n))
    w, b = w_b("out_conv")
    kh, kw = w.shape[-2:]
    return F.conv2d(h, w, b, padding=(kh // 2, kw // 2), groups=n).float()


def _config_bce(z: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(n,) masked mean BCE of each config's logits z (B, n, H, W) against
    y (B, H, W): ``train.bce_from_logits`` per config."""
    y = y[:, None]
    per = z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))
    w = mask.reshape(-1, 1, 1, 1).to(per.dtype)
    return (per * w).sum(dim=(0, 2, 3)) / (w.sum() * per[0, 0].numel())


def _opt_slice(sd: dict, lo: int, hi: int) -> dict:
    """An optimizer ``state_dict`` of stacked tensors cut to configs
    ``lo:hi`` (every state tensor with a config axis)."""
    state = {i: {k: (v[lo:hi] if torch.is_tensor(v) and v.ndim else v) for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def _whole_grid(ex, params, tr_hist, va_hist, opt=None, masks=None) -> Optional[dict]:
    """The whole grid's stacked parameters and histories (with ``opt``
    Adam's state too: a checkpoint, as the unsharded sweep writes it; with
    ``masks`` the masks): on a mesh every rank's slice gathered onto rank
    0, None elsewhere."""
    def whole(t, dim=0):
        return t if ex is None else gather_blocks(ex, t.contiguous(), dim)

    n_mine = next(iter(params.values())).shape[0]
    out = {"params": {k: whole(p.detach()) for k, p in params.items()}}
    if masks is not None:
        out["masks"] = {k: whole(m) for k, m in masks.items()}
    for key, h in (("tr_hist", tr_hist), ("va_hist", va_hist)):
        out[key] = whole(torch.from_numpy(np.asarray(h, np.float64).reshape(len(h), n_mine)), 1)
    if opt is not None:
        sd = opt.state_dict()
        state = {i: {k: whole(v) if torch.is_tensor(v) and v.ndim else v for k, v in st.items()}
                 for i, st in sd["state"].items()}
        out["optimizer"] = {"state": state, "param_groups": sd["param_groups"]}
    return None if ex is not None and ex.rank else out


def sweep_fit(
    configs: Sequence[ModelConfig],
    x_train,
    y_train,
    x_val,
    y_val,
    train_cfg: TrainConfig = TrainConfig(),
    epochs: Optional[int] = None,
    mesh=None,
    sweep_axis: str = "sweep",
    dtype=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    verbose: bool = False,
    device="cuda",
) -> Optional[SweepResult]:
    """Train every config at once in the masked envelope (see the module
    docstring) on ``device``: one shuffle stream, batches of
    ``train_cfg.batch_size``, the loss the sum of the per-config masked
    BCEs, one Adam (Keras eps) over the stacked tensors; a batched
    validation pass per epoch.

    ``mesh`` (a ``parallel.mesh.Mesh`` whose axis is ``sweep_axis``)
    shards the config axis: a grid that does not divide over the ranks is
    padded with copies of the last config (trained, then trimmed from the
    result), and each rank trains its contiguous slice of the padded grid
    at the whole grid's envelope, on its device, from the draws the
    unsharded sweep gives those configs, replaying the same shuffle
    stream.  Configs are independent, so a step needs no collective; the
    ranks agree once an epoch whether every config is stale, and a
    checkpoint gathers the whole grid onto rank 0, which writes it.  The
    result is gathered onto rank 0; the other ranks return None.

    ``dtype=torch.bfloat16`` computes the envelope in bf16 (parameters and
    Adam float32), the ``--bf16`` mode.  With ``checkpoint_dir`` every
    epoch saves the stacked parameters, Adam's state and the histories
    (``epoch_NNNN/state.pt``) and ``run_meta.json`` (with the grid's
    fingerprint; the padded grid's on a mesh); ``resume=True`` continues
    from the latest epoch with the shuffle stream replayed, each rank from
    its slice.  ``train_cfg.patience`` stops the sweep when every config
    has gone that many epochs without improving its own best val loss."""
    _require_tune(x_val)
    epochs = train_cfg.epochs if epochs is None else epochs
    dtype = torch.float32 if dtype is None else dtype
    n_real = len(configs)
    ex, lo, hi, lead, dev = None, 0, n_real, True, torch.device(device)
    if mesh is not None:
        from specenh_torch.parallel.collectives import exchange_for

        if tuple(mesh.axis_names) != (sweep_axis,):
            raise ValueError(f"sweep_fit shards its configs over a {sweep_axis!r} mesh, not "
                             f"{tuple(mesh.axis_names)}")
        ex = exchange_for(mesh)
        configs = list(configs) + [configs[-1]] * ((-n_real) % ex.size)
        per = len(configs) // ex.size
        lo, hi, lead, dev = ex.rank * per, (ex.rank + 1) * per, ex.rank == 0, mesh.device
    n_cfg, n_mine = len(configs), hi - lo
    env = envelope_config(configs)
    params, masks = init_stacked_params(configs[lo:hi], env, train_cfg.seed, dev, first=lo)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()), lr=train_cfg.learning_rate,
                           betas=(train_cfg.beta1, train_cfg.beta2), eps=train_cfg.adam_eps)

    def masked():
        return {k: params[k] * masks[k] for k in params}

    x_train, y_train = _as_tiles(x_train, dev), _as_tiles(y_train, dev)
    x_val, y_val = _as_tiles(x_val, dev), _as_tiles(y_val, dev)
    n = x_train.shape[0]
    bs = min(train_cfg.batch_size, n)
    rng = np.random.default_rng(train_cfg.seed)
    if checkpoint_dir:
        checkpoint_dir = os.path.abspath(checkpoint_dir)
    run_meta = {
        "n": int(n), "seed": int(train_cfg.seed), "batch_size": int(bs),
        "shuffle": bool(train_cfg.shuffle), "n_configs": n_cfg,
        # the grid's fingerprint: a reordered or edited grid of the same
        # count and envelope would restore its slices under the wrong masks
        "grid": [json.dumps(dataclasses.asdict(c), sort_keys=True, default=str)
                 for c in configs],
    }

    tr_hist: List[np.ndarray] = []
    va_hist: List[np.ndarray] = []
    start_epoch = 0
    if resume and checkpoint_dir:
        last = latest_checkpoint_epoch(checkpoint_dir)
        if last is not None:
            check_run_meta(checkpoint_dir, run_meta, optional_keys=("grid",))
            ck = torch.load(os.path.join(checkpoint_dir, f"epoch_{last:04d}", "state.pt"),
                            map_location=dev, weights_only=True)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(ck["params"][k][lo:hi])
            opt.load_state_dict(_opt_slice(ck["optimizer"], lo, hi))
            tr_hist = list(ck["tr_hist"].cpu().numpy()[:, lo:hi])
            va_hist = list(ck["va_hist"].cpu().numpy()[:, lo:hi])
            start_epoch = last + 1
            for _ in range(start_epoch):  # replay the shuffle stream
                if train_cfg.shuffle:
                    rng.permutation(n)
            if verbose and lead:
                print(f"sweep resumed from epoch {last}")
    if ex is not None:
        from specenh_torch.parallel.data_parallel import barrier

        barrier(mesh)  # every rank has read the checkpoint directory before rank 0 writes
    if checkpoint_dir and lead:
        write_run_meta(checkpoint_dir, run_meta)

    # opt-in early stopping: the envelope trains every config in lockstep,
    # so the sweep stops only when EVERY config has gone `patience` epochs
    # without improving its own best val loss (on a mesh, every rank's)
    if train_cfg.patience is not None:
        best_vals = (np.min(np.asarray(va_hist), axis=0) if va_hist
                     else np.full(n_mine, np.inf))
        stales = np.zeros(n_mine, int)
        if va_hist:
            stales = len(va_hist) - 1 - np.argmin(np.asarray(va_hist), axis=0)

    nv = x_val.shape[0]
    val_idx, val_mask = _epoch_batches(nv, min(bs, nv), np.arange(nv))
    val_idx_t, val_mask_t = torch.from_numpy(val_idx).to(dev), torch.from_numpy(val_mask).to(dev)
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        perm = rng.permutation(n) if train_cfg.shuffle else np.arange(n)
        batch_idx, batch_mask = _epoch_batches(n, bs, perm)
        bi, bm = torch.from_numpy(batch_idx).to(dev), torch.from_numpy(batch_mask).to(dev)
        losses = []
        for idx, m in zip(bi, bm):
            opt.zero_grad(set_to_none=True)
            loss = _config_bce(_envelope_logits(masked(), env, n_mine, x_train[idx], dtype),
                               y_train[idx], m)
            loss.sum().backward()
            opt.step()
            losses.append(loss.detach())
        tr_hist.append(weighted_epoch_mean(torch.stack(losses), batch_mask))
        with torch.no_grad():
            mp = masked()
            v = torch.stack([_config_bce(_envelope_logits(mp, env, n_mine, x_val[idx], dtype),
                                         y_val[idx], m)
                             for idx, m in zip(val_idx_t, val_mask_t)])
        va_hist.append(weighted_epoch_mean(v, val_mask))  # (n_mine,)
        if verbose and lead:
            mine = "" if ex is None else f" (configs {lo}-{hi - 1} of {n_cfg})"
            print(f"epoch {epoch + 1}/{epochs} val={np.array2string(va_hist[-1], precision=4)}"
                  f"{mine} ({time.perf_counter() - t0:.2f}s)")
        if checkpoint_dir:
            ck = _whole_grid(ex, params, tr_hist, va_hist, opt)
            if lead:
                d = os.path.join(checkpoint_dir, f"epoch_{epoch:04d}")
                os.makedirs(d, exist_ok=True)
                torch.save(ck, os.path.join(d, "state.pt"))
        if train_cfg.patience is not None:
            v = np.asarray(va_hist[-1])
            improved = v < best_vals
            best_vals = np.minimum(best_vals, v)
            stales = np.where(improved, 0, stales + 1)
            stop = bool((stales >= train_cfg.patience).all())
            if ex is not None:  # one decision for the whole grid
                stop = bool(ex.reduce(torch.tensor([float(stop)]), "min").item())
            if stop:
                if verbose and lead:
                    print(f"early stopping: every config stale for "
                          f"{train_cfg.patience} epochs")
                break

    out = _whole_grid(ex, params, tr_hist, va_hist, masks=masks)
    if not lead:
        return None
    # the grid's padding (copies of its last config) trimmed
    stacked = {k: p[:n_real].cpu() for k, p in out["params"].items()}
    masks = {k: m[:n_real].cpu() for k, m in out["masks"].items()}
    configs = list(configs[:n_real])
    train_history, val_history = (h.numpy()[:, :n_real] for h in (out["tr_hist"],
                                                                   out["va_hist"]))
    val_losses = val_history[-1]
    best = int(np.argmin(val_losses))
    return SweepResult(
        configs=configs,
        env=env,
        val_losses=val_losses,
        train_history=train_history,
        val_history=val_history,
        best_index=best,
        best_params=extract_config_params(stacked, best, configs[best], env),
        stacked_params=stacked,
        masks=masks,
    )


# ---------------------------------------------------------------------------
# the serial engine
# ---------------------------------------------------------------------------


def _serial_engine(cfg: ModelConfig, train_cfg: TrainConfig, dtype, mesh):
    """A config's epoch engine: the CUDA training kernels where a kernel
    family covers its geometry (on a mesh ``dp_kernel_epoch_for``), else
    None (the module's autograd engine)."""
    if not (supports(cfg) or supports3(cfg)):
        return None
    if mesh is None:
        return kernel_epoch_for(cfg, train_cfg, dtype=dtype)
    from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for

    return dp_kernel_epoch_for(cfg, train_cfg, mesh, dtype=dtype)


def sweep_fit_serial(
    configs: Sequence[ModelConfig],
    x_train,
    y_train,
    x_val,
    y_val,
    train_cfg: TrainConfig = TrainConfig(),
    epochs: Optional[int] = None,
    dtype=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    mesh=None,
    verbose: bool = False,
    device="cuda",
) -> SweepResult:
    """One ``train.fit`` per config, each at its own geometry's cost: on
    the CUDA training kernels (``kernel_epoch_for``, bf16 unless ``dtype``
    says otherwise) where ``ae_kernel.kernel_depth`` covers the geometry,
    else on the module's autograd engine computing in ``dtype`` (None:
    float32).  Each starts from the envelope's glorot draws
    (``init_stacked_params``) and replays the same shuffle stream, so the
    trajectories follow ``sweep_fit``'s to the engines' precision.

    ``mesh`` (a ``parallel.mesh.Mesh`` over the "data" axis) trains each
    config data-parallel through ``parallel.dp_fit`` on the rank's device
    (the kernels through ``dp_kernel_epoch_for``; the batch is global):
    the complement of ``sweep_fit(mesh=)``, which shards the configs.
    Every rank returns the result; rank 0 writes the checkpoints.

    With ``checkpoint_dir`` each config checkpoints and resumes its own fit
    under ``cfg_<i>/``.  Configs stopped early by ``train_cfg.patience``
    pad their histories with their last value.  The final parameters are
    embedded back into the stacked envelope."""
    _require_tune(x_val)
    epochs = train_cfg.epochs if epochs is None else epochs
    dev = torch.device(device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    env = envelope_config(configs)
    stacked, masks = init_stacked_params(configs, env, train_cfg.seed)
    if mesh is None:
        x_train, y_train = _as_tiles(x_train, dev), _as_tiles(y_train, dev)
        x_val, y_val = _as_tiles(x_val, dev), _as_tiles(y_val, dev)
    tr_hist, va_hist, finals = [], [], []
    for ci, cfg in enumerate(configs):
        state = create_state(cfg, train_cfg, device=dev, dtype=dtype)
        state.model.load_state_dict(extract_config_params(stacked, ci, cfg, env))
        epoch_fn = _serial_engine(cfg, train_cfg, dtype, mesh)
        ckpt_i = os.path.join(checkpoint_dir, f"cfg_{ci:03d}") if checkpoint_dir else None
        if mesh is None:
            state, hist = fit(state, x_train, y_train, x_val, y_val, cfg=train_cfg,
                              epochs=epochs, epoch_fn=epoch_fn, checkpoint_dir=ckpt_i,
                              resume=resume, verbose=verbose)
        else:
            from specenh_torch.parallel.data_parallel import dp_fit

            state, hist = dp_fit(state, x_train, y_train, mesh, x_val, y_val, epochs=epochs,
                                 batch_size=train_cfg.batch_size, seed=train_cfg.seed,
                                 shuffle=train_cfg.shuffle, epoch_fn=epoch_fn,
                                 checkpoint_dir=ckpt_i, resume=resume,
                                 patience=train_cfg.patience, verbose=verbose)
        if verbose and lead:
            print(f"config {ci + 1}/{len(configs)} ({'kernel' if epoch_fn else 'module'}) "
                  f"val={hist['val_loss'][-1]:.5f}")
        tr_hist.append(hist["loss"])
        va_hist.append(hist["val_loss"])
        params = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        finals.append(params)
        stacked = embed_config_params(stacked, ci, cfg, env, params)
    return _serial_result(configs, env, tr_hist, va_hist, finals, stacked, masks)


def _serial_result(configs, env, tr_hist, va_hist, finals, stacked, masks) -> SweepResult:
    """The serial engines' result from each config's histories and final
    parameters; the best config has the lowest final val loss."""
    val_losses = np.asarray([h[-1] for h in va_hist])
    best = int(np.argmin(val_losses))
    # per-config early stopping leaves ragged histories: a stopped config
    # plateaus at its last loss
    L = max(len(h) for h in tr_hist)

    def pad(h):
        return list(h) + [h[-1]] * (L - len(h))

    return SweepResult(
        configs=list(configs),
        env=env,
        val_losses=val_losses,
        train_history=np.asarray([pad(h) for h in tr_hist]).T,
        val_history=np.asarray([pad(h) for h in va_hist]).T,
        best_index=best,
        best_params=finals[best],
        stacked_params=stacked,
        masks=masks,
    )


def sweep_fit_serial_streamed(
    configs: Sequence[ModelConfig],
    store,
    plan,
    train_cfg: TrainConfig = TrainConfig(),
    epochs: Optional[int] = None,
    dtype=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    mesh=None,
    chunk_tiles: int = 4096,
    cache_dtype: Optional[str] = None,
    tile_cache: Optional[str] = None,
    ps=None,
    verbose: bool = False,
    device="cuda",
) -> SweepResult:
    """``sweep_fit_serial`` over a streamed store: each config trains
    through ``train_stream.fit_streaming`` (chunked epochs, the host-RAM
    chunk cache, bf16 chunks and the on-disk tile cache, with which
    configs 2..N read no store data), for sweeps at the reference's
    largest recipe (the 200-shot ~31 GB tile set, manual_scan.py:137-156),
    which the resident engines cannot hold.  As in ``sweep_fit_serial``
    the geometry alone picks the CUDA training kernels or the module's
    autograd engine; every config starts from ``init_stacked_params``'s
    draws and checkpoints and resumes under ``cfg_<i>/``.  With
    ``shuffle=False`` and ``chunk_tiles >= n`` each config's trajectory is
    ``sweep_fit_serial``'s.  ``mesh`` (a "data" mesh) streams each config
    data-parallel (``fit_streaming(mesh=)``, the kernels through
    ``dp_kernel_epoch_for``), as ``train --stream --devices``; every rank
    returns the result."""
    from specenh_torch.config import PatchSpec
    from specenh_torch.train_stream import fit_streaming

    if plan.n_tiles("tune") == 0:
        raise ValueError(
            "sweep requires a non-empty tune split: final val_loss drives "
            "model selection (manual_scan.py:216-224); this plan's tune "
            "split has zero tiles — sample more shots or adjust split "
            "fractions"
        )
    ps = PatchSpec() if ps is None else ps
    epochs = train_cfg.epochs if epochs is None else epochs
    dev = torch.device(device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    env = envelope_config(configs)
    stacked, masks = init_stacked_params(configs, env, train_cfg.seed)
    tr_hist, va_hist, finals = [], [], []
    for ci, cfg in enumerate(configs):
        state = create_state(cfg, train_cfg, device=dev, dtype=dtype)
        state.model.load_state_dict(extract_config_params(stacked, ci, cfg, env))
        epoch_fn = _serial_engine(cfg, train_cfg, dtype, mesh)
        ckpt_i = os.path.join(checkpoint_dir, f"cfg_{ci:03d}") if checkpoint_dir else None
        state, hist = fit_streaming(
            state, store, plan, train_cfg, epochs=epochs, chunk_tiles=chunk_tiles, ps=ps,
            epoch_fn=epoch_fn, mesh=mesh, cache_dtype=cache_dtype, tile_cache=tile_cache,
            checkpoint_dir=ckpt_i, resume=resume, verbose=verbose,
        )
        if verbose and lead:
            print(f"config {ci + 1}/{len(configs)} ({'kernel' if epoch_fn else 'module'}, "
                  f"streamed) val={hist['val_loss'][-1]:.5f}")
        tr_hist.append(hist["loss"])
        va_hist.append(hist["val_loss"])
        params = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        finals.append(params)
        stacked = embed_config_params(stacked, ci, cfg, env, params)
    return _serial_result(configs, env, tr_hist, va_hist, finals, stacked, masks)


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------


def marginal_report(
    values: np.ndarray, grid_shape: Tuple[int, ...], names: Sequence[str]
) -> Dict[str, np.ndarray]:
    """Per-parameter marginal means over all other axes
    (manual_scan.py:302-364): {name: (len_axis, 1) array}."""
    grid = np.asarray(values).reshape(grid_shape)
    out = {}
    for ax, name in enumerate(names):
        other = tuple(i for i in range(grid.ndim) if i != ax)
        out[name] = grid.mean(axis=other)[:, None]
    return out


def save_loss_comparisons(
    path: str,
    val_losses: np.ndarray,
    pred_times: np.ndarray,
    grid_shape: Tuple[int, ...],
    axis_names: Sequence[str],
):
    """``loss_comparisons.npz`` with the reference's key scheme
    (manual_scan.py:361-364): <axis>_loss and <axis>_time."""
    loss_m = marginal_report(val_losses, grid_shape, axis_names)
    time_m = marginal_report(pred_times, grid_shape, axis_names)
    np.savez(
        path,
        **{f"{n}_loss": v for n, v in loss_m.items()},
        **{f"{n}_time": v for n, v in time_m.items()},
    )


def config_pred_times(res: SweepResult, tiles, device="cuda", iters: int = 8) -> np.ndarray:
    """Seconds per tile of each config's predictor on ``tiles``
    (manual_scan.py:226-248): the config cropped out of the stacked
    envelope and served by ``bench.harness.make_production_predict_fn``
    (the AE kernels where a family covers it, bf16), its weights prepared
    once; ``iters`` calls after a synchronized warm-up, then one
    synchronization (``torch.cuda.synchronize`` on a CUDA device)."""
    from specenh_torch.bench.harness import make_production_predict_fn

    dev = torch.device(device)
    tiles = _as_tiles(tiles, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = np.zeros(len(res.configs))
    for ci, mc in enumerate(res.configs):
        model = make_model(mc, generator=torch.Generator().manual_seed(0), device=dev)
        model.load_state_dict(extract_config_params(res.stacked_params, ci, mc, res.env))
        f = make_production_predict_fn(mc, device=dev)
        wts = f.prepare(model)
        f(wts, tiles)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            f(wts, tiles)
        sync()
        out[ci] = (time.perf_counter() - t0) / iters / tiles.shape[0]
    return out
