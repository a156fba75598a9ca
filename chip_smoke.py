#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU, for the flagship depth-2 AE and the deep3 depth-3 AE.

    python3 chip_smoke.py          # from the repo root, on a machine with an H100

Phases, each of which raises on failure (no CPU fallback, nothing caught):

1. the device: a CUDA device must be present; prints its name and power
   limit and turns TF32 off, so the plain float32 references are float32;
2. builds every kernel from ``specenh_torch/csrc`` with nvcc, in parallel,
   and prints each library's ptxas registers and spills, and each
   instantiation of the tensor-core templates ``conv_igemm_kernel``,
   ``convt_igemm_kernel``, ``conv_out_mma_kernel`` (with its epilogue: the
   serving S4's sigmoid, the training loss) and ``conv_in_mma_kernel``
   (with its source and epilogue: S1, conv 0, the out-conv's gradient);
3. each kernel against its plain PyTorch twin at the serving path's shapes
   (a 20-channel, 2 s shot; the flagship AE), and the whole AE in float32
   and bf16, plus the k7 and (64, 32)/k5 geometries on one channel; each
   stage launch on the conv template its dtype and channels choose (bf16
   S1 on ``conv_in_mma_kernel``, bf16 S2 on ``conv_igemm_kernel``, bf16 S3
   on ``convt_igemm_kernel``, bf16 S4 on ``conv_out_mma_kernel``, float32
   S3 on ``convt_relu_kernel``, float32 convs on ``conv_quad_kernel``, from
   the libraries' per-template launch counts); at every out-conv geometry
   (k1 to k7, 16 to 64 channels, an out_kernel apart from the encoder's) on
   one channel, after the stage kernels' chain: S4 in bf16 within TOL_F32
   of its twin, and S1 in bf16 within one bf16 ulp of its twin, and
   ``ae_tile_in_norm`` in both layouts within one ulp of its twin and bit
   for bit ``ae_tile_in``;
4. the service ``make_enhance_shot_fn(dtype=bfloat16)`` on three synthetic
   shots, with the repo's two gates: spectrogram SSIM >= 0.99 against the
   SciPy recipe, enhanced SSIM >= 0.999 against the plain float32 service
   on every channel; every kernel must have launched during it, every S1
   launch on ``conv_in_mma_kernel``, every S2 launch on
   ``conv_igemm_kernel``, every S3 launch on ``convt_igemm_kernel`` and
   every S4 launch on ``conv_out_mma_kernel``;
5. CUDA-event timings of each kernel and its twin, ms/shot, spectrograms/s
   and peak device memory;
6. phases 3-5 for the deep3 preset (filters (16, 32, 64), k5): every stage
   against its twin in bf16 and float32 at the same shapes, the whole AE
   (and (64, 32, 64)/k7 on one channel), the bf16 service on three shots
   with both gates, and its timings;
7a. the dataset build (``pipeline.process_shot_fn``: K1, then the
   classical label pipeline of ``ops.enhance``) on one 20-channel, 2 s
   shot, counted (K1 once, no other kernel): the specs bit for bit
   ``spectrogram_fused``, the labels within TOL_LABELS_CPU of the same
   functions on the CPU and at SSIM >= 0.999 against ``pipeline_ref`` on
   three channels (at most 0.01 % of pixels off by > 1e-4); each stage's
   CUDA-event time, the whole function's ms/shot and specs/s, the label
   pipeline's byte bound and the peak memory; two SPEC binaries read
   through ``NativePrefetcher`` (which reader ran is printed) give the
   in-memory shots' specs and labels bit for bit;
7. the training data: 20 synthetic shots x 20 channels through
   ``process_shot_fn`` on the card, specs and the pipeline's labels
   patched, 12 000 tiles split 60/25/15;
8. each training kernel (K5 and K5b entry points) against its plain twin,
   stage by stage on the same inputs, on one 128-tile batch of the
   flagship in bf16 and float32, and k5, k7 and (64, 32)/k5 on 4 tiles;
   each launch on its conv template (in bf16 conv 0 and the out-conv's
   input gradient on ``conv_in_mma_kernel``, the encoder convs' forward
   and routed input gradient on ``conv_igemm_kernel``, the transposed
   convs' forward on ``convt_igemm_kernel``, the loss on
   ``conv_out_mma_kernel``; in float32 every stride-1 conv on
   ``conv_quad_kernel``); conv 0's routing bits equal the float64 bits
   but in the near ties ``route_bits64`` counts;
   for each in float32 the whole kernel chain against the twins' whole
   chain, the twins' backward on their own forward and on the kernels'
   (the pool windows and relu gates the forwards gate differently are
   counted); the kernels' loss and gradients against torch autograd of
   the module; two runs of a bf16 step bit for bit;
9. ``train.fit`` on the reference recipe (phase 7's tiles and labels):
   3 epochs on the kernel engine
   (bf16, K5), 1 epoch of K5 and 1 of K5b (``pre_layout=True``) from the
   same weights, which must agree bit for bit; the float32 reference:
   3 epochs of autograd on cuDNN's deterministic algorithms, twice, which
   must agree bit for bit (losses and parameters); beside it the bf16
   autograd engine and the float32 kernel engine, printed; both losses
   must fall; the loss-curve gate on the pipeline's labels: per epoch the
   bf16 kernels within max(0.1 %, TOL_PIPE_CURVE x the bf16 autograd
   engine's gap) of the deterministic float32 run; the loss-curve gate
   (per epoch within 0.1 % of float32 autograd) on the stand-in labels
   clip(0.8 x + 0.1, 0, 1), 3 epochs of each engine on the same tiles;
   every training kernel must have launched in the kernel runs, all on the
   tensor cores (none on ``conv_quad_kernel``): the encoder convs' forward
   and input gradients on ``conv_igemm_kernel``, the transposed convs'
   forward on ``convt_igemm_kernel``, conv 0 and the out-conv's input
   gradient on ``conv_in_mma_kernel``, the loss on
   ``conv_out_mma_kernel``, and a step's sums in one ``ae_train_sum``
   call;
10. timings: each training kernel per 128-tile step beside its twin, the
   one PyTorch call that computes the same function and its bound (the
   out-conv's and the encoder convs' ``ae_train_dgrad_conv`` also apart,
   each beside ``conv2d_input``; ``ae_train_sum`` as a step's one batched
   call over its partial arrays, beside ``torch.sum`` over each, and both
   devices' times from torch.profiler; a step's stages with its sums in
   one call and with per-call sums, in turns); s/epoch,
   tiles/s and the peak memory of a step for each engine, the bf16
   autograd engine (``create_state(dtype=bfloat16)``) among them, whose
   epoch must give finite, falling losses;
11. phases 8-10 for deep3 (K7): its stages against their twins on one
   128-tile batch in bf16 and float32, (64, 32, 64)/k7 and (48, 48, 64)/k3
   on 4 tiles, the whole chains, gradients against autograd, two runs of
   a step bit for bit; 2 epochs of
   ``fit`` on the kernel engine (bf16) and on deterministic autograd
   (float32, twice) from the same weights on the pipeline's labels
   (falling, both gates as in phase 9); the timings.
12. (run after phase 5) the service's other STFT fronts on the flagship:
   (a) K1 in the (T, F) layout against its twin and bit for bit the (F, T)
   output transposed; (b) ``ae_tile_in_norm`` (K9 and K10) in both layouts,
   bf16 and float32, against its twin and bit for bit ``ae_tile_in`` on
   the normalized spectrograms, at the flagship and at k5, k7 and
   (64, 32)/k5 on one channel; (c) the service in ``stft_mode`` "fused",
   "fused_ft" and "xla" on phase 4's three shots, counted and gated as
   "auto", "fused" and "fused_ft" bit for bit "auto", and K10's route (the
   raw (F, T) log-PSD into ``ae_kernel_enhance_raw``); (d) the three K11
   toolchain probes in process and through ``python -m
   specenh_torch.probe_walls``; (e) the new entry points' times beside
   their twins, library calls and bounds, and in float32 (both on
   ``conv_quad_kernel``) ``ae_tile_in`` beside ``ae_tile_in_norm`` in each
   layout; (f) ms/shot per ``stft_mode``.
13. (run after phase 6) a geometry no kernel family covers, (16, 32, 128)/k5,
   served in bf16 with ``use_kernel="auto"``: the module route on three
   shots, no serving kernel launched, gated as phase 4; its ms/shot.
14. (run after phase 11) hyperparameter sweeps (``specenh_torch.sweep``)
   on phase 7's tiles: (a) the kernel grid of hyperparam_scan.py:123
   ((32, 32) at k3, k5, k7) through ``sweep_fit_serial`` in bf16, 2
   epochs on the pipeline's labels, counted: every config's steps on the
   training kernels, losses falling; ``config_pred_times`` (the
   ``pred_times`` artifact: ``make_production_predict_fn`` on 30 tune
   tiles), counted: every config on the serving kernels; val_losses,
   best_index, loss_comparisons; each config's s/epoch, tiles/s and step
   memory; (b) the same for the 3layer default grid (deep3 alone); (c)
   the envelope engine ``sweep_fit`` (float32) on the kernel grid, 2
   epochs on 1024 train and 512 tune tiles with the stand-in labels,
   within TOL_LOSS_CURVE per config and epoch of the serial engine on the
   float32 and on the bf16 kernels, the same best config where the best
   two part by more than 10 x TOL_LOSS_CURVE, s/epoch of each (and of the
   bf16 envelope, printed); (d) a
   2layer grid with conv1 (16, 32) at k3, 1 epoch on the cut tiles: the
   16-filter config on the module engine, the 32-filter one on the
   kernels (one config's steps).  The kernels line counts these launches.
15. (run after phase 14) the analyses and the raw-to-model path: (a) the
   SVD denoiser (``ops.svd``) batched over 20 channels, on K1's
   spectrograms of the serving shot and on the headline's low-rank batch
   (headline.py:178-193): ``denoise_signal()`` and ``denoise_signal(
   use_optimal=True)`` against the float64 ``svd_denoise_ref`` on channel
   0 (SSIM >= 0.99), ``deflate_top1`` against the default band on the
   spectrograms, ``compute_signal`` against ``svd_compute_signal_ref`` on
   the well-conditioned gate matrix (SSIM >= 0.99); ms a spectrogram of
   each; on the spectrograms their device time split into eigh, QR and
   matmul (torch.profiler), cuSOLVER's batched eigh and
   ``torch.linalg.svd`` on the same batch;
   (b) ``ops.crosspower`` on two 2 s chords at 1.667 MHz sharing one line:
   the self-cross equals the PSD, the line stands over the floor; ms a
   call; (c) ``python -m specenh_torch.cli`` in process: ``synth-shots``
   (4 shots x 20 channels), ``convert-bin``, ``train-raw --binary --engine
   kernel`` for scan_k3 (2 epochs, val loss falling) and deep3 (1 epoch),
   counted: K1 once, every step on K5 or K7; ``model/`` written.  The
   kernels line counts these launches.

Prints a JSON line of the kernels, one row per pair of CUDA entry point and
TPU kernel it replaces, the card's name and power limit, then as its last
line ``{"ok": true, "device": {...}}``.  Weights are glorot-initialised
from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from specenh_torch import ModelConfig, SpecParams, TrainConfig, _build
from specenh_torch.bench.harness import (enhance_shot_plain, example_shot,
                                         make_enhance_shot_fn, time_cuda)
from specenh_torch.bench.reference import (HAS_CV2, pipeline_ref, spectrogram_ref, ssim,
                                           svd_compute_signal_ref, svd_denoise_ref)
from specenh_torch.config import MODEL_PRESETS, Config, SweepConfig
from specenh_torch.data.dataset import split_tiles, synthetic_shot_batch
from specenh_torch.data.tiles import patch
from specenh_torch.io.binfmt import write_shot_bin
from specenh_torch.io.native import NativePrefetcher, native_available
from specenh_torch.models.autoencoder import convt_pad_before, make_model
from specenh_torch.ops import enhance as EN
from specenh_torch.ops import ae3_train_kernel as TK3
from specenh_torch.ops import ae_kernel as AK
from specenh_torch.ops import ae_train_kernel as TK
from specenh_torch.ops import crosspower as CP
from specenh_torch.ops import stft_fused as SF
from specenh_torch.ops import svd as SVD
from specenh_torch.ops.stft import stft_psd
from specenh_torch import probe_walls as PW
from specenh_torch import sweep as SW
from specenh_torch import train as TR
from specenh_torch.pipeline import process_shot_fn

N_CHANNELS = 20
SEED = 0
# K1: a float32 FFT against the twin's float64 DFT; near psd*w ~ eps a
# relative error of the transform shows up as an absolute error of the log.
TOL_LOGPSD = 2e-3
TOL_SPECS = 5e-4
# Stages in bf16 round their outputs where the plain twin does; a sum on
# the other side of a rounding boundary moves one bf16 ulp: 2^-7 relative.
BF16_REL = 2.0 ** -7
TOL_F32 = 1e-4       # whole AE and float32 stages vs the float32 twin
TOL_BF16_MAX = 2e-2  # whole AE in bf16 vs the float32 twin: max |err|
TOL_BF16_MEAN = 1e-3  # ... and mean |err|
GATE_SPEC_SSIM = 0.99
GATE_ENH_SSIM = 0.999

# the dataset build (phase 7a): the card's labels against the same port
# functions on the CPU (the one order-dependent reduction, the row mean, is a
# float64 sum rounded once), and against the reference recipe (pipeline_ref)
TOL_LABELS_CPU = 1e-6
GATE_LABEL_SSIM = 0.999
TOL_LABELS_REF = 1e-4       # a pixel is "off" the reference beyond this
TOL_LABELS_REF_FRAC = 1e-4  # ... and at most 0.01 % of the pixels may be
N_REF_CHANNELS = 3

# training
N_SHOTS = 20         # hyperparam_scan.py:176-184: 20 shots x 20 channels
EPOCHS = 3
EPOCHS3 = 2          # deep3
EPOCHS_SWEEP = 2     # phase 14, each config
N_CUT, N_CUT_TUNE = 1024, 512  # phase 14 (c), (d): the envelope's and the mixed grid's cut
BATCH = 128          # one step of the recipe
TOL_GRAD_SUM = 1e-4  # a gradient sum vs its twin on the same inputs: f32 order
TOL_F32_REL = 1e-5   # a float32 stage vs its twin, relative to its scale
TOL_MASK_FRAC = 1e-4  # routing / relu masks may differ only on ties and zeros
TOL_AUTOGRAD_F32 = 1e-4  # float32 kernel gradients vs autograd, of max |g|
TOL_AUTOGRAD_BF16 = 5e-2  # bf16 kernel gradients vs f32 autograd, of max |g|
# bf16 kernel loss per epoch vs the f32 autograd run, relative: > 10x the
# spread seen on the card, well under the 2.2 % by which a model whose
# parameters were never updated is off in epoch 1.  Held as it is on the
# stand-in labels clip(0.8 x + 0.1, 0, 1), the smooth problem it was set on.
TOL_LOSS_CURVE = 1e-3
# On the pipeline's labels (sparse; they carry a rounding apart into the
# trajectory) the reference is float32 autograd on cuDNN's deterministic
# algorithms, which repeats bit for bit; per epoch the bf16 kernels may be
# off it by max(TOL_LOSS_CURVE, TOL_PIPE_CURVE x the bf16 autograd
# engine's gap from it): no further from float32 than that multiple of
# PyTorch's own bf16 engine.  Set from two runs on an H100 (every engine
# here repeats its bits, so both gave the same numbers): the tightest
# epoch needs 1.28 (flagship epoch 3: 0.228 % against 0.178 %); deep3's
# epochs sit under the 0.1 % floor
TOL_PIPE_CURVE = 2.0
# phase 15: the SVD denoiser's gates (headline.py:195-229), the deflation's
# bound against the default band (tests/test_svd.py: 1e-4 of max |x|), the
# self-cross against the PSD (tests/test_crosspower.py), the chords' rate
# (the crosspower command's --fs default) and their shared line
GATE_SVD_SSIM = 0.99
TOL_DEFLATE = 1e-4
TOL_SELF_CROSS = 1e-4
CP_FS, CP_LINE = 1.667e6, 8e4
RAW_SHOTS = 4       # phase 15 (c): synth-shots --shots 4 --channels 20
# the card's peaks (NVIDIA H100 SXM data sheet, dense): operands' type -> FLOP/s
PEAK = {torch.bfloat16: (989e12, "bf16 tensor 989 TFLOP/s"),
        torch.float32: (67e12, "fp32 67 TFLOP/s")}
HBM = 3.35e12

FLAGSHIP = ModelConfig()
DEEP3 = MODEL_PRESETS["deep3"]
# no kernel family covers it (128 filters): served on the module route
UNCOVERED = ModelConfig(filters=(16, 32, 128), kernels=((5, 5),) * 3, out_kernel=(5, 5))
# the TPU kernel (its pl.pallas_call) each id names
TPU_KERNELS = {
    "K1": "specenh/ops/stft_fused.py:198",
    "K2": "specenh/ops/parity_turn.py:131",
    "K3": "specenh/ops/ae_kernel.py:534",
    "K4": "specenh/ops/parity_turn.py:224",
    "K5": "specenh/ops/ae_train_kernel.py:745",
    "K5b": "specenh/ops/ae_train_kernel.py:819",
    "K6": "specenh/ops/ae3_kernel.py:499",
    "K7": "specenh/ops/ae3_train_kernel.py:659",
    "K8-in": "specenh/ops/parity_turn.py:324",
    "K8-out": "specenh/ops/parity_turn.py:401",
    "K9": "specenh/ops/stft_fused.py:319",
    "K10": "specenh/ops/stft_fused.py:373",
    "K11a": "scripts/probe_mosaic_walls.py:32",
    "K11b": "scripts/probe_mosaic_walls.py:43",
    "K11c": "scripts/probe_mosaic_walls.py:54",
}
STAGES = (AK.TILE_IN, AK.CONV_POOL, AK.CONVT, AK.TILE_OUT)
# the conv templates of csrc/ae_conv.cuh: stride 1, the transposed convs', the
# bf16 out-conv's and the bf16 one-channel-in convs'
QUAD, IGEMM, CT_RELU, CT_IGEMM, OUT_MMA, IN_MMA = _build.CONV_TEMPLATES
SERVE_IDS = {2: dict(zip(STAGES, ("K2", "K3", "K3", "K4"))),
             3: dict(zip(STAGES, ("K8-in", "K6", "K6", "K8-out")))}
SERVE_KERNELS = (SF.STFT_KERNEL, *STAGES)
K5B_KERNELS = (TK.TRAIN_IN_PRE, TK.TRAIN_LOSS_PRE)
TRAIN3_KERNELS = tuple(k for k in TK.TRAIN_KERNELS if k not in K5B_KERNELS)
PROBE_KERNELS = (PW.ROW_SLICE, PW.TRANSPOSE, PW.STRIDE2)
ROW_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
ROWS: dict = {}  # (CudaKernel, TPU kernel id) -> the row's numbers


def row(kern, kid) -> dict:
    return ROWS.setdefault((kern, kid), {})


def train_id(kern, depth: int) -> str:
    return "K7" if depth == 3 else ("K5b" if kern in K5B_KERNELS else "K5")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_bf16_stage(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    d = (got.float() - ref.float()).abs()
    bound = BF16_REL * ref.float().abs() + 1e-5
    worst = float((d - bound).max())
    check(worst <= 0, f"{name}: |err| exceeds one bf16 ulp by {worst:.3g}")
    return float(d.max())


def check_f32_stage(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    e = max_err(got, ref)
    check(e <= TOL_F32, f"{name}: |err| {e:.3g} > {TOL_F32}")
    return e


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def ptxas_summary() -> list:
    """(library, kernel, registers, spill bytes) from the build's ptxas
    reports."""
    rows = []
    for logf in sorted(_build.BUILD_DIR.glob("*.log")):
        lib = logf.name.rsplit("-", 1)[0]
        name = None
        for line in logf.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                rows.append((lib, name, int(m.group(1)), spill))
                name = None
    return rows


def on_template(lib: str, kind, tag: str, fn, *args):
    """``fn(*args)``, which must launch one conv through library ``lib`` on
    template ``kind`` (QUAD, IGEMM, CT_RELU, CT_IGEMM, OUT_MMA or IN_MMA), or none
    (None)."""
    before = _build.conv_template_launches(lib)
    out = fn(*args)
    after = _build.conv_template_launches(lib)
    got = {k: after[k] - before[k] for k in after}
    want = {k: int(kind == k) for k in _build.CONV_TEMPLATES}
    check(got == want, f"{tag}: conv template launches {got}, expected {want}")
    return out


def convt_template(dtype) -> str:
    """The template of a transposed-conv launch in ``dtype``."""
    return CT_IGEMM if dtype == torch.bfloat16 else CT_RELU


def template_deltas(before: dict) -> dict:
    """Launches of each conv template per library since ``before``."""
    now = {lib: _build.conv_template_launches(lib) for lib in before}
    return {lib: {k: now[lib][k] - before[lib][k] for k in now[lib]} for lib in now}


def conv_flops(w: AK.AEKernelWeights, i: int, b: int, h: int, wd: int) -> float:
    """FLOPs of layer i on b inputs of h x wd: a stride-1 conv's output
    positions, or a transposed conv's input positions, times its taps."""
    return 2.0 * b * h * wd * w.w[i].shape[0] * w.cout(i) * w.k(i) ** 2


def check_stft(sp, traces) -> float:
    """Phase 3, K1: the log-PSD, min/max and normalized spectrograms."""
    out, mn, mx = SF.stft_ft_log(traces, sp)
    ref, rmn, rmx = SF.stft_ft_log_plain(traces, sp)
    check(out.shape == (traces.shape[0], sp.n_freqs_onesided, sp.n_frames),
          f"log-PSD shape {tuple(out.shape)}")
    err_k1 = max_err(out, ref)
    err_mm = max(max_err(mn, rmn), max_err(mx, rmx))
    check(err_k1 <= TOL_LOGPSD, f"K1 log-PSD |err| {err_k1:.3g} > {TOL_LOGPSD}")
    check(err_mm <= TOL_LOGPSD, f"K1 min/max |err| {err_mm:.3g} > {TOL_LOGPSD}")
    specs = SF.spectrogram_fused(traces, sp)
    err_specs = max_err(specs, (ref[:, :-1] - rmn[:, :, None]) / (rmx - rmn)[:, :, None])
    check(err_specs <= TOL_SPECS, f"normalized specs |err| {err_specs:.3g}")
    log(f"K1 stft_logpsd: log-PSD max|err| {err_k1:.3g}, min/max {err_mm:.3g}, "
        f"normalized {err_specs:.3g} (tol {TOL_LOGPSD}, {TOL_SPECS})")
    return err_k1


def serve_chain(wts, specs, k):
    """The stage kernels over the layer table, each on the previous
    kernel's output: (the 2d activations, the restitched output).  Each
    launch must run on the tensor cores in bf16 and on ``conv_quad_kernel``
    / ``convt_relu_kernel`` in float32."""
    bf = wts.dtype == torch.bfloat16
    s2 = IGEMM if bf else QUAD
    xs = [on_template("ae", IN_MMA if bf else QUAD, f"{wts.dtype} ae_tile_in", AK.ae_tile_in,
                      wts, specs, k)]
    for i in range(1, wts.depth):
        xs.append(on_template("ae", s2, f"{wts.dtype} ae_conv_pool {i}", AK.ae_conv_pool,
                              wts, xs[-1], i))
    for i in range(wts.depth, wts.out):
        xs.append(on_template("ae", convt_template(wts.dtype), f"{wts.dtype} ae_convt {i}",
                              AK.ae_convt, wts, xs[-1], i))
    s4 = OUT_MMA if wts.dtype == torch.bfloat16 else QUAD
    return xs, on_template("ae", s4, f"{wts.dtype} ae_tile_out", AK.ae_tile_out, wts, xs[-1], k)


def check_serve_stages(wts, specs, k, tag):
    """Every serving stage against its twin on the same input; returns the
    max |err| per entry point and the stage outputs."""
    act = check_bf16_stage if wts.dtype == torch.bfloat16 else check_f32_stage
    xs, y = serve_chain(wts, specs, k)
    errs = {AK.TILE_IN: act(f"{tag} ae_tile_in", xs[0], AK.ae_tile_in_plain(wts, specs, k))}
    for i in range(1, wts.out):
        kern = AK.CONVT if wts.is_convt(i) else AK.CONV_POOL
        plain = (AK.ae_convt_plain if kern is AK.CONVT else AK.ae_conv_pool_plain)
        e = act(f"{tag} {kern.symbol} {i}", xs[i], plain(wts, xs[i - 1], i))
        errs[kern] = max(errs.get(kern, 0.0), e)
    errs[AK.TILE_OUT] = max_err(y, AK.ae_tile_out_plain(wts, xs[-1], k))
    check(errs[AK.TILE_OUT] <= TOL_F32, f"{tag} ae_tile_out |err| {errs[AK.TILE_OUT]:.3g}")
    for kern, e in errs.items():
        log(f"{tag} {kern.symbol} ({tuple(specs.shape)} specs): max|err| {e:.3g}")
    return errs, xs


# the out-conv geometries S4 is checked at (phase 3): (name, config)
S4_GEOMETRIES = (
    ("k1", ModelConfig(kernels=((1, 1), (1, 1)), out_kernel=(1, 1))),
    ("k3", FLAGSHIP),
    ("k5", ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5))),
    ("k7", ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7))),
    ("(64,32)/k5", ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)), out_kernel=(5, 5))),
    ("(64,32,64)/k7", ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3,
                                  out_kernel=(7, 7))),
    ("deep3", DEEP3),
    ("(48,48,64)/k3", ModelConfig(filters=(48, 48, 64), kernels=((3, 3),) * 3,
                                  out_kernel=(3, 3))),
    ("k3, out-conv k7", ModelConfig(out_kernel=(7, 7))),
    ("deep3, out-conv k1", ModelConfig(filters=(16, 32, 64), kernels=((5, 5),) * 3,
                                       out_kernel=(1, 1))),
)


def check_tile_in_out(dev, sp, traces, specs):
    """Phase 3: the one-channel convs in bf16 at each of ``S4_GEOMETRIES``
    on the first channel's tiles, fed by the stage kernels' chain (each
    launch on its template): S1 (``conv_in_mma_kernel``) within one bf16
    ulp of its twin, ``ae_tile_in_norm`` in both layouts within one ulp of
    its twin and bit for bit S1; S4 (``conv_out_mma_kernel``) within
    TOL_F32 of its twin; two launches of each bit for bit."""
    k = sp.n_frames // 128
    gen = torch.Generator().manual_seed(SEED)
    raws = {"ft": SF.stft_ft_log(traces[:1], sp), "tf": SF.stft_tf_log(traces[:1], sp)}
    for name, cfg in S4_GEOMETRIES:
        model = make_model(cfg, generator=gen, device=dev).eval()
        wts = AK.build_kernel_weights(model, torch.bfloat16)
        xs, y = serve_chain(wts, specs[:1], k)
        e1 = check_bf16_stage(f"S1 {name}", xs[0], AK.ae_tile_in_plain(wts, specs[:1], k))
        check(torch.equal(xs[0], AK.ae_tile_in(wts, specs[:1], k)), f"S1 {name}: two launches differ")
        en = 0.0
        for layout, (raw, mn, mx) in raws.items():
            args = (wts, raw, mn, mx, k, layout)
            got = on_template("ae", IN_MMA, f"ae_tile_in_norm {name} ({layout})",
                              AK.ae_tile_in_norm, *args)
            en = max(en, check_bf16_stage(f"ae_tile_in_norm {name} ({layout})", got,
                                          AK.ae_tile_in_norm_plain(*args)))
            check(torch.equal(got, xs[0]), f"ae_tile_in_norm {name} ({layout}) differs from S1")
        e = max_err(y, AK.ae_tile_out_plain(wts, xs[-1], k))
        check(e <= TOL_F32, f"S4 {name}: bf16 ae_tile_out |err| {e:.3g} > {TOL_F32}")
        check(torch.equal(y, AK.ae_tile_out(wts, xs[-1], k)), f"S4 {name}: two launches differ")
        c1 = xs[0].shape[1]
        log(f"{name} bf16: S1 ({c1} ch out, {IN_MMA}, strips of "
            f"{AK.conv_in_strip(c1, True)} rows) max|err| {e1:.3g}, ae_tile_in_norm (ft, tf) "
            f"{en:.3g} (one bf16 ulp), bit for bit S1; S4 ({xs[-1].shape[1]} ch in, {OUT_MMA}, "
            f"strips of {AK.conv_out_rows(wts.k(wts.out), xs[-1].shape[1])} rows): max|err| "
            f"{e:.3g} (tol {TOL_F32}); two launches of each bit for bit")


def check_kernels(dev, cfg, specs, k, dtypes, geometries):
    """Phases 3 and 6: every stage against its twin in each of ``dtypes``,
    then the whole AE of each (name, channels, config) in ``geometries``
    against the module.  Returns the module, the bf16 stages' max |err|
    and the inputs each stage saw on the serving path."""
    gen = torch.Generator().manual_seed(SEED)
    model = make_model(cfg, generator=gen, device=dev).eval()
    for dt in dtypes:
        wts = AK.build_kernel_weights(model, dt)
        e, xs = check_serve_stages(wts, specs, k, f"d{cfg.depth} {dt}")
        if dt == torch.bfloat16:
            errs, stage_inputs = e, dict(specs=specs, xs=xs, k=k, wts=wts)
    for name, c, gcfg in geometries:
        m = model if gcfg == cfg else make_model(gcfg, generator=gen, device=dev).eval()
        s = specs[:c]
        with torch.no_grad():
            want = AK.ae_kernel_enhance_specs_plain(m, s, k)
        e32 = max_err(AK.ae_kernel_enhance_specs(AK.build_kernel_weights(m, torch.float32), s, k),
                      want)
        d16 = (AK.ae_kernel_enhance_specs(AK.build_kernel_weights(m, torch.bfloat16), s, k)
               - want).abs()
        e16, m16 = float(d16.max()), float(d16.mean())
        log(f"AE {name}, {c} ch: f32 max|err| {e32:.3g} (tol {TOL_F32}); bf16 max|err| "
            f"{e16:.3g} mean {m16:.3g} (tol {TOL_BF16_MAX}, {TOL_BF16_MEAN})")
        check(e32 <= TOL_F32, f"AE {name} f32 |err| {e32:.3g}")
        check(e16 <= TOL_BF16_MAX and m16 <= TOL_BF16_MEAN, f"AE {name} bf16 |err| {e16:.3g}/{m16:.3g}")
    return model, errs, stage_inputs


def gated_run(fn, wts, traces, refs, tag, kernels, absent=()):
    """The bf16 service ``fn`` on the shots ``traces`` with every count set
    to 0 just before and read just after: each of ``kernels`` must have
    launched and none of ``absent``, every S1, S2, S3 and S4 launch on the
    tensor cores; then the repo's two gates on every shot.  Returns the outputs and the counts."""
    for kern in _build.KERNELS:
        kern.launches = 0
    before = {"ae": _build.conv_template_launches("ae")}
    outs = [fn(wts, t) for t in traces]
    torch.cuda.synchronize()
    launches = {kern: kern.launches for kern in _build.KERNELS}
    took = template_deltas(before)["ae"]
    for kern in kernels:
        check(launches[kern] > 0, f"{tag}: {kern.symbol} was not launched")
    for kern in absent:
        check(launches[kern] == 0, f"{tag}: {kern.symbol} was launched")
    s1 = launches[AK.TILE_IN] + launches[AK.TILE_IN_NORM]
    want = {QUAD: 0, IGEMM: launches[AK.CONV_POOL], CT_RELU: 0, CT_IGEMM: launches[AK.CONVT],
            OUT_MMA: launches[AK.TILE_OUT], IN_MMA: s1}
    check(took == want, f"{tag}: conv templates {took}, expected {want}")
    log(f"{tag} launches: " + ", ".join(f"{k.symbol}={launches[k]}" for k in kernels)
        + f"; {IN_MMA}={took[IN_MMA]} (every S1), {IGEMM}={took[IGEMM]} (every S2), "
        f"{CT_IGEMM}={took[CT_IGEMM]} (every S3), {OUT_MMA}={took[OUT_MMA]} (every S4), "
        f"{QUAD}={took[QUAD]}")
    c, k = traces[0].shape[0], refs[0][1].shape[-1] // 128
    for seed, (specs, enh), (s_ref, e_ref) in zip((0, 1, 2), outs, refs):
        check(specs.shape == (c, 256, refs[0][0].shape[-1]), f"specs {tuple(specs.shape)}")
        check(enh.shape == (c, 256, k * 128), f"enhanced {tuple(enh.shape)}")
        check(bool(torch.isfinite(specs).all() and torch.isfinite(enh).all()), "non-finite output")
        s_ssim = ssim(specs[0].cpu().numpy(), s_ref)
        e_host = enh.cpu().numpy()
        e_ssim = min(ssim(e_host[ch], e_ref[ch]) for ch in range(c))
        log(f"{tag}, shot seed {seed}: spectrogram SSIM vs SciPy {s_ssim:.6f} "
            f"(gate {GATE_SPEC_SSIM}), enhanced SSIM vs f32 plain service, min over "
            f"{c} ch {e_ssim:.6f} (gate {GATE_ENH_SSIM})")
        check(s_ssim >= GATE_SPEC_SSIM, f"{tag}: spectrogram SSIM {s_ssim:.6f}")
        check(e_ssim >= GATE_ENH_SSIM, f"{tag}: enhanced SSIM {e_ssim:.6f}")
    return outs, launches


def run_service(dev, sp, cfg, model, n_channels):
    """Phases 4 and 6: the bf16 service on three shots, gated; returns the
    service, its weights, the shots, their gate references, its outputs and
    the launch counts of that run."""
    fn = make_enhance_shot_fn(cfg, sp, dtype=torch.bfloat16, device=dev)
    wts = fn.prepare(model)
    shots = [example_shot(sp, n_channels, seed) for seed in (0, 1, 2)]
    traces = [torch.from_numpy(s).to(dev) for s in shots]
    refs = [(spectrogram_ref(host[0], sp), enhance_shot_plain(model, t, sp)[1].cpu().numpy())
            for host, t in zip(shots, traces)]
    outs, launches = gated_run(fn, wts, traces, refs, f"depth-{cfg.depth} service",
                               SERVE_KERNELS)
    return dict(fn=fn, wts=wts, traces=traces, refs=refs, outs=outs, launches=launches)


def serve_module_route(dev, sp, gpu):
    """Phase 13: a geometry no kernel family covers, (16, 32, 128)/k5,
    served with ``use_kernel="auto"`` in bf16: the module route (the
    matmul STFT front, the ``nn.Module`` computing in bf16 with float32
    parameters), on three 20-channel shots, none of the serving kernels
    launched, gated as the kernel services against the plain float32
    service; its ms/shot."""
    cfg = UNCOVERED
    model = make_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    fn = make_enhance_shot_fn(cfg, sp, dtype=torch.bfloat16, device=dev, use_kernel="auto")
    check(fn.prepare(model) is model, "the module route's prepare must return the module")
    shots = [example_shot(sp, N_CHANNELS, seed) for seed in (0, 1, 2)]
    traces = [torch.from_numpy(s_).to(dev) for s_ in shots]
    refs = [(spectrogram_ref(host[0], sp), enhance_shot_plain(model, t, sp)[1].cpu().numpy())
            for host, t in zip(shots, traces)]
    gated_run(fn, model, traces, refs, "module route (16,32,128)/k5 bf16", (),
              absent=SERVE_KERNELS)
    ms = time_cuda(fn, model, traces[0], warmup=2, iters=10)
    ms_plain = time_cuda(enhance_shot_plain, model, traces[0], sp, warmup=2, iters=10)
    log(f"[{gpu}] module route (16,32,128)/k5 bf16 service: {ms:.4f} ms/shot "
        f"({N_CHANNELS / ms * 1e3:.2f} spectrograms/s); plain f32 service {ms_plain:.4f} ms/shot")


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the least time of the work on this
    card, the larger of the operations over the peak for the operands'
    type and the bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK[dtype][0] * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def pair_times(gpu, name, kf, pf):
    """plain, kernel, kernel, plain: drift on the card shows as a gap."""
    p1, k1, k2, p2 = time_cuda(pf), time_cuda(kf), time_cuda(kf), time_cuda(pf)
    log(f"[{gpu}] {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return min(k1, k2), min(p1, p2)


def time_entries(gpu, entries, dtype, per=""):
    """Each entry's kernel and twin in turns, its library call and bound:
    entries {kernel: (kernel fn, plain fn, library fn, FLOPs, bytes)}."""
    times = {}
    for kern, (kf, pf, lf, flops, nb) in entries.items():
        ms, plain_ms = pair_times(gpu, kern.symbol + per, kf, pf)
        with torch.no_grad():
            lib_ms = time_cuda(lf)
        dt = dtype if kern is not TK.TRAIN_SUM else torch.float32
        b_ms, b_by = bound(flops, nb, dt)
        times[kern] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by)
        log(f"[{gpu}] {kern.symbol}: library call {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {flops / 1e9:.3f} GFLOP, {nb / 1e6:.1f} MB, "
            f"{PEAK[dt][1]}, 3.35 TB/s), achieved {flops / ms / 1e9:.2f} TFLOP/s")
    return times


def device_ms(fn, name: str) -> float:
    """Device milliseconds of one call of ``fn`` spent in the CUDA kernels
    whose names contain ``name``, from torch.profiler over 10 calls after a
    warm-up; 0.0 where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages() if name in e.key)
    return us / 10 / 1e3


def time_stft(sp, gpu, traces, tf=False):
    """Phases 5 and 12e, K1 in the (F, T) or the (T, F) layout: the kernel,
    its twin, ``torch.stft`` and the bound.  K1's function needs no more
    than an FFT's work per frame: detrend and window (~7 n), a real FFT
    (2.5 n log2 n), the PSD, its log and the min/max (~6 per bin)."""
    c, nf, n = traces.shape[0], sp.n_freqs_onesided, sp.nperseg
    window = torch.hamming_window(sp.nperseg, periodic=True, device=traces.device)
    ops = c * sp.n_frames * (7 * n + 2.5 * n * np.log2(n) + 6 * nf)
    kern, fn, plain = ((SF.STFT_TF_KERNEL, SF.stft_tf_log, SF.stft_tf_log_plain) if tf else
                       (SF.STFT_KERNEL, SF.stft_ft_log, SF.stft_ft_log_plain))
    entry = (lambda: fn(traces, sp), lambda: plain(traces, sp),
             lambda: torch.stft(traces, sp.nperseg, sp.hop, window=window, center=False,
                                return_complex=True),
             ops, c * sp.n_samples * 4 + c * nf * sp.n_frames * 4)
    return time_entries(gpu, {kern: entry}, torch.float32)[kern]


def time_serving(sp, gpu, model, fn, wts, traces, st):
    """Phases 5 and 6: each stage entry point over its launches in one
    AE pass, its twin, the PyTorch calls computing the same function and
    its bound; then the whole AE and the service."""
    xs, k, specs, w = st["xs"], st["k"], st["specs"], st["wts"]
    bf = torch.bfloat16
    b, o = xs[0].shape[0], w.out
    tiles = patch(specs[:, :, : k * 128]).to(bf)[:, None].contiguous()
    ins = [tiles] + xs  # ins[i]: layer i's input
    cw = [AK._conv_w(w, i).to(bf) for i in range(o + 1)]
    tw = [w.w[i].permute(0, 3, 1, 2).flip(2, 3).to(bf).contiguous() for i in range(o + 1)]
    b16 = [bb.to(bf) for bb in w.b]
    enc, dec = range(1, w.depth), range(w.depth, o)
    out_specs = specs.shape[0] * 256 * k * 128 * 4

    def flops(layers):
        return sum(conv_flops(w, i, b, *ins[i].shape[2:]) for i in layers)

    entries = {
        AK.TILE_IN: (lambda: AK.ae_tile_in(w, specs, k), lambda: AK.ae_tile_in_plain(w, specs, k),
                     lambda: F.conv2d(tiles, cw[0], b16[0], padding=w.k(0) // 2),
                     flops([0]), out_specs + nbytes(xs[0])),
        AK.CONV_POOL: (lambda: [AK.ae_conv_pool(w, ins[i], i) for i in enc],
                       lambda: [AK.ae_conv_pool_plain(w, ins[i], i) for i in enc],
                       lambda: [F.conv2d(ins[i], cw[i], b16[i], padding=w.k(i) // 2) for i in enc],
                       flops(enc), sum(nbytes(ins[i], xs[i]) for i in enc)),
        AK.CONVT: (lambda: [AK.ae_convt(w, ins[i], i) for i in dec],
                   lambda: [AK.ae_convt_plain(w, ins[i], i) for i in dec],
                   lambda: [F.conv_transpose2d(ins[i], tw[i], b16[i], stride=2, output_padding=1,
                                               padding=w.k(i) - 1 - convt_pad_before(w.k(i)))
                            for i in dec],
                   flops(dec), sum(nbytes(ins[i], xs[i]) for i in dec)),
        AK.TILE_OUT: (lambda: AK.ae_tile_out(w, xs[-1], k), lambda: AK.ae_tile_out_plain(w, xs[-1], k),
                      lambda: F.conv2d(xs[-1], cw[o], b16[o], padding=w.k(o) // 2),
                      flops([o]), nbytes(xs[-1]) + out_specs),
    }
    times = time_entries(gpu, entries, bf, f" (depth {w.depth})")
    with torch.no_grad():
        ae_k = time_cuda(lambda: AK.ae_kernel_enhance_specs(w, specs, k))
        ae_p = time_cuda(lambda: AK.ae_kernel_enhance_specs_plain(model, specs, k))
        m16 = make_model(model.cfg, generator=torch.Generator().manual_seed(SEED),
                         device=specs.device).to(torch.bfloat16).eval()
        ae_p16 = time_cuda(lambda: AK.ae_kernel_enhance_specs_plain(m16, specs, k))
    log(f"[{gpu}] whole AE depth {w.depth}, {specs.shape[0]} ch: kernels (bf16) {ae_k:.4f} ms "
        f"({flops(range(o + 1)) / ae_k / 1e9:.2f} TFLOP/s), plain module f32 {ae_p:.4f} ms, "
        f"plain module bf16 {ae_p16:.4f} ms")

    torch.cuda.reset_peak_memory_stats()
    ms = time_cuda(fn, wts, traces, warmup=3, iters=20)
    peak = torch.cuda.max_memory_allocated()
    ms_plain = time_cuda(enhance_shot_plain, model, traces, sp, warmup=2, iters=10)
    c = traces.shape[0]
    log(f"[{gpu}] service depth {w.depth} bf16: {ms:.4f} ms/shot (median of 20), "
        f"{c / ms * 1e3:.2f} spectrograms/s, peak device memory {peak / 2**30:.3f} GiB; "
        f"plain f32 service {ms_plain:.4f} ms/shot")
    return times


def serve_family(dev, sp, gpu, cfg, specs, dtypes, geometries):
    """Phases 3-5 (flagship) or 6 (deep3) after K1: stage checks, the gated
    service (its launches are the rows'), the timings.  Returns the
    service's run (``run_service``) and the module."""
    k = sp.n_frames // 128
    model, errs, st = check_kernels(dev, cfg, specs, k, dtypes, geometries)
    run = run_service(dev, sp, cfg, model, N_CHANNELS)
    times = time_serving(sp, gpu, model, run["fn"], run["wts"], run["traces"][0], st)
    for kern, kid in SERVE_IDS[cfg.depth].items():
        row(kern, kid).update(launches=run["launches"][kern], max_abs_err=errs[kern],
                              **times[kern])
    return run, model


def check_stft_tf(sp, traces) -> float:
    """Phase 12a, K1 in the (T, F) layout: against its twin, and bit for bit
    the (F, T) kernel's output transposed, min and max included."""
    out, mn, mx = SF.stft_tf_log(traces, sp)
    ref, rmn, rmx = SF.stft_tf_log_plain(traces, sp)
    ft, fmn, fmx = SF.stft_ft_log(traces, sp)
    check(out.shape == (traces.shape[0], sp.n_frames, sp.n_freqs_onesided),
          f"(T, F) log-PSD shape {tuple(out.shape)}")
    err = max(max_err(out, ref), max_err(mn, rmn), max_err(mx, rmx))
    check(err <= TOL_LOGPSD, f"K1 (T, F) |err| {err:.3g} > {TOL_LOGPSD}")
    same = (torch.equal(out, ft.transpose(1, 2)) and torch.equal(mn, fmn)
            and torch.equal(mx, fmx))
    check(same, "K1 (T, F) differs from K1 (F, T) transposed")
    log(f"K1 stft_logpsd_tf: max|err| {err:.3g} vs its twin (tol {TOL_LOGPSD}); "
        f"bit for bit the (F, T) output transposed, min and max equal")
    return err


def check_tile_in_norm(dev, sp, traces, geometries):
    """Phase 12b: ``ae_tile_in_norm`` in both layouts, bf16 and float32,
    for each (name, channels, config): within one bf16 ulp (float32:
    TOL_F32) of its twin, and bit for bit ``ae_tile_in`` on the normalized
    spectrograms.  Returns the flagship's bf16 max |err| per layout."""
    k = sp.n_frames // 128
    raws = {"ft": SF.stft_ft_log(traces, sp), "tf": SF.stft_tf_log(traces, sp)}
    specs = SF.spectrogram_fused(traces, sp)
    errs = {}
    gen = torch.Generator().manual_seed(SEED)
    for name, c, cfg in geometries:
        model = make_model(cfg, generator=gen, device=dev).eval()
        for dt in (torch.bfloat16, torch.float32):
            wts = AK.build_kernel_weights(model, dt)
            act = check_bf16_stage if dt == torch.bfloat16 else check_f32_stage
            want = AK.ae_tile_in(wts, specs[:c], k)
            for layout, (raw, mn, mx) in raws.items():
                tag = f"{name} {dt} ae_tile_in_norm ({layout})"
                args = (wts, raw[:c], mn[:c], mx[:c], k, layout)
                got = AK.ae_tile_in_norm(*args)
                e = act(tag, got, AK.ae_tile_in_norm_plain(*args))
                check(torch.equal(got, want), f"{tag} differs from ae_tile_in on the specs")
                if c == N_CHANNELS and dt == torch.bfloat16:
                    errs[layout] = e
                log(f"{tag}, {c} ch: max|err| {e:.3g} vs its twin; bit for bit ae_tile_in")
    return errs


def serve_modes(dev, sp, gpu, model, run):
    """Phase 12c and f: the flagship service in each other ``stft_mode``
    on the auto run's three shots, counted and gated as it; "fused" and
    "fused_ft" bit for bit "auto"; then K10's route (the raw (F, T)
    log-PSD into ``ae_kernel_enhance_raw``), bit for bit "auto"'s enhanced
    output; then ms/shot per mode.  Returns the launches per run."""
    stages = (AK.CONV_POOL, AK.CONVT, AK.TILE_OUT)
    modes = {
        "fused": ((SF.STFT_TF_KERNEL, AK.TILE_IN_NORM, *stages), (SF.STFT_KERNEL, AK.TILE_IN)),
        "fused_ft": (SERVE_KERNELS, (SF.STFT_TF_KERNEL, AK.TILE_IN_NORM)),
        "xla": ((AK.TILE_IN, *stages), (SF.STFT_KERNEL, SF.STFT_TF_KERNEL, AK.TILE_IN_NORM)),
    }
    fns, launches = {"auto": run["fn"]}, {}
    for mode, (kernels, absent) in modes.items():
        fn = make_enhance_shot_fn(FLAGSHIP, sp, dtype=torch.bfloat16, device=dev,
                                  stft_mode=mode)
        outs, launches[mode] = gated_run(fn, run["wts"], run["traces"], run["refs"],
                                         f"service stft_mode={mode!r}", kernels, absent)
        if mode != "xla":
            same = all(torch.equal(a, b) for o, r in zip(outs, run["outs"]) for a, b in zip(o, r))
            check(same, f"stft_mode={mode!r} differs from 'auto'")
            log(f"stft_mode={mode!r}: specs and enhanced bit for bit 'auto''s on 3 shots")
        else:
            d = max(max_err(o[1], r[1]) for o, r in zip(outs, run["outs"]))
            log(f"stft_mode='xla': enhanced max|err| {d:.3g} from 'auto' (the matmul STFT front)")
        fns[mode] = fn

    def raw_ft(wts, t):
        raw, mn, mx = SF.stft_ft_log(t, sp)
        return AK.ae_kernel_enhance_raw(wts, raw, mn, mx, sp.n_frames // 128, "ft")

    for kern in _build.KERNELS:
        kern.launches = 0
    with torch.no_grad():
        enh = [raw_ft(run["wts"], t) for t in run["traces"]]
    torch.cuda.synchronize()
    launches["raw_ft"] = {kern: kern.launches for kern in _build.KERNELS}
    check(launches["raw_ft"][AK.TILE_IN_NORM] > 0, "K10's route did not launch ae_tile_in_norm")
    check(all(torch.equal(a, r[1]) for a, r in zip(enh, run["outs"])),
          "K10's route differs from 'auto''s enhanced output")
    log(f"K10's route (stft_logpsd -> ae_tile_in_norm 'ft' -> stages) on 3 shots: "
        f"ae_tile_in_norm={launches['raw_ft'][AK.TILE_IN_NORM]}; enhanced bit for bit 'auto''s")

    t0 = run["traces"][0]
    order = ["auto", "fused", "fused_ft", "xla"]
    ms = {m: [] for m in order}
    for m in order + order[::-1]:  # in turns: drift shows as a gap
        ms[m].append(time_cuda(fns[m], run["wts"], t0, warmup=3, iters=20))
    for m in order:
        log(f"[{gpu}] service flagship bf16 stft_mode={m!r}: {ms[m][0]:.4f}/{ms[m][1]:.4f} "
            f"ms/shot (median of 20, two turns), {N_CHANNELS / min(ms[m]) * 1e3:.2f} "
            f"spectrograms/s")
    return launches


def run_probes(gpu):
    """Phase 12d: the three K11 probes in this process (counts set to 0
    just before, read just after), each equal to its twin, then
    ``python -m specenh_torch.probe_walls`` (a subprocess per probe) all
    OK, then their times.  Returns the launches and the times."""
    for kern in _build.KERNELS:
        kern.launches = 0
    for name in PW.PROBES:
        check(PW.run_probe(name, "cuda", SEED), f"probe {name} differs from its twin")
    launches = {kern: kern.launches for kern in _build.KERNELS}
    log("K11 probes in process, each equal to its twin: " + ", ".join(
        f"{k.symbol}={launches[k]}" for k in PROBE_KERNELS))
    results = PW.main(timeout=120)
    check(all(v == "OK" for v in results.values()), f"probe_walls: {results}")
    xs = {name: torch.randn(shape, generator=torch.Generator().manual_seed(SEED)).cuda()
          for name, (_, _, shape) in PW.PROBES.items()}
    library = {"sublane_offset1_slice": lambda x: torch.slice_copy(x, 0, 1, PW.FB + 1),
               "in_kernel_transpose": lambda x: torch.transpose_copy(x, 0, 1),
               "stride2_lane_slice": lambda x: torch.slice_copy(x, 1, 0, x.shape[1], 2)}
    entries = {}
    for kern, (name, (fn, plain, _)) in zip(PROBE_KERNELS, PW.PROBES.items()):
        x = xs[name]
        entries[kern] = (lambda f=fn, x=x: f(x), lambda p=plain, x=x: p(x),
                         lambda lf=library[name], x=x: lf(x), 0.0,
                         nbytes(x) + nbytes(plain(x)))
    return launches, time_entries(gpu, entries, torch.float32, " (launch-bound)")


def time_tile_in_norm(sp, gpu, traces, wts, model):
    """Phase 12e: ``ae_tile_in_norm`` per layout at the flagship's 600
    tiles, its twin, the library calls (normalize, cast, ``F.conv2d`` on
    the raw tiles) and the bound (raw float32 read once, the pooled bf16
    activations written once); then S1 from the specs beside S1 from the
    raw log-PSD in each layout, in turns, in bf16 (``conv_in_mma_kernel``)
    and in float32 (``conv_quad_kernel``: ``PlaneSrc`` loads each thread's
    patch itself, ``NormPlaneSrc`` stages the block's window)."""
    k, bf = sp.n_frames // 128, torch.bfloat16
    raw_ft, mn, mx = SF.stft_ft_log(traces, sp)
    raws = {"ft": raw_ft, "tf": SF.stft_tf_log(traces, sp)[0]}
    tiles = patch(raw_ft[:, :256, : k * 128])[:, None].contiguous()
    lo = mn.repeat_interleave(k, 0)[:, :, None, None]
    span = (mx - mn).repeat_interleave(k, 0)[:, :, None, None]
    cw0, b0 = AK._conv_w(wts, 0).to(bf), wts.b[0].to(bf)
    x0 = AK.ae_tile_in(wts, SF.spectrogram_fused(traces, sp), k)
    flops = conv_flops(wts, 0, x0.shape[0], 256, 128)
    nb = traces.shape[0] * 256 * k * 128 * 4 + nbytes(x0)
    times = {}
    for layout, raw in raws.items():
        entry = (lambda r=raw, l=layout: AK.ae_tile_in_norm(wts, r, mn, mx, k, l),
                 lambda r=raw, l=layout: AK.ae_tile_in_norm_plain(wts, r, mn, mx, k, l),
                 lambda: F.conv2d(((tiles - lo) / span).to(bf), cw0, b0, padding=wts.k(0) // 2),
                 flops, nb)
        times[layout] = time_entries(gpu, {AK.TILE_IN_NORM: entry}, bf,
                                     f" ({layout})")[AK.TILE_IN_NORM]
    specs = SF.spectrogram_fused(traces, sp)
    runs = {}
    for w in (wts, AK.build_kernel_weights(model, torch.float32)):
        runs[f"{w.dtype} ae_tile_in"] = lambda w=w: AK.ae_tile_in(w, specs, k)
        for layout, raw in raws.items():
            runs[f"{w.dtype} ae_tile_in_norm ({layout})"] = (
                lambda w=w, r=raw, l=layout: AK.ae_tile_in_norm(w, r, mn, mx, k, l))
    order = list(runs)
    ms = {n: [] for n in order}
    for n in order + order[::-1]:  # in turns: drift shows as a gap
        ms[n].append(time_cuda(runs[n]))
    log(f"[{gpu}] S1 of one shot from the specs and from the raw log-PSD, in turns: " + ", ".join(
        f"{n} {ms[n][0]:.4f}/{ms[n][1]:.4f} ms" for n in order))
    return times


def fused_front(dev, sp, gpu, traces, model, run):
    """Phase 12: the service's other STFT fronts on the flagship and their
    kernels (K1 (T, F), ``ae_tile_in_norm`` for K9 and K10), the K11
    probes; fills their rows."""
    err_tf = check_stft_tf(sp, traces)
    errs = check_tile_in_norm(dev, sp, traces, (
        ("flagship k3", N_CHANNELS, FLAGSHIP),
        ("k5", 1, ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5))),
        ("k7", 1, ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7))),
        ("manual (64,32)/k5", 1, ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)),
                                             out_kernel=(5, 5)))))
    launches = serve_modes(dev, sp, gpu, model, run)
    row(SF.STFT_TF_KERNEL, "K1").update(launches=launches["fused"][SF.STFT_TF_KERNEL],
                                        max_abs_err=err_tf, **time_stft(sp, gpu, traces, tf=True))
    times = time_tile_in_norm(sp, gpu, traces, run["wts"], model)
    for kid, layout, mode in (("K9", "tf", "fused"), ("K10", "ft", "raw_ft")):
        row(AK.TILE_IN_NORM, kid).update(launches=launches[mode][AK.TILE_IN_NORM],
                                         max_abs_err=errs[layout], **times[layout])
    p_launches, p_times = run_probes(gpu)
    for kern, kid in zip(PROBE_KERNELS, ("K11a", "K11b", "K11c")):
        row(kern, kid).update(launches=p_launches[kern], max_abs_err=0.0, **p_times[kern])


def check_f32(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    e, scale = max_err(got, ref), float(ref.float().abs().max())
    check(e <= TOL_F32_REL * max(scale, 1e-6), f"{name}: |err| {e:.3g} of scale {scale:.3g}")
    return e


def check_mask(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    frac = float((got != ref).float().mean())
    check(frac <= TOL_MASK_FRAC, f"{name}: {frac:.3g} of the mask differs")
    return frac


def check_sum(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    e, scale = max_err(got, ref), float(ref.abs().max())
    check(e <= TOL_GRAD_SUM * max(scale, 1e-6), f"{name}: |err| {e:.3g} of scale {scale:.3g}")
    return e


def dataset_build(dev, sp, gpu) -> int:
    """Phase 7a: the dataset build's device half (``process_shot_fn``: K1,
    then the classical label pipeline) on one 20-channel, 2 s shot, with
    every count set to 0 just before and read just after: K1 must have
    launched once.  The specs equal ``spectrogram_fused`` bit for bit; the
    labels are held against the same port functions on the CPU and against
    ``pipeline_ref`` on three channels; each stage's time, the whole
    function's, specs/s, the peak memory and the byte bound; then two SPEC
    binaries read through ``NativePrefetcher`` give the in-memory results
    bit for bit.  Returns K1's launches."""
    cfg = Config(spec=sp)
    fn = process_shot_fn(cfg, dev)
    host = example_shot(sp, N_CHANNELS, SEED)
    traces = torch.from_numpy(host).to(dev)
    for kern in _build.KERNELS:
        kern.launches = 0
    specs, labels = fn(traces)
    torch.cuda.synchronize()
    launches = {kern: kern.launches for kern in _build.KERNELS}
    check(launches[SF.STFT_KERNEL] == 1, f"dataset build: K1 launched {launches[SF.STFT_KERNEL]}x")
    check(sum(launches.values()) == 1, "dataset build: a kernel other than K1 was launched")
    check(tuple(labels.shape) == tuple(specs.shape) == (N_CHANNELS, 256, sp.n_frames),
          f"dataset build: specs {tuple(specs.shape)}, labels {tuple(labels.shape)}")
    check(bool(torch.isfinite(labels).all()), "dataset build: non-finite labels")
    check(torch.equal(specs, SF.spectrogram_fused(traces, sp)),
          "dataset build: specs differ from spectrogram_fused")
    log(f"dataset build: process_shot_fn launched K1 {launches[SF.STFT_KERNEL]}x; specs == "
        f"spectrogram_fused bit for bit")

    cpu = EN.classical_pipeline(specs.cpu(), cfg.pipeline)
    diff = (labels.cpu() - cpu).abs()
    err, n_diff = float(diff.max()), int((diff > 0).sum())
    log(f"dataset build: labels on the card vs the same functions on the CPU: max |diff| "
        f"{err:.3g}, {n_diff} of {diff.numel()} pixels differ (tol {TOL_LABELS_CPU})")
    check(err <= TOL_LABELS_CPU, f"dataset build: labels vs CPU |diff| {err:.3g}")
    lab = labels.cpu().numpy()
    for ch in range(N_REF_CHANNELS):
        ref = pipeline_ref(specs[ch].cpu().numpy())
        s_ = ssim(lab[ch], ref)
        off = float(np.mean(np.abs(lab[ch] - ref) > TOL_LABELS_REF))
        log(f"dataset build: channel {ch} labels vs pipeline_ref ({'cv2' if HAS_CV2 else 'its '
            'cv2-free emulation'}): SSIM {s_:.6f} (gate {GATE_LABEL_SSIM}), {off:.3%} of pixels "
            f"off by > {TOL_LABELS_REF} (gate {TOL_LABELS_REF_FRAC:.2%}), max |diff| "
            f"{float(np.abs(lab[ch] - ref).max()):.3g}")
        check(s_ >= GATE_LABEL_SSIM, f"dataset build: channel {ch} SSIM {s_:.6f}")
        check(off <= TOL_LABELS_REF_FRAC, f"dataset build: channel {ch}: {off:.3%} off")

    pc = cfg.pipeline
    with torch.no_grad():
        st = EN.pipeline_stages(specs, pc)
        stages = {
            "quantile": lambda: EN.quantile_filter(specs, pc.quant_threshold),
            "blur": lambda: EN.gaussian_blur(st["quant"], pc.gauss_ksize, pc.emulate_uint8),
            "meansub": lambda: EN.mean_subtract(st["gauss"]),
            "morph": lambda: EN.morph(st["mean"], pc.close_se, pc.open_se),
            "meansub 2": lambda: EN.mean_subtract(st["morph"]),
        }
        stage_ms = {k: time_cuda(f) for k, f in stages.items()}
        del st
        ms_labels = time_cuda(lambda: EN.classical_pipeline(specs, pc))
        torch.cuda.reset_peak_memory_stats()
        ms_shot = time_cuda(fn, traces, warmup=3, iters=20)
        peak = torch.cuda.max_memory_allocated()
        ms_host = time_cuda(fn, host, warmup=2, iters=10)
    bound_ms = nbytes(specs, labels) / HBM * 1e3
    log(f"[{gpu}] dataset build stages, ms a shot (CUDA-event medians): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.4f}")
    log(f"[{gpu}] dataset build: process_shot_fn {ms_shot:.4f} ms/shot (median of 20, traces "
        f"on the card; {ms_host:.4f} from host memory), pipeline_specs_per_sec "
        f"{N_CHANNELS / ms_shot * 1e3:.2f}; label pipeline alone {ms_labels:.4f} ms, byte bound "
        f"{bound_ms:.4f} ms (specs read once + labels written once, "
        f"{nbytes(specs, labels) / 1e6:.1f} MB at 3.35 TB/s; {ms_labels / bound_ms:.1f}x); "
        f"peak device memory {peak / 2**30:.3f} GiB")

    with tempfile.TemporaryDirectory() as d:
        paths, want = [], []
        for seed in (SEED, SEED + 1):
            x = host if seed == SEED else example_shot(sp, N_CHANNELS, seed)
            paths.append(os.path.join(d, f"ece_{seed}.bin"))
            write_shot_bin(paths[-1], x)
            want.append(fn(x))
        seen = set()
        with NativePrefetcher(paths, N_CHANNELS, sp.n_samples) as pf:
            for idx, read in pf:
                check(read is not None, f"dataset build: {paths[idx]} unreadable")
                got = fn(read)
                check(torch.equal(got[0], want[idx][0]) and torch.equal(got[1], want[idx][1]),
                      f"dataset build: shot {idx} read from its SPEC binary differs")
                seen.add(idx)
        check(seen == {0, 1}, f"dataset build: prefetcher yielded {sorted(seen)}")
    log(f"dataset build: 2 SPEC binaries read by the "
        f"{'native (C++, mmap) reader' if native_available() else 'Python reader (no g++)'} "
        f"through NativePrefetcher: specs and labels == the in-memory shots' bit for bit")
    return launches[SF.STFT_KERNEL]


def make_data(dev, sp):
    """Phase 7: the recipe's tiles on the card (hyperparam_scan.py:126-149):
    synthetic shots through the dataset build's ``process_shot_fn`` (K1,
    then the classical label pipeline), specs and labels patched, split
    60/25/15.  Returns the split and K1's launches."""
    t0 = time.perf_counter()
    fn = process_shot_fn(Config(spec=sp), dev)
    shots = synthetic_shot_batch(N_SHOTS, N_CHANNELS, sp.n_samples, sp.fs, seed=SEED)
    for kern in _build.KERNELS:
        kern.launches = 0
    xs, ys = [], []
    for s_ in shots:
        specs, labels = fn(s_)
        xs.append(patch(specs))
        ys.append(patch(labels))
        del specs, labels
    torch.cuda.synchronize()
    k1 = SF.STFT_KERNEL.launches
    check(k1 == N_SHOTS, f"phase 7: K1 launched {k1}x for {N_SHOTS} shots")
    del shots
    x, y = torch.cat(xs), torch.cat(ys)
    del xs, ys
    check(tuple(x.shape) == tuple(y.shape) == (N_SHOTS * N_CHANNELS * 30, 256, 128),
          f"tiles {tuple(x.shape)}, labels {tuple(y.shape)}")
    check(bool(torch.isfinite(x).all() and torch.isfinite(y).all()), "non-finite tiles")
    check(float(y.min()) >= 0 and float(y.max()) <= 1, "labels outside [0, 1]")
    data = split_tiles(x, y, TrainConfig().split_fracs)
    log(f"data: {x.shape[0]} tiles -> train {len(data.x_train)}, tune {len(data.x_tune)}, "
        f"test {len(data.x_test)} in {time.perf_counter() - t0:.1f} s; pipeline labels: mean "
        f"{float(y.mean()):.4f}, {float((y == 0).float().mean()):.2%} zeros, "
        f"{float((y > 0.5).float().mean()):.2%} above 0.5; K1 launched {k1}x")
    return data, k1


def check_train_stages(tw, x, y, mask, tag):
    """Phases 8 and 11: every training kernel against its twin, stage by
    stage on the same inputs (the kernels' own outputs feed the next
    stage), over the layer table from conv 0 to the out-conv and back; at
    depth 2 the K5b entry points must equal K5's bit for bit.  Every conv
    must run on the tensor cores in bf16 and on ``conv_quad_kernel`` /
    ``convt_relu_kernel`` in float32; conv 0's routing bits must equal the
    float64 bits but in the near ties ``route_bits64`` counts.  Returns the
    max |err| of each kernel and the stage tensors: ``act[i]`` layer i's
    input, ``bits[i]`` encoder conv i's routing bits, ``dz[i]`` the
    gradient at layer i's output (pooled for the encoder convs)."""
    dt, d, o = tw.dtype, tw.fwd.depth, tw.fwd.out
    pre = d == 2
    act_ = check_bf16_stage if dt == torch.bfloat16 else check_f32
    errs = {}

    def note(kern, e):
        errs[kern] = max(errs.get(kern, 0.0), e)

    x16, y16 = x.to(dt), y.to(dt)
    bf = dt == torch.bfloat16
    multi = IGEMM if bf else QUAD  # the encoder convs' template
    one_in = IN_MMA if bf else QUAD  # conv 0's and the out-conv's input gradient's
    out_t = OUT_MMA if bf else QUAD  # the loss's
    p, pm = on_template("ae_train", one_in, f"{tag} ae_train_in", TK.ae_train_in, tw, x)
    r, rm = TK.ae_train_in_plain(tw, x)
    note(TK.TRAIN_IN, act_(f"{tag} ae_train_in", p, r))
    fr = check_mask(f"{tag} pool-0 routing", pm, rm)
    bits64, near = TK.route_bits64(x16.float(), tw.fwd.w[0].float(), tw.fwd.b[0])
    n_diff = int((pm != bits64).sum())
    check(not bool(((pm != bits64) & ~near).any()),
          f"{tag} pool-0 routing differs from float64 outside the near ties")
    log(f"{tag} pool-0 routing: {n_diff} of {pm.numel()} windows differ from the float64 bits, "
        f"all among the {int(near.sum())} near ties")
    del bits64, near
    if pre:
        q, qm = on_template("ae_train", one_in, f"{tag} ae_train_in_pre", TK.ae_train_in, tw,
                            x16, True)
        check(torch.equal(q, p) and torch.equal(qm, pm), f"{tag} ae_train_in_pre != ae_train_in")
        note(TK.TRAIN_IN_PRE, act_(f"{tag} ae_train_in_pre", q, r))
    act, bits = [x, p], [pm]
    for i in range(1, d):
        p, pm = on_template("ae_train", multi, f"{tag} ae_train_conv_pool {i}",
                            TK.ae_train_conv_pool, tw, act[-1], i)
        r, rm = TK.ae_train_conv_pool_plain(tw, act[-1], i)
        note(TK.TRAIN_CONV_POOL, act_(f"{tag} ae_train_conv_pool {i}", p, r))
        fr = max(fr, check_mask(f"{tag} pool-{i} routing", pm, rm))
        act.append(p)
        bits.append(pm)
    for i in range(d, o):
        a = on_template("ae", convt_template(dt), f"{tag} convT {i}", AK.ae_convt, tw.fwd,
                        act[-1], i)
        r = AK.ae_convt_plain(tw.fwd, act[-1], i)
        note(AK.CONVT, act_(f"{tag} convT {i}", a, r))
        fr = max(fr, check_mask(f"{tag} relu {i}", a > 0, r > 0))
        act.append(a)
    e = act[o]
    logits, dz_o, bce, db_o = on_template("ae_train", out_t, f"{tag} ae_train_loss",
                                          TK.ae_train_loss, tw, e, y, mask)
    rl, rdz, rbce, rdb = TK.ae_train_loss_plain(tw, e, y, mask)
    note(TK.TRAIN_LOSS, max(check_f32(f"{tag} logits", logits, rl),
                            act_(f"{tag} dz{o}", dz_o, rdz),
                            check_sum(f"{tag} BCE sum", bce, rbce),
                            check_sum(f"{tag} db{o}", db_o, rdb)))
    if pre:
        got = on_template("ae_train", out_t, f"{tag} ae_train_loss_pre", TK.ae_train_loss,
                          tw, e, y16, mask, True)
        check(all(torch.equal(a, b) for a, b in zip(got, (logits, dz_o, bce, db_o))),
              f"{tag} ae_train_loss_pre != ae_train_loss")
        note(TK.TRAIN_LOSS_PRE, errs[TK.TRAIN_LOSS])

    def wgrad(i, a, dz, bits_=None, pre_=False):
        got = TK.ae_train_wgrad(tw, i, a, dz, bits_, pre=pre_)
        note(TK.WGRAD_X if i == 0 and not pre_ else TK.WGRAD,
             check_sum(f"{tag} dW{i}", got, TK.ae_train_wgrad_plain(tw, i, a, dz, bits_)))
        return got

    def dgrad(fn, plain, kern, i, dz, gate, *bits_):
        kind = None if kern is TK.DGRAD_CONVT else multi if bits_ else one_in
        out, db = on_template("ae_train", kind, f"{tag} dgrad {i}", fn, tw, i, dz, gate, *bits_)
        rout, rdb = plain(tw, i, dz, gate, *bits_)
        note(kern, max(act_(f"{tag} dgrad {i}", out, rout), check_sum(f"{tag} db{i - 1}", db, rdb)))
        return out

    dz = {o: dz_o}
    wgrad(o, e, dz_o)
    dz[o - 1] = dgrad(TK.ae_train_dgrad_conv, TK.ae_train_dgrad_conv_plain, TK.DGRAD_CONV,
                      o, dz_o, e)
    for i in range(o - 1, d - 1, -1):
        wgrad(i, act[i], dz[i])
        dz[i - 1] = dgrad(TK.ae_train_dgrad_convt, TK.ae_train_dgrad_convt_plain,
                          TK.DGRAD_CONVT, i, dz[i], act[i] if i > d else bits[d - 1])
    for i in range(d - 1, 0, -1):
        wgrad(i, act[i], dz[i], bits[i])
        dz[i - 1] = dgrad(TK.ae_train_dgrad_conv, TK.ae_train_dgrad_conv_plain, TK.DGRAD_CONV,
                          i, dz[i], bits[i - 1], bits[i])
    g0 = wgrad(0, x, dz[0], bits[0])
    if pre:
        check(torch.equal(wgrad(0, x16, dz[0], bits[0], pre_=True), g0), f"{tag} dW0 of K5b != K5")
    part = torch.randn(4096, 288, generator=torch.Generator().manual_seed(SEED)).to(x.device)
    note(TK.TRAIN_SUM, check_sum(f"{tag} ae_train_sum", TK.ae_train_sum(part), part.sum(0)))
    log(f"{tag}: every training stage within tolerance (masks differ on {fr:.3g} of entries"
        + ("; K5b entry points equal K5 bit for bit" if pre else "") + "); max|err| "
        + ", ".join(f"{k.symbol} {v:.3g}" for k, v in errs.items()))
    return errs, dict(x=x, x16=x16, y=y, y16=y16, mask=mask, act=act, bits=bits, dz=dz)


def check_chain(tw, x, y, mask, tag):
    """Phases 8 and 11, float32: the kernels' whole chain against the
    twins' whole chain, which runs its own forward.  Where a pool window's
    two largest values, or a transposed conv's output, lie within float32
    rounding of each other or of 0, the two forwards may gate the gradient
    differently (a routing bit, a relu), and the gradient below moves.  So
    the twins' backward runs on its own forward and again on the kernels':
    on the kernels' forward every gradient sum must agree to TOL_GRAD_SUM;
    on its own, unless some gate differs.  Returns (pool windows routed
    differently, relu gates that differ, the largest relative error on the
    twins' own forward, on the kernels')."""
    s, _, _ = TK._forward(tw, x, y, mask, False)
    gk = TK._backward(tw, s, False)
    p, _, _ = TK._forward(tw, x, y, mask, False, TK._PLAIN)
    n_route = sum(int((a != b).sum()) for a, b in zip(s["bits"], p["bits"]))
    d, o = tw.fwd.depth, tw.fwd.out
    n_relu = sum(int(((s["act"][i] > 0) != (p["act"][i] > 0)).sum()) for i in range(d + 1, o + 1))

    def rel(g):
        return max(max_err(a, b) / max(float(b.abs().max()), 1e-6)
                   for a, b in zip(gk[0] + gk[1], g[0] + g[1]))

    own = rel(TK._backward(tw, p, False, TK._PLAIN))
    fed = rel(TK._backward(tw, s, False, TK._PLAIN))
    log(f"{tag}: whole chain vs the twins' chain: {n_route} pool windows routed differently, "
        f"{n_relu} relu gates differ; gradient sums off by {own:.3g} of their scale on the "
        f"twins' own forward, {fed:.3g} on the kernels' (tol {TOL_GRAD_SUM})")
    check(fed <= TOL_GRAD_SUM, f"{tag}: the twins' backward on the kernels' forward off by {fed:.3g}")
    check(own <= TOL_GRAD_SUM or n_route + n_relu > 0,
          f"{tag}: whole chain off by {own:.3g} with every gate alike")
    return n_route, n_relu, own, fed


def check_autograd(model, x, y, mask, value_and_grad):
    """Phases 8 and 11: the kernels' loss and gradients against torch
    autograd of the module in float32 (TF32 off)."""
    model.zero_grad()
    ref = TK.masked_bce_from_logits(model(x, logits=True), y, mask)
    ref.backward()
    ref = float(ref.detach())
    scale = max(float(p.grad.abs().max()) for p in model.parameters())
    for dt, tol in ((torch.float32, TOL_AUTOGRAD_F32), (torch.bfloat16, TOL_AUTOGRAD_BF16)):
        loss, grads = value_and_grad(model, x, y, mask, dt)
        rel = max(float((grads[n] - p.grad).abs().max()) for n, p in model.named_parameters()) / scale
        lrel = abs(float(loss) - ref) / abs(ref)
        log(f"depth {model.cfg.depth} kernel grads ({dt}) vs f32 autograd, {x.shape[0]} tiles: "
            f"max|dg|/max|g| {rel:.3g} (tol {tol}), loss {float(loss):.7f} vs {ref:.7f} "
            f"(rel {lrel:.3g})")
        check(rel <= tol, f"{dt} gradients off autograd by {rel:.3g}")
        if dt == torch.float32:
            check(lrel <= 1e-5, f"f32 loss off autograd by {lrel:.3g}")
    model.zero_grad()


def train_runs(dev, cfg, data, epochs):
    """Phases 9 and 11: fit on the recipe; returns the training kernels'
    launches.  Depth 2 also runs one epoch of K5 and one of K5b from the
    same weights, which must agree bit for bit."""
    tc = TrainConfig()
    depth2 = cfg.depth == 2

    def state():
        return TR.create_state(cfg, tc, generator=torch.Generator().manual_seed(SEED), device=dev)

    args = (data.x_train, data.y_train, data.x_tune, data.y_tune)
    for kern in _build.KERNELS:
        kern.launches = 0
    before = {lib: _build.conv_template_launches(lib) for lib in ("ae", "ae_train")}
    t0 = time.perf_counter()
    _, hk = TR.fit(state(), *args, cfg=tc, epochs=epochs, epoch_fn=TR.kernel_epoch_for(cfg, tc))
    if depth2:
        s5, _ = TR.fit(state(), *args, cfg=tc, epochs=1, epoch_fn=TR.kernel_epoch_for(cfg, tc))
        s5b, _ = TR.fit(state(), *args, cfg=tc, epochs=1,
                        epoch_fn=TR.kernel_epoch_for(cfg, tc, pre_layout=True))
    torch.cuda.synchronize(dev)
    launches = {kern: kern.launches for kern in _build.KERNELS}
    deltas = template_deltas(before)
    took, took_ae = deltas["ae_train"], deltas["ae"]
    t_kernel = time.perf_counter() - t0
    log(f"depth-{cfg.depth} training launches: " + ", ".join(
        f"{k.symbol}={n}" for k, n in launches.items() if n)
        + f"; {IGEMM}={took[IGEMM]}, {IN_MMA}={took[IN_MMA]}, {OUT_MMA}={took[OUT_MMA]}, "
        f"{QUAD}={took[QUAD]}, {CT_IGEMM}={took_ae[CT_IGEMM]}")
    for kern in (*(TK.TRAIN_KERNELS if depth2 else TRAIN3_KERNELS), AK.CONVT):
        check(launches[kern] > 0, f"{kern.symbol} was not launched by training")
    # a bf16 step, every conv on the tensor cores, none on conv_quad_kernel:
    # the encoder convs' forward and input gradients on conv_igemm_kernel,
    # conv 0 and the out-conv's input gradient (one each a step) on
    # conv_in_mma_kernel, the loss (one a step) on conv_out_mma_kernel, the
    # transposed convs' forward on convt_igemm_kernel; its sums in one call
    steps = launches[TK.TRAIN_LOSS] + launches[TK.TRAIN_LOSS_PRE]
    one_in = launches[TK.TRAIN_IN] + launches[TK.TRAIN_IN_PRE] + steps
    multi = launches[TK.TRAIN_CONV_POOL] + launches[TK.DGRAD_CONV] - steps
    want = {QUAD: 0, IGEMM: multi, CT_RELU: 0, CT_IGEMM: 0, OUT_MMA: steps, IN_MMA: one_in}
    check(took == want, f"training conv templates {took}, expected {want}")
    want = {QUAD: 0, IGEMM: 0, CT_RELU: 0, CT_IGEMM: launches[AK.CONVT], OUT_MMA: 0, IN_MMA: 0}
    check(took_ae == want, f"training forward convT templates {took_ae}, expected {want}")
    check(launches[TK.TRAIN_SUM] == steps,
          f"{launches[TK.TRAIN_SUM]} ae_train_sum calls in {steps} steps")
    # the float32 reference on the pipeline's labels: autograd on cuDNN's
    # deterministic algorithms, twice (the default algorithms need not
    # repeat their sums, and these labels amplify a rounding apart); the
    # bf16 autograd engine beside it, from the same start
    t0 = time.perf_counter()
    with cudnn_deterministic():
        sa, ha = TR.fit(state(), *args, cfg=tc, epochs=epochs)
        t_auto = time.perf_counter() - t0
        sa2, ha2 = TR.fit(state(), *args, cfg=tc, epochs=epochs)
        _, hb = TR.fit(TR.create_state(cfg, tc, generator=torch.Generator().manual_seed(SEED),
                                       device=dev, dtype=torch.bfloat16), *args, cfg=tc,
                       epochs=epochs)
    same = (ha["loss"] == ha2["loss"] and ha["val_loss"] == ha2["val_loss"]
            and all(torch.equal(a, b) for a, b in zip(sa.model.state_dict().values(),
                                                      sa2.model.state_dict().values())))
    check(same, f"two deterministic f32 autograd runs differ: {ha['loss']} vs {ha2['loss']}")
    del sa, sa2
    _, hf = TR.fit(state(), *args, cfg=tc, epochs=epochs,
                   epoch_fn=TR.kernel_epoch_for(cfg, tc, dtype=torch.float32))
    name = "K5" if depth2 else "K7"
    log(f"depth {cfg.depth} fit autograd f32 (cuDNN deterministic), pipeline labels: loss "
        f"{ha['loss']}, val_loss {ha['val_loss']}; a second run: the same bits")
    gaps = {}
    for tag, h in ((f"kernel bf16 ({name})", hk), ("kernel f32", hf), ("autograd bf16", hb)):
        gaps[tag] = [abs(a - b) / b for a, b in zip(h["loss"], ha["loss"])]
        log(f"depth {cfg.depth} fit {tag}, pipeline labels: loss {h['loss']}, val_loss "
            f"{h['val_loss']}; relative gap to f32 autograd per epoch "
            + ", ".join(f"{r:.3g}" for r in gaps[tag]))
    log(f"wall: kernel runs ({epochs}{' + 1 + 1' if depth2 else ''} epochs) {t_kernel:.1f} s, "
        f"autograd run (deterministic) {t_auto:.1f} s")
    check(hk["loss"][-1] < hk["loss"][0], f"loss did not fall: {hk['loss']}")
    check(ha["loss"][-1] < ha["loss"][0], f"autograd loss did not fall: {ha['loss']}")
    check(all(np.isfinite(hk["val_loss"] + ha["val_loss"] + hf["val_loss"])),
          "non-finite val_loss")
    # the loss-curve gate on the pipeline's labels (TOL_PIPE_CURVE)
    for i, (a, r, b) in enumerate(zip(hk["loss"], ha["loss"], hb["loss"])):
        tol = max(TOL_LOSS_CURVE * r, TOL_PIPE_CURVE * abs(b - r))
        check(abs(a - r) <= tol, f"pipeline labels, epoch {i}: kernel bf16 loss {a} vs f32 "
              f"autograd {r}: off by {abs(a - r):.3g} > {tol:.3g} (bf16 autograd {b})")
    # the loss-curve gate, on the stand-in labels (TOL_LOSS_CURVE)
    stand = (data.x_train, (0.8 * data.x_train + 0.1).clamp(0, 1),
             data.x_tune, (0.8 * data.x_tune + 0.1).clamp(0, 1))
    _, sk = TR.fit(state(), *stand, cfg=tc, epochs=epochs, epoch_fn=TR.kernel_epoch_for(cfg, tc))
    _, sa = TR.fit(state(), *stand, cfg=tc, epochs=epochs)
    del stand
    log(f"depth {cfg.depth} stand-in labels: kernel bf16 loss {sk['loss']}, autograd f32 "
        f"loss {sa['loss']}")
    for i, (a, b) in enumerate(zip(sk["loss"], sa["loss"])):
        check(abs(a - b) <= TOL_LOSS_CURVE * b, f"epoch {i} loss {a} vs f32 autograd {b}")
    check(sk["loss"][-1] < sk["loss"][0], f"stand-in loss did not fall: {sk['loss']}")
    if depth2:
        same = all(torch.equal(a, b) for a, b in zip(s5.model.state_dict().values(),
                                                     s5b.model.state_dict().values()))
        check(same, "after one epoch the K5b run's parameters differ from K5's")
    log(f"gates: on the stand-in labels per-epoch loss within {TOL_LOSS_CURVE:.1%} of f32 "
        f"autograd; on the pipeline's labels within max({TOL_LOSS_CURVE:.1%}, "
        f"{TOL_PIPE_CURVE:g} x the bf16 autograd engine's gap) of deterministic f32 "
        f"autograd, which repeats bit for bit, both falling, val finite"
        + ("; K5b parameters == K5 parameters bit for bit after one epoch" if depth2 else ""))
    return launches


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, set and restored."""
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old


def check_repeat(tw, x, y, mask, tag):
    """Phases 8 and 11: two runs of one step's kernels give the same loss
    and gradient sums, bit for bit (every cross-block sum is a fixed-order
    sum of partials; no float atomics)."""
    a = TK.loss_grad_sums(tw, x, y, mask)
    b = TK.loss_grad_sums(tw, x, y, mask)
    same = torch.equal(a[0], b[0]) and all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    check(same, f"{tag}: two runs of a step differ")
    log(f"{tag}: two runs of a step give the same loss and gradient sums, bit for bit")


def time_training(gpu, cfg, data, tw, st):
    """Phases 10 and 11: each training kernel over its launches in a
    128-tile step, its twin, the PyTorch calls that compute the same
    function, its bound; then the engines' s/epoch, tiles/s and the peak
    memory of a step."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    bf, w = torch.bfloat16, tw.fwd
    d, o = w.depth, w.out
    s, act, bits, dz = st, st["act"], st["bits"], st["dz"]
    b = s["x"].shape[0]
    depth2 = d == 2
    cw = [AK._conv_w(w, i).to(bf) for i in range(o + 1)]       # (out, in, k, k)
    kflip = [w.w[i].flip(1, 2).permute(0, 3, 1, 2).to(bf).contiguous() for i in range(o + 1)]
    tflip = [w.w[i].permute(0, 3, 1, 2).flip(2, 3).to(bf).contiguous() for i in range(o + 1)]
    dzx = {i: TK.route_expand(dz[i], bits[i]).to(bf) for i in range(d)}  # full-res encoder dz
    x1 = s["x16"][:, None]
    ins = [x1] + act[1:]
    enc, dec = range(1, d), range(d, o)
    gate = {i: act[i] if i > d else bits[d - 1] for i in dec}

    def fl(layers):
        return sum(conv_flops(w, i, b, *ins[i].shape[2:]) for i in layers)

    def pad(i):
        return w.k(i) // 2

    # the partials a step sums (the loss's, each input gradient's bias
    # partials, each layer's weight-gradient partials), as one plan
    parts = [torch.rand(n, m, device=s["x"].device) for n, m in TK.step_partials(tw, b)]

    def batched_sums():
        plan = TK.step_sums(tw, s["x"].device)
        out = [plan.add(p) for p in parts]
        plan.run()
        return out

    wg = [(o, act[o], dz[o], None)] + [(i, act[i], dz[i], None) for i in reversed(dec)] \
        + [(i, act[i], dz[i], bits[i]) for i in reversed(enc)]
    # kernel: (kernel launches, plain, library call, FLOPs, bytes); the
    # bytes are the function's: each input read once, each output written
    # once (the weight gradients' per-tile partials are the kernels' choice)
    entries = {
        TK.TRAIN_IN: (lambda: TK.ae_train_in(tw, s["x"]), lambda: TK.ae_train_in_plain(tw, s["x"]),
                      lambda: F.conv2d(x1, cw[0], padding=pad(0)),
                      fl([0]), nbytes(s["x"], act[1], bits[0])),
        TK.TRAIN_CONV_POOL: (
            lambda: [TK.ae_train_conv_pool(tw, act[i], i) for i in enc],
            lambda: [TK.ae_train_conv_pool_plain(tw, act[i], i) for i in enc],
            lambda: [F.conv2d(act[i], cw[i], padding=pad(i)) for i in enc],
            fl(enc), sum(nbytes(act[i], act[i + 1], bits[i]) for i in enc)),
        AK.CONVT: (lambda: [AK.ae_convt(w, act[i], i) for i in dec],
                   lambda: [AK.ae_convt_plain(w, act[i], i) for i in dec],
                   lambda: [F.conv_transpose2d(act[i], tflip[i], w.b[i].to(bf), stride=2,
                                               padding=w.k(i) - 1 - convt_pad_before(w.k(i)),
                                               output_padding=1) for i in dec],
                   fl(dec), sum(nbytes(act[i], act[i + 1]) for i in dec)),
        TK.TRAIN_LOSS: (lambda: TK.ae_train_loss(tw, act[o], s["y"], s["mask"]),
                        lambda: TK.ae_train_loss_plain(tw, act[o], s["y"], s["mask"]),
                        lambda: F.conv2d(act[o], cw[o], padding=pad(o)),
                        fl([o]), nbytes(act[o], s["y"], s["y"], dz[o], s["mask"])),
        TK.DGRAD_CONV: (
            lambda: [TK.ae_train_dgrad_conv(tw, o, dz[o], act[o])]
            + [TK.ae_train_dgrad_conv(tw, i, dz[i], bits[i - 1], bits[i]) for i in enc],
            lambda: [TK.ae_train_dgrad_conv_plain(tw, o, dz[o], act[o])]
            + [TK.ae_train_dgrad_conv_plain(tw, i, dz[i], bits[i - 1], bits[i]) for i in enc],
            lambda: [conv2d_input(act[o].shape, cw[o], dz[o], padding=pad(o))]
            + [conv2d_input(act[i].shape, cw[i], dzx[i], padding=pad(i)) for i in enc],
            fl([o, *enc]), nbytes(dz[o], act[o], dz[o - 1])
            + sum(nbytes(dz[i], bits[i], bits[i - 1], dz[i - 1]) for i in enc)),
        TK.DGRAD_CONVT: (
            lambda: [TK.ae_train_dgrad_convt(tw, i, dz[i], gate[i]) for i in dec],
            lambda: [TK.ae_train_dgrad_convt_plain(tw, i, dz[i], gate[i]) for i in dec],
            lambda: [F.conv2d(dz[i], kflip[i], stride=2, padding=pad(i)) for i in dec],
            fl(dec), sum(nbytes(dz[i], gate[i], dz[i - 1]) for i in dec)),
        TK.WGRAD: (
            lambda: [TK.ae_train_wgrad(tw, i, a, g, bb) for i, a, g, bb in wg],
            lambda: [TK.ae_train_wgrad_plain(tw, i, a, g, bb) for i, a, g, bb in wg],
            lambda: [conv2d_weight(act[o], cw[o].shape, dz[o], padding=pad(o))]
            + [conv2d_weight(dz[i], kflip[i].shape, act[i], stride=2, padding=pad(i))
               for i in dec]
            + [conv2d_weight(act[i], cw[i].shape, dzx[i], padding=pad(i)) for i in enc],
            fl(range(1, o + 1)),
            sum(nbytes(a, g) for _, a, g, _ in wg) + sum(nbytes(bits[i]) for i in enc)
            + 4 * sum(w.w[i].numel() for i in range(1, o + 1))),
        TK.WGRAD_X: (lambda: TK.ae_train_wgrad(tw, 0, s["x"], dz[0], bits[0]),
                     lambda: TK.ae_train_wgrad_plain(tw, 0, s["x"], dz[0], bits[0]),
                     lambda: conv2d_weight(x1, cw[0].shape, dzx[0], padding=pad(0)),
                     fl([0]), nbytes(s["x"], dz[0], bits[0]) + 4 * w.w[0].numel()),
        TK.TRAIN_SUM: (batched_sums,
                       lambda: [p.sum(0) for p in parts],
                       lambda: [torch.sum(p, 0) for p in parts],
                       sum(p.numel() for p in parts), sum(nbytes(p) for p in parts)),
    }
    if depth2:
        entries[TK.TRAIN_IN_PRE] = (
            lambda: TK.ae_train_in(tw, s["x16"], pre=True),
            lambda: TK.ae_train_in_plain(tw, s["x16"]),
            lambda: F.conv2d(x1, cw[0], padding=pad(0)),
            fl([0]), nbytes(s["x16"], act[1], bits[0]))
        entries[TK.TRAIN_LOSS_PRE] = (
            lambda: TK.ae_train_loss(tw, act[o], s["y16"], s["mask"], pre=True),
            lambda: TK.ae_train_loss_plain(tw, act[o], s["y16"], s["mask"]),
            lambda: F.conv2d(act[o], cw[o], padding=pad(o)),
            fl([o]), nbytes(act[o], s["y16"], s["y"], dz[o], s["mask"]))
    times = time_entries(gpu, entries, tw.dtype, f" per {b}-tile step (depth {d})")
    # conv 0 and the loss are short kernels: their device time (torch.profiler)
    # beside the CUDA-event time, which includes the wrapper's host path
    for kern, tmpl in ((TK.TRAIN_IN, IN_MMA), (TK.TRAIN_LOSS, OUT_MMA)):
        log(f"[{gpu}] {kern.symbol} (depth {d}): device time {device_ms(entries[kern][0], tmpl):.4f} "
            f"ms ({tmpl}, torch.profiler), CUDA events {times[kern]['ms']:.4f} ms")
    # the two kinds of ae_train_dgrad_conv launch apart: the out-conv's (one
    # dz channel, conv_in_mma_kernel) and the encoder convs' (routed dz,
    # conv_igemm_kernel), each with its ae_train_sum, conv2d_input and its
    # bound
    apart = {
        "out-conv": (lambda: TK.ae_train_dgrad_conv(tw, o, dz[o], act[o]),
                     lambda: conv2d_input(act[o].shape, cw[o], dz[o], padding=pad(o)),
                     fl([o]), nbytes(dz[o], act[o], dz[o - 1]), 1),
        "encoder": (lambda: [TK.ae_train_dgrad_conv(tw, i, dz[i], bits[i - 1], bits[i])
                             for i in enc],
                    lambda: [conv2d_input(act[i].shape, cw[i], dzx[i], padding=pad(i))
                             for i in enc],
                    fl(enc), sum(nbytes(dz[i], bits[i], bits[i - 1], dz[i - 1]) for i in enc),
                    len(enc)),
    }
    # ae_train_sum's row times a step's one batched call from the host's
    # side of the stream, its plan's Python included; the kernels' own
    # device time beside torch.sum's, from torch.profiler
    k_dev = device_ms(batched_sums, "sum_rows_kernel")
    l_dev = device_ms(lambda: [torch.sum(p, 0) for p in parts], "reduce_kernel")
    check(all(torch.equal(a, TK.ae_train_sum(p)) for a, p in zip(batched_sums(), parts)),
          "a step's batched sums differ from the per-call sums")
    log(f"[{gpu}] ae_train_sum, a step's {len(parts)} partial arrays in one call (bit for bit "
        f"the per-call sums), device time (torch.profiler): sum_rows_kernel {k_dev:.4f} ms, "
        f"torch.sum's kernels {l_dev:.4f} ms")
    for name, (kf, lf, flops, nb, n_launch) in apart.items():
        ms = min(time_cuda(kf), time_cuda(kf))
        with torch.no_grad():
            lib_ms = time_cuda(lf)
        b_ms, b_by = bound(flops, nb, tw.dtype)
        log(f"[{gpu}] ae_train_dgrad_conv, {name} ({n_launch} a step, depth {d}): kernel "
            f"{ms:.4f} ms, conv2d_input {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{flops / 1e9:.3f} GFLOP, {nb / 1e6:.1f} MB), achieved {flops / ms / 1e9:.2f} TFLOP/s")
    # a step's stages with its sums in one call (loss_grad_sums) against the
    # same stages each summing its own partials, in turns: what the batched
    # sums move in a step
    def per_call():
        saved, _, _ = TK._forward(tw, s["x"], s["y"], s["mask"], False)
        return TK._backward(tw, saved, False)

    def batched():
        return TK.loss_grad_sums(tw, s["x"], s["y"], s["mask"])

    turns = [time_cuda(f, iters=20) for f in (per_call, batched, batched, per_call)]
    log(f"[{gpu}] depth {d} step's stages (no optimizer), median of 20: sums in one call "
        f"{turns[1]:.4f}/{turns[2]:.4f} ms, per-call sums {turns[0]:.4f}/{turns[3]:.4f} ms")
    # forward and weight gradients of every layer, input gradients of all
    # but conv 0
    flops_step = 2 * fl(range(o + 1)) + fl(range(1, o + 1))

    # one step of each engine, and one epoch of each
    tc = TrainConfig()
    x, y = data.x_train, data.y_train
    n = x.shape[0]
    bi, bm = TR._epoch_batches(n, BATCH, np.random.default_rng(SEED).permutation(n))
    bi, bm = torch.from_numpy(bi).to(x.device), torch.from_numpy(bm).to(x.device)
    kname = "K5" if depth2 else "K7"
    engines = [(f"kernel bf16 ({kname})", TR.kernel_epoch_for(cfg, tc))]
    if depth2:
        engines.append(("kernel bf16 (K5b)", TR.kernel_epoch_for(cfg, tc, pre_layout=True)))
    engines += [("kernel f32", TR.kernel_epoch_for(cfg, tc, dtype=torch.float32)),
                ("autograd f32", TR.train_epoch), ("autograd bf16", TR.train_epoch)]
    sec_of, losses_of = {}, {}
    for name, epoch_fn in engines:
        state = TR.create_state(cfg, tc, generator=torch.Generator().manual_seed(SEED),
                                device=x.device,
                                dtype=torch.bfloat16 if name == "autograd bf16" else None)
        epoch_fn(state, x, y, bi[:2], bm[:2])  # warm-up: two steps
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_cuda(lambda: epoch_fn(state, x, y, bi[:1], bm[:1]), warmup=1, iters=10)
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        _, losses = epoch_fn(state, x, y, bi, bm)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        sec_of[name], losses_of[name] = sec, losses.float().cpu()
        log(f"[{gpu}] depth {d} {name}: {sec:.4f} s/epoch ({bi.shape[0]} steps of {BATCH}), "
            f"{n / sec:.1f} tiles/s; step {step_ms:.4f} ms (CUDA events, median of 10, "
            f"with the optimizer{'; K5b casts all tiles once per call' if 'K5b' in name else ''}"
            f"; {flops_step / step_ms / 1e9:.2f} TFLOP/s of the step's {flops_step / 1e9:.1f} "
            f"GFLOP); peak device memory of a step {peak / 2**30:.3f} GiB above the "
            f"{base / 2**30:.3f} GiB resident")
    # the bf16 autograd engine (create_state(dtype=bfloat16)): its epoch,
    # from the same weights and batches as the f32 one, must give finite,
    # falling losses
    l16, l32 = losses_of["autograd bf16"], losses_of["autograd f32"]
    e16, e32 = (float(TR.weighted_epoch_mean(v, bm.cpu())) for v in (l16, l32))
    log(f"[{gpu}] depth {d} autograd bf16 epoch: {sec_of['autograd bf16']:.4f} s/epoch "
        f"against autograd f32 {sec_of['autograd f32']:.4f} s/epoch "
        f"({sec_of['autograd bf16'] / sec_of['autograd f32']:.3f}x); epoch loss {e16:.6f} "
        f"vs f32 {e32:.6f} (rel {abs(e16 - e32) / e32:.3g}); first 10 batches "
        f"{float(l16[:10].mean()):.6f}, last 10 {float(l16[-10:].mean()):.6f}")
    check(bool(torch.isfinite(l16).all()), "autograd bf16: non-finite loss")
    check(float(l16[-10:].mean()) < float(l16[:10].mean()), "autograd bf16: loss did not fall")
    # a step's kernels; the stage wrappers' times include their
    # ae_train_sum launches, so the sums' own row is left out here
    step = {k.symbol: t["ms"] for k, t in times.items()
            if k not in (*K5B_KERNELS, TK.TRAIN_SUM)}
    k_sum = sum(step.values())
    log(f"[{gpu}] {kname} step, sum of its kernels' times: {k_sum:.4f} ms: " + ", ".join(
        f"{name} {ms:.4f} ms ({ms / k_sum:.1%})"
        for name, ms in sorted(step.items(), key=lambda kv: -kv[1])))
    return times


def train_family(dev, gpu, cfg, data, extra, epochs, value_and_grad, build_train):
    """Phases 8-10 (flagship) or 11 (deep3): stage checks on one batch and
    on ``extra`` geometries (4 tiles), gradients against autograd, fit
    (its launches are the rows'), timings."""
    xb, yb = data.x_train[:BATCH], data.y_train[:BATCH]
    mb = torch.ones(BATCH, device=dev)
    model = make_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    for dt in (torch.bfloat16, torch.float32):
        tw = build_train(model, dt)
        e, st = check_train_stages(tw, xb, yb, mb, f"depth {cfg.depth} {dt}, {BATCH} tiles")
        if dt == torch.bfloat16:
            errs, tw16, tstate = e, tw, st
    check_chain(tw, xb, yb, mb, f"depth {cfg.depth} f32, {BATCH} tiles")
    for name, gcfg in extra:
        m = make_model(gcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        for dt in (torch.bfloat16, torch.float32):
            tw = build_train(m, dt)
            check_train_stages(tw, xb[:4], yb[:4], mb[:4], f"{name} {dt}, 4 tiles")
        check_chain(tw, xb[:4], yb[:4], mb[:4], f"{name} f32, 4 tiles")
    check_autograd(model, xb, yb, mb, value_and_grad)
    check_repeat(tw16, xb, yb, mb, f"depth {cfg.depth} bf16, {BATCH} tiles")
    launches = train_runs(dev, cfg, data, epochs)
    times = time_training(gpu, cfg, data, tw16, tstate)
    for kern, t in times.items():
        row(kern, train_id(kern, cfg.depth)).update(
            launches=launches[kern], max_abs_err=errs[kern], **t)


def counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with every launch count set to 0 just before it;
    returns (its result, the launches of each kernel in it)."""
    for kern in _build.KERNELS:
        kern.launches = 0
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, {kern: kern.launches for kern in _build.KERNELS if kern.launches}


def add_sweep_launches(launches: dict, depth: int, serving: bool, phase: str = "14") -> None:
    """A run's launches into the kernels line's rows: a training run's (the
    training kernels and the forward transposed convs) or a pred_times
    run's (the serving stages), at ``depth``."""
    for kern, n in launches.items():
        kid = SERVE_IDS[depth].get(kern) if serving else train_id(kern, depth)
        check(kid is not None and (kern, kid) in ROWS,
              f"phase {phase}: {kern.symbol} launched outside its rows (depth {depth})")
        ROWS[(kern, kid)]["launches"] += n


def sweep_run(dev, gpu, tag, configs, data, epochs, depth):
    """Phase 14 (a) and (b): ``sweep_fit_serial`` in bf16 on the recipe's
    tiles and the pipeline's labels, counted, every config on the training
    kernels; the artifacts; ``config_pred_times`` on 30 tune tiles,
    counted, every config on the serving kernels; then each config's
    s/epoch, tiles/s and step memory on the kernel engine alone."""
    tc = TrainConfig()
    n, nb = len(data.x_train), -(-len(data.x_train) // BATCH)
    t0 = time.perf_counter()
    res, tl = counted(SW.sweep_fit_serial, configs, data.x_train, data.y_train, data.x_tune,
                      data.y_tune, tc, epochs=epochs, dtype=torch.bfloat16, device=dev)
    wall = time.perf_counter() - t0
    steps = len(configs) * epochs * nb
    loss_kern = TK.TRAIN_LOSS
    check(tl.get(loss_kern, 0) == steps and tl.get(TK.TRAIN_SUM, 0) == steps,
          f"{tag}: {tl.get(loss_kern, 0)} kernel steps for {len(configs)} configs x {epochs} "
          f"epochs x {nb} batches: not every config trained on the kernels")
    want = set(TK.TRAIN_KERNELS if depth == 2 else TRAIN3_KERNELS) - set(K5B_KERNELS)
    check(set(tl) == want | {AK.CONVT}, f"{tag}: training launched "
          f"{sorted(k.symbol for k in tl)}")
    check(bool((res.train_history[-1] < res.train_history[0]).all()),
          f"{tag}: a config's loss did not fall: {res.train_history.T.tolist()}")
    check(bool(np.isfinite(res.val_history).all()), f"{tag}: non-finite val_loss")
    names = [f"k{c.kernels[0][0]}" if depth == 2 else str(c.filters) for c in configs]
    log(f"[{gpu}] phase 14 {tag}: sweep_fit_serial bf16, {len(configs)} configs x {epochs} "
        f"epochs on {n} tiles (pipeline labels) in {wall:.1f} s, {tl.get(loss_kern, 0)} kernel steps "
        f"(= configs x epochs x {nb}); launches " + ", ".join(
            f"{k.symbol}={v}" for k, v in tl.items()))
    for i, nm in enumerate(names):
        log(f"  {nm}: loss {res.train_history[:, i].tolist()}, val_loss "
            f"{res.val_history[:, i].tolist()}")
    pt, sl = counted(SW.config_pred_times, res, data.x_tune[:30], device=dev)
    check(sl.get(AK.TILE_IN, 0) == 9 * len(configs) and set(sl) == set(STAGES),
          f"{tag}: pred_times launched {[(k.symbol, v) for k, v in sl.items()]}: not every "
          f"config served on the kernels (9 calls each)")
    grid = (len(configs),)
    comp = SW.marginal_report(res.val_losses, grid, ["kernel"])
    log(f"  val_losses {res.val_losses.tolist()}, best_index {res.best_index} "
        f"({names[res.best_index]}); loss_comparisons kernel_loss "
        f"{comp['kernel'][:, 0].tolist()}, kernel_time "
        f"{SW.marginal_report(pt, grid, ['kernel'])['kernel'][:, 0].tolist()}")
    log(f"  pred_times (make_production_predict_fn, bf16 kernels, 30 tiles, 8 calls after a "
        f"synchronized warm-up): " + ", ".join(
            f"{nm} {t * 1e3:.5f} ms/tile" for nm, t in zip(names, pt))
        + "; serving launches " + ", ".join(f"{k.symbol}={v}" for k, v in sl.items()))
    add_sweep_launches(tl, depth, serving=False)
    add_sweep_launches(sl, depth, serving=True)
    bi, bm = TR._epoch_batches(n, BATCH, np.random.default_rng(SEED).permutation(n))
    bi, bm = torch.from_numpy(bi).to(dev), torch.from_numpy(bm).to(dev)
    for i, cfg in enumerate(configs):
        state = TR.create_state(cfg, tc, device=dev)
        state.model.load_state_dict(SW.extract_config_params(res.stacked_params, i, cfg,
                                                             res.env))
        epoch_fn = TR.kernel_epoch_for(cfg, tc)
        epoch_fn(state, data.x_train, data.y_train, bi[:2], bm[:2])  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        epoch_fn(state, data.x_train, data.y_train, bi[:1], bm[:1])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        epoch_fn(state, data.x_train, data.y_train, bi, bm)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        log(f"[{gpu}]   {names[i]} kernel bf16 engine: {sec:.4f} s/epoch ({nb} steps of "
            f"{BATCH}), {n / sec:.1f} tiles/s, peak device memory of a step "
            f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB resident")
    return res


def envelope_check(dev, gpu, configs, data):
    """Phase 14 (c): the envelope engine (float32, TF32 off) against the
    serial engine on the float32 kernels and on the bf16 kernels, on the
    cut tiles and the stand-in labels, per config and epoch; the bf16
    envelope (the CLI's ``--bf16``) timed and printed beside them."""
    tc = TrainConfig()
    x, xv = data.x_train[:N_CUT], data.x_tune[:N_CUT_TUNE]
    args = (x, (0.8 * x + 0.1).clamp(0, 1), xv, (0.8 * xv + 0.1).clamp(0, 1))
    runs, secs = {}, {}
    for name, fn, kw in (("envelope f32", SW.sweep_fit, {}),
                         ("serial kernels f32", SW.sweep_fit_serial, dict(dtype=torch.float32)),
                         ("serial kernels bf16", SW.sweep_fit_serial,
                          dict(dtype=torch.bfloat16)),
                         ("envelope bf16", SW.sweep_fit, dict(dtype=torch.bfloat16))):
        t0 = time.perf_counter()
        runs[name], tl = counted(fn, configs, *args, tc, epochs=EPOCHS_SWEEP, device=dev, **kw)
        secs[name] = (time.perf_counter() - t0) / EPOCHS_SWEEP
        if fn is SW.sweep_fit:
            check(not tl, f"{name}: launched {[k.symbol for k in tl]}")
        else:
            add_sweep_launches(tl, 2, serving=False)
        r = runs[name]
        log(f"[{gpu}] phase 14 (c) {name}: {secs[name]:.3f} s/epoch for {len(configs)} configs "
            f"on {len(x)} tiles (validation on {len(xv)} included); loss "
            f"{r.train_history.T.tolist()}, val_loss {r.val_history.T.tolist()}")
    env = runs["envelope f32"]
    for name in ("serial kernels f32", "serial kernels bf16"):
        ref = runs[name]
        for hist in ("train_history", "val_history"):
            a, b = getattr(env, hist), getattr(ref, hist)
            rel = np.abs(a - b) / b
            log(f"  envelope vs {name}, {hist}: max relative gap {rel.max():.3g} "
                f"(per config {rel.max(axis=0).tolist()})")
            check(bool((rel <= TOL_LOSS_CURVE).all()),
                  f"envelope vs {name}: {hist} apart by {rel.max():.3g} > {TOL_LOSS_CURVE}")
        top = np.sort(ref.val_losses)[:2]
        if (top[1] - top[0]) / top[0] > 10 * TOL_LOSS_CURVE:
            check(env.best_index == ref.best_index,
                  f"envelope best {env.best_index}, {name} best {ref.best_index}")
    ref = runs["serial kernels bf16"]
    rel = np.abs(runs["envelope bf16"].train_history - ref.train_history) / ref.train_history
    log(f"  envelope bf16 (--bf16, not gated) vs serial kernels bf16, train_history: max "
        f"relative gap {rel.max():.3g}")
    log(f"[{gpu}] phase 14 (c): s/epoch (2 epochs, set-up included) envelope f32 "
        f"{secs['envelope f32']:.3f}, bf16 {secs['envelope bf16']:.3f}; serial kernels f32 "
        f"{secs['serial kernels f32']:.3f}, bf16 "
        f"{secs['serial kernels bf16']:.3f}; best_index {env.best_index} "
        f"(serial {runs['serial kernels f32'].best_index}, "
        f"{runs['serial kernels bf16'].best_index})")


def uncovered_grid(dev, gpu, data):
    """Phase 14 (d): a 2layer grid whose 16-filter config no kernel family
    covers: it trains on the module engine, the 32-filter one on the
    kernels (one config's launches, no more)."""
    configs, shape = SW.expand_grid_2layer(SweepConfig(
        ker1_vals=((3, 3),), ker2_vals=((3, 3),), ker3_vals=((3, 3),), conv1_vals=(16, 32),
        conv2_vals=(32,)))
    check(not AK.supports(configs[0]) and AK.supports(configs[1]), "phase 14 (d) grid")
    x, xv = data.x_train[:N_CUT], data.x_tune[:N_CUT_TUNE]
    res, tl = counted(SW.sweep_fit_serial, configs, x, (0.8 * x + 0.1).clamp(0, 1), xv,
                      (0.8 * xv + 0.1).clamp(0, 1), TrainConfig(), epochs=1,
                      dtype=torch.bfloat16, device=dev)
    steps = -(-N_CUT // BATCH)
    check(tl.get(TK.TRAIN_LOSS, 0) == steps,
          f"(d): {tl.get(TK.TRAIN_LOSS, 0)} kernel steps, expected {steps} (one config's)")
    check(bool(np.isfinite(res.val_losses).all()), "(d): non-finite val_loss")
    add_sweep_launches(tl, 2, serving=False)
    log(f"[{gpu}] phase 14 (d): grid {shape}, (16, 32)/k3 on the module engine (bf16 "
        f"autograd), (32, 32)/k3 on the kernels: {tl.get(TK.TRAIN_LOSS, 0)} kernel steps = one "
        f"config's {steps}; val_losses {res.val_losses.tolist()}")


def sweep_phase(dev, gpu, data):
    """Phase 14: hyperparameter sweeps on the kernels (see the docstring)."""
    t0 = time.perf_counter()
    kernel_grid = [ModelConfig(filters=(32, 32), kernels=(k, k), out_kernel=k)
                   for k in SweepConfig().kernel_vals]
    sweep_run(dev, gpu, "(a) kernel grid (32,32) k3/k5/k7", kernel_grid, data, EPOCHS_SWEEP, 2)
    grid3, _ = SW.expand_grid_3layer(SweepConfig())
    check(grid3 == [DEEP3], f"3layer default grid {grid3}")
    sweep_run(dev, gpu, "(b) 3layer default grid (deep3)", grid3, data, EPOCHS_SWEEP, 3)
    envelope_check(dev, gpu, kernel_grid, data)
    uncovered_grid(dev, gpu, data)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")


def lowrank_batch(dev, n: int, seed: int) -> torch.Tensor:
    """The headline's SVD test batch (headline.py:178-193), drawn with
    numpy: 6 smooth modes x 3 plus 0.3 noise, (n, 256, 3905) float32."""
    f_, t_, rank = 256, 3905, 6
    rng = np.random.default_rng(seed)
    ph_u, ph_v = rng.uniform(0, 6.28, (2, n, rank))
    amps = rng.uniform(0.5, 1.0, (n, rank))
    f = torch.linspace(0.0, 1.0, f_, device=dev)[None, :, None]
    t = torch.linspace(0.0, 1.0, t_, device=dev)[None, None, :]
    x = 0.3 * torch.from_numpy(rng.standard_normal((n, f_, t_), dtype=np.float32)).to(dev)
    amps, ph_u, ph_v = (torch.from_numpy(a).float().to(dev)[..., None, None]
                        for a in (amps, ph_u, ph_v))
    for k in range(rank):
        x += 3.0 * amps[:, k] * torch.sin(3.1 * (k + 1) * f + ph_u[:, k]) \
            * torch.cos(2.3 * (k + 1) * t + ph_v[:, k])
    return x


def gate_matrix(seed: int) -> np.ndarray:
    """A well-conditioned (256, 3905) float64 matrix, sigma_k = 100 x
    0.93^k (headline.py:211-217): every component compute_signal keeps is
    well determined."""
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((256, 256)))
    q2, _ = np.linalg.qr(rng.standard_normal((3905, 256)))
    return (q1 * (100.0 * 0.93 ** np.arange(256))) @ q2.T


# phase 15 (a) splits the device time by kernel name: cuSOLVER's eigh (the
# batched Jacobi kernels PyTorch calls for eigh and eigvalsh, or syevd's),
# its QR (Householder panels and the forming of Q) and the products
# (cuBLAS and CUTLASS GEMM and GEMV); a GEMM inside cuSOLVER counts as a
# product (the names seen on an H100 under torch 2.11)
NAME_CLASSES = (("eigh", ("syev", "sytrd", "stedc", "ormtr", "rotate_batch", "jacobi")),
                ("qr", ("geqr", "orgqr", "org2r", "orm2r", "ormqr", "larf", "householder")),
                ("matmul", ("gemm", "gemv", "xmma", "cutlass")))


def linalg_split(fn) -> dict:
    """Device milliseconds of one call of ``fn`` (after a warm-up), from
    torch.profiler's device events, split by kernel name (NAME_CLASSES);
    the longest kernels of the call and of what no class claims; None
    where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts, names = dict.fromkeys(("eigh", "qr", "matmul", "other"), 0.0), {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0.0) + e.device_time_total / 1e3
    cls = {nm: next((c for c, keys in NAME_CLASSES if any(k in nm.lower() for k in keys)), "other")
           for nm in names}
    for nm, ms in names.items():
        parts[cls[nm]] += ms
    total = sum(parts.values())
    if not total:
        return dict.fromkeys((*parts, "kernels", "top", "top_other"))
    top = sorted(names.items(), key=lambda kv: -kv[1])
    return {**parts, "kernels": total, "top": top[:3],
            "top_other": [kv for kv in top if cls[kv[0]] == "other"][:3]}


def svd_phase(dev, sp, gpu) -> None:
    """Phase 15 (a): the SVD denoiser on K1's spectrograms and on the
    headline's low-rank batch (see the docstring)."""
    traces = torch.from_numpy(example_shot(sp, N_CHANNELS, SEED)).to(dev)
    specs, k1 = counted(SF.spectrogram_fused, traces, sp)
    check(k1 == {SF.STFT_KERNEL: 1}, f"phase 15 (a): K1 launches {k1}")
    row(SF.STFT_KERNEL, "K1")["launches"] += 1
    del traces
    fns = {"denoise_signal": SVD.denoise_signal,
           "denoise_signal(use_optimal)": lambda x: SVD.denoise_signal(x, use_optimal=True),
           "compute_signal": SVD.compute_signal, "deflate_top1": SVD.deflate_top1}
    for name, x in (("K1 spectrograms", specs), ("low-rank batch", lowrank_batch(dev, N_CHANNELS, 7))):
        outs = {k: f(x) for k, f in fns.items()}
        for k, o in outs.items():
            check(o.shape == x.shape and bool(torch.isfinite(o).all()),
                  f"phase 15 (a) {name} {k}: shape {tuple(o.shape)} or non-finite")
        x0 = x[0].double().cpu().numpy()
        q = ssim(outs["denoise_signal"][0].cpu().numpy(), svd_denoise_ref(x0))
        q_opt = ssim(outs["denoise_signal(use_optimal)"][0].cpu().numpy(),
                     svd_denoise_ref(x0, use_optimal=True))
        scale = float(x.abs().max())
        defl = max_err(outs["deflate_top1"], outs["denoise_signal"]) / scale
        count = SVD.gavish_donoho_count(SVD._full_spectrum_for_median(x), x.shape)
        log(f"[{gpu}] phase 15 (a) {name} {tuple(x.shape)}: channel 0 vs float64 "
            f"svd_denoise_ref SSIM {q:.6f}, use_optimal {q_opt:.6f} (gates "
            f">= {GATE_SVD_SSIM}); deflate_top1 vs denoise_signal {defl:.3g} of max |x|"
            f"{'' if name == 'K1 spectrograms' else ' (not a log spectrogram: not gated)'}; "
            f"Gavish-Donoho counts "
            f"{count.tolist()}")
        check(q >= GATE_SVD_SSIM and q_opt >= GATE_SVD_SSIM,
              f"phase 15 (a) {name}: denoise SSIM {q:.6f}, use_optimal {q_opt:.6f}")
        if name == "K1 spectrograms":  # log spectrograms: sigma_0 dominates
            check(defl <= TOL_DEFLATE, f"phase 15 (a): deflate_top1 off by {defl:.3g}")
        del outs
        real = name == "K1 spectrograms"  # the split and the library calls: on this input
        for k, f in fns.items():
            ms = time_cuda(f, x, warmup=2, iters=10)
            split = ""
            if real:
                sp_ = linalg_split(lambda: f(x))
                split = ("; device split not measured (no profiler device time)"
                         if sp_["kernels"] is None else
                         "; device ms: eigh/eigvalsh {eigh:.4f}, QR {qr:.4f}, matmul "
                         "{matmul:.4f}, other {other:.4f}, all kernels {kernels:.4f}; longest "
                         .format(**sp_) + ", ".join(f"{nm[:48]} {t:.4f}" for nm, t in sp_["top"])
                         + "; longest other " + ", ".join(f"{nm[:48]} {t:.4f}"
                                                          for nm, t in sp_["top_other"]))
            log(f"[{gpu}]   {k}: {ms:.4f} ms a call, {ms / N_CHANNELS:.4f} ms a spectrogram "
                f"({N_CHANNELS / ms * 1e3:.1f} specs/s){split}")
        if not real:
            continue
        # the library calls inside, at their shapes, beside their bounds, from
        # the textbook operation counts (Golub & Van Loan, Matrix Computations:
        # Householder QR with Q formed 4 n k^2 - 4 k^3 / 3, the symmetric QR
        # algorithm 9 m^3 with vectors and 4 m^3 / 3 without, the R-SVD
        # 4 n m^2 + 22 m^3; m <= n)
        m, n, b = x.shape[-2], x.shape[-1], x.shape[0]
        g = x @ x.mT
        basis = torch.randn(b, m, SVD.K_MAX, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(SEED))
        y = torch.linalg.qr(x.mT @ basis).Q
        calls = (("torch.linalg.eigh", torch.linalg.eigh, g, 9 * m**3, (g, g[..., 0])),
                 ("torch.linalg.eigvalsh", torch.linalg.eigvalsh, g, 4 / 3 * m**3, (g[..., 0],)),
                 ("torch.linalg.qr (n x 64)", torch.linalg.qr, y,
                  4 * n * 64**2 - 4 / 3 * 64**3, (y, y[..., :64, :])),
                 ("torch.linalg.qr (m x 64)", torch.linalg.qr, y[:, :m],
                  4 * m * 64**2 - 4 / 3 * 64**3, (y[:, :m], y[..., :64, :])),
                 ("torch.linalg.svd(full_matrices=False)",
                  lambda a: torch.linalg.svd(a, full_matrices=False), x, 4 * n * m**2 + 22 * m**3,
                  (x, x[..., :m], x[..., 0])))
        for i, (k, f, a, flops, outs) in enumerate(calls):
            last = i == len(calls) - 1  # the SVD: ~0.15 s a call
            ms = time_cuda(f, a, warmup=1 if last else 2, iters=3 if last else 10)
            b_ms, b_by = bound(b * flops, nbytes(a, *outs), torch.float32)
            log(f"[{gpu}]   {k} of the batch {tuple(a.shape)}: {ms:.4f} ms ({ms / b:.4f} ms a "
                f"matrix); bound {b_ms:.4f} ms ({b_by}; {b * flops / 1e9:.3f} GFLOP, "
                f"{PEAK[torch.float32][1]}), {ms / b_ms:.0f}x")
        del g, y
    xg = gate_matrix(11)
    cs = SVD.compute_signal(torch.from_numpy(xg).float().to(dev)[None])[0]
    q = ssim(cs.cpu().numpy(), svd_compute_signal_ref(xg))
    log(f"[{gpu}] phase 15 (a) compute_signal on the gate matrix (sigma_k = 100 x 0.93^k) vs "
        f"float64 svd_compute_signal_ref: SSIM {q:.6f} (gate >= {GATE_SVD_SSIM})")
    check(q >= GATE_SVD_SSIM, f"phase 15 (a): compute_signal SSIM {q:.6f}")


def crosspower_phase(dev, gpu) -> None:
    """Phase 15 (b): ``ae_co2`` on two 2 s chords at 1.667 MHz with one
    coherent line and independent noise (tests/test_crosspower.py's
    construction), nperseg 1024."""
    n = int(2.0 * CP_FS)
    t = np.arange(n) / CP_FS
    rng = np.random.default_rng(SEED)
    mode = np.sin(2 * np.pi * CP_LINE * t)
    x1 = torch.from_numpy((mode + rng.standard_normal(n)).astype(np.float32)).to(dev)
    x2 = torch.from_numpy((0.7 * mode + rng.standard_normal(n)).astype(np.float32)).to(dev)
    ampsp, freq, time_ms = CP.ae_co2(x1, x2, t)
    check(tuple(ampsp.shape) == (len(time_ms), 513) and bool((ampsp > 0).all())
          and bool(torch.isfinite(ampsp.log()).all()), f"phase 15 (b): ampsp {tuple(ampsp.shape)}")
    by_freq = ampsp.mean(dim=0)
    peak, floor = int(by_freq.argmax()), float(by_freq.median())
    want = int(round(CP_LINE / (CP_FS / 1024)))
    check(abs(peak - want) <= 1 and float(by_freq[peak]) > 20 * floor,
          f"phase 15 (b): peak bin {peak} (line at {want}), {float(by_freq[peak]) / floor:.1f}x "
          f"the floor")
    dt = float(np.median(np.diff(t)))
    sp = SpecParams(nperseg=1024, noverlap=512, fs=1.0 / dt, cut_shot=n * dt)
    x = x1[: sp.n_samples]
    self_cross, psd = CP.cross_power(x, x, sp).mT, stft_psd(x, sp)
    # |diff| over its allowance 1e-12 + rtol |psd| (tests/test_crosspower.py)
    worst = float(((self_cross - psd).abs() / (1e-12 + TOL_SELF_CROSS * psd.abs())).max())
    check(worst <= 1.0, f"phase 15 (b): self-cross vs PSD at {worst:.3g}x its allowance")
    ms = time_cuda(CP.cross_power, x1, x2, sp, warmup=2, iters=10)
    ms_psd = time_cuda(stft_psd, x1, sp, warmup=2, iters=10)
    t0 = time.perf_counter()
    for _ in range(5):
        CP.ae_co2(x1, x2, t)
    torch.cuda.synchronize()
    ms_co2 = (time.perf_counter() - t0) / 5 * 1e3
    log(f"[{gpu}] phase 15 (b) cross power, 2 x {n} samples at {CP_FS:g} Hz, nperseg 1024 -> "
        f"{tuple(ampsp.shape)}: line at bin {peak} (want {want}), {float(by_freq[peak]) / floor:.1f}x "
        f"the median; self-cross vs float64 PSD at {worst:.3g}x its allowance 1e-12 + "
        f"{TOL_SELF_CROSS} |psd|; "
        f"cross_power {ms:.4f} ms (CUDA events; float64 stft_psd of one chord {ms_psd:.4f} ms); "
        f"ae_co2 with its host axes {ms_co2:.3f} ms (host clock)")


def train_raw_phase(dev, gpu) -> None:
    """Phase 15 (c): the CLI's raw-to-model path in process (see the
    docstring), counted."""
    from specenh_torch import cli

    n_train = int(RAW_SHOTS * N_CHANNELS * 30 * TrainConfig().split_fracs[0])
    with tempfile.TemporaryDirectory() as d:
        raw, bins = os.path.join(d, "raw"), os.path.join(d, "bin")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["synth-shots", "--out", raw, "--shots", str(RAW_SHOTS), "--channels",
                      str(N_CHANNELS)])
            cli.main(["convert-bin", "--data-dir", raw, "--out-dir", bins, "--channels",
                      str(N_CHANNELS)])
        check(len(os.listdir(bins)) == RAW_SHOTS, f"phase 15 (c): {os.listdir(bins)}")
        log(f"[{gpu}] phase 15 (c) synth-shots + convert-bin: {RAW_SHOTS} shots x {N_CHANNELS} "
            f"channels x 1e6 samples in {time.perf_counter() - t0:.1f} s (host)")
        for model, epochs, depth in (("scan_k3", 2, 2), ("deep3", 1, 3)):
            out, buf = os.path.join(d, model), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                _, tl = counted(cli.main, [
                    "train-raw", "--binary", "--data-dir", bins, "--out-dir", out,
                    "--channels", str(N_CHANNELS), "--engine", "kernel", "--model", model,
                    "--epochs", str(epochs)])
            wall = time.perf_counter() - t0
            text = buf.getvalue()
            final = json.loads(text.strip().splitlines()[-1])
            vals = [float(v) for v in re.findall(r"val_loss=([0-9.eE+-]+)", text)]
            check(final["channels"] == RAW_SHOTS * N_CHANNELS and len(vals) == epochs
                  and np.isfinite(final["val_loss"]) and abs(vals[-1] - final["val_loss"]) < 1e-5,
                  f"phase 15 (c) {model}: {final}, val_loss per epoch {vals}")
            if epochs > 1:
                check(vals[-1] < vals[0], f"phase 15 (c) {model}: val_loss {vals} did not fall")
            steps = epochs * -(-n_train // BATCH)
            check(tl.pop(SF.STFT_KERNEL, 0) == 1, "phase 15 (c): K1 not launched once")
            check(tl.get(TK.TRAIN_LOSS, 0) == steps and tl.get(TK.TRAIN_SUM, 0) == steps,
                  f"phase 15 (c) {model}: {tl.get(TK.TRAIN_LOSS, 0)} kernel steps, want {steps}")
            want = set(TK.TRAIN_KERNELS if depth == 2 else TRAIN3_KERNELS) - set(K5B_KERNELS)
            check(set(tl) == want | {AK.CONVT},
                  f"phase 15 (c) {model}: launched {sorted(k.symbol for k in tl)}")
            check(os.path.isfile(os.path.join(out, "model", "params.pt")),
                  f"phase 15 (c) {model}: no model/")
            row(SF.STFT_KERNEL, "K1")["launches"] += 1
            add_sweep_launches(tl, depth, serving=False, phase="15 (c)")
            epoch_lines = [ln for ln in text.splitlines() if ln.startswith("epoch ")]
            log(f"[{gpu}] phase 15 (c) train-raw --binary --engine kernel --model {model} "
                f"--epochs {epochs}: {wall:.1f} s (host clock: reading {RAW_SHOTS} binaries, K1 and the "
                f"label pipeline on {RAW_SHOTS * N_CHANNELS} channels, {steps} kernel steps, validation, "
                f"model/); "
                + "; ".join(epoch_lines) + "; launches K1=1, " + ", ".join(
                    f"{k.symbol}={v}" for k, v in tl.items()))


def analyses_phase(dev, gpu) -> None:
    """Phase 15: the SVD denoiser, the cross power and train-raw."""
    t0 = time.perf_counter()
    svd_phase(dev, SpecParams(), gpu)
    crosspower_phase(dev, gpu)
    train_raw_phase(dev, gpu)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")

    secs = _build.build_all()
    log("built " + ", ".join(f"{n}.cu in {s:.1f} s" for n, s in secs.items())
        + f" (nvcc, sm_90a) into {_build.BUILD_DIR}")
    rows = ptxas_summary()
    listing = _build.BUILD_DIR / "ptxas.txt"
    listing.write_text("".join(f"{lib} {name}: {regs} registers, {spill} B spill stores\n"
                               for lib, name, regs, spill in rows))
    for lib in secs:
        mine = [r for r in rows if r[0] == lib]
        log(f"  ptxas {lib}.cu: {len(mine)} kernels, at most {max(r[2] for r in mine)} "
            f"registers, {sum(r[3] for r in mine)} B spill stores in all (each kernel: "
            f"{listing})")
    for lib, name, regs, spill in rows:
        m = re.search(r"conv_igemm_kernelILi(\d+)E.*?(Ig\w+?Src).*?(Ig\w+?Epi)(ILi(\d)E)?", name)
        if m:
            gate = f"<{m.group(5)}>" if m.group(5) else ""
            log(f"  ptxas {lib}.cu conv_igemm_kernel<NF={m.group(1)}, {m.group(2)}, "
                f"{m.group(3)}{gate}>: {regs} registers, {spill} B spill stores")
        m = re.search(r"convt_igemm_kernelILi(\d)E", name)
        if m:
            log(f"  ptxas {lib}.cu convt_igemm_kernel<K={m.group(1)}>: {regs} registers, "
                f"{spill} B spill stores")
        m = re.search(r"conv_out_mma_kernelILi(\d)ELi(\d)E.*?(Co\w+?Epi)(IfE)?", name)
        if m:
            ty = "" if m.group(3) != "CoLossEpi" else "<float>" if m.group(4) else "<bf16>"
            log(f"  ptxas {lib}.cu conv_out_mma_kernel<K={m.group(1)}, ROWS={m.group(2)}, "
                f"{m.group(3)}{ty}>: {regs} registers, {spill} B spill stores")
        m = re.search(r"conv_in_mma_kernelILi(\d)ELi(\d)E.*?(Ci\w+?Src).*?(Ci\w+?Epi)", name)
        if m:
            log(f"  ptxas {lib}.cu conv_in_mma_kernel<K={m.group(1)}, NF={m.group(2)}, "
                f"{m.group(3)}, {m.group(4)}>: {regs} registers, {spill} B spill stores")

    sp = SpecParams()
    traces = torch.from_numpy(example_shot(sp, N_CHANNELS, SEED)).to(dev)
    err_k1 = check_stft(sp, traces)
    specs = SF.spectrogram_fused(traces, sp)
    run, model = serve_family(
        dev, sp, gpu, FLAGSHIP, specs, (torch.bfloat16,),
        (("flagship k3", N_CHANNELS, FLAGSHIP),
         ("k7", 1, ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7))),
         ("manual (64,32)/k5", 1, ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)),
                                              out_kernel=(5, 5)))))
    check_tile_in_out(dev, sp, traces, specs)
    row(SF.STFT_KERNEL, "K1").update(launches=run["launches"][SF.STFT_KERNEL],
                                     max_abs_err=err_k1, **time_stft(sp, gpu, traces))
    fused_front(dev, sp, gpu, traces, model, run)
    del run
    serve_family(
        dev, sp, gpu, DEEP3, specs, (torch.bfloat16, torch.float32),
        (("deep3 (16,32,64)/k5", N_CHANNELS, DEEP3),
         ("(64,32,64)/k7", 1, ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3,
                                          out_kernel=(7, 7)))))
    serve_module_route(dev, sp, gpu)
    del traces, specs

    k1_build = dataset_build(dev, sp, gpu)
    data, k1_data = make_data(dev, sp)
    row(SF.STFT_KERNEL, "K1")["launches"] += k1_build + k1_data
    train_family(dev, gpu, FLAGSHIP, data,
                 (("k5", ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5))),
                  ("k7", ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7))),
                  ("manual (64,32)/k5", ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)),
                                                    out_kernel=(5, 5)))),
                 EPOCHS, TK.kernel_value_and_grad, TK.build_train_weights)
    train_family(dev, gpu, DEEP3, data,
                 (("(64,32,64)/k7", ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3,
                                                out_kernel=(7, 7))),
                  ("(48,48,64)/k3", ModelConfig(filters=(48, 48, 64), kernels=((3, 3),) * 3,
                                                out_kernel=(3, 3)))),
                 EPOCHS3, TK3.kernel_value_and_grad3, TK3.build_train3_weights)
    sweep_phase(dev, gpu, data)
    del data
    analyses_phase(dev, gpu)

    out = []
    for (kern, kid), r in ROWS.items():
        check(set(r) == set(ROW_KEYS), f"{kern.symbol} ({kid}): row keys {sorted(r)}")
        check(r["launches"] > 0, f"{kern.symbol} ({kid}) was not launched on its path")
        out.append({"name": kern.symbol, "route": "cuda",
                    "source": f"specenh_torch/csrc/{kern.source}.cu",
                    "replaces": TPU_KERNELS[kid], **{k: r[k] for k in ROW_KEYS}})
    for kern in _build.KERNELS:
        check(any(k is kern for k, _ in ROWS), f"{kern.symbol} has no row")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
