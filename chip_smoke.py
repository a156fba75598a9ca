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
   on every channel (``ssim_card``: the host's ``ssim`` on the card in
   float64, within TOL_SSIM_CARD of it on the worst channel); every
   kernel must have launched during it, every S1 launch on
   ``conv_in_mma_kernel``, every S2 launch on ``conv_igemm_kernel``,
   every S3 launch on ``convt_igemm_kernel`` and every S4 launch on
   ``conv_out_mma_kernel``;
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
16. (run after phase 15, in its work directory) the watch-directory
   service ``serve.serve_once`` over 8 SPEC binaries of 20 x 1e6 samples
   (phase 15 (c)'s 4 and 4 more) and a truncated one, into in-memory
   sinks (the card has no h5py): phase 15 (c)'s scan_k3 model with 1 and
   2 writer threads, its deep3 model on 2 shots, then a second drain of
   the same directory; gated: 8 done and 1 quarantined, then nothing to
   do; every persisted channel bit for bit ``service.fn`` called directly
   on the same traces; one ``shot_enhanced`` event per shot and one
   ``serve_batch``; per shot K1, ``ae_tile_in`` and ``ae_tile_out`` once,
   ``ae_conv_pool`` depth - 1 times and ``ae_convt_relu`` depth times,
   none on ``conv_quad_kernel``; printed: shots/s, latency and read
   time, the bare service's ms/shot (traces on the card, from the host,
   and with the outputs copied back), the device's busy share of a
   profiled drain, peak memory and the warm start.  The kernels line
   counts these launches.
17. (run after phase 14) out-of-core training (``train_stream``) on phase
   7's tiles, laid out as 400 records of (256, 3840) in an in-memory store
   (``MemoryStore``; the card has no h5py), split 7200/3000/1800, chunks
   of 2048: the flagship on K5 resident and streamed (``cache`` "never"
   and "auto", bf16 chunks, the f32 and bf16 tile caches on disk, a
   resume), deep3 on K7 from f32 and bf16 chunks, the kernel grid through
   ``sweep_fit_serial_streamed`` with a tile cache; gated on the training
   losses and parameters bit for bit (val_loss, the float32 module on
   cuDNN, within TOL_F32_REL): (a) shuffle off and one chunk, streamed ==
   resident ``fit``; (b) "auto" == the f32 tile cache; (c) bf16 chunks ==
   f32 chunks, on K5 and K7; (d) 2 epochs and a resumed third == 3
   epochs; (e) the streamed sweep == ``sweep_fit_serial`` per config,
   configs 2-3 reading nothing from the store; (f) only K5 (K7) entry
   points launched, ``ae_train_loss`` once a step; printed: s/epoch
   (epoch 1 apart), the upload rates pinned and pageable and the cost of
   pinning, the card's busy share of a profiled streamed epoch, the
   synchronizing calls of an epoch, peak device memory, host RSS.  The
   tile caches are deleted.  The kernels line counts these launches.
18. (run after phase 17) data-parallel training (``parallel.dp_fit`` with
   ``dp_kernel_epoch_for``) and the Keras import: (a) Keras-layout weight
   lists drawn with numpy for the flagship and deep3, converted by
   ``models.keras_import``, served on three shots through the bf16
   service with both gates; (b) an NCCL world of one on phase 7's tiles,
   the flagship on K5 (2 epochs) and deep3 on K7 (1 epoch), each ``fit``
   with ``kernel_epoch_for`` bit for bit in training losses and
   parameters, counted; (c) two ranks on the one card over gloo, started
   with ``torch.multiprocessing`` (the tiles shared through CUDA IPC), K5
   on each rank's half of every batch, the last batch's second half all
   padding: parameters equal on both ranks, every step finite, epoch
   losses within TOL_DP_GLOO of (b); (d) s/epoch of (b) against ``fit``,
   of (c), and the all-reduce's ms (NCCL world of one, gloo pair); (e)
   ``train --devices N --engine kernel`` with N above the visible GPUs
   exits with the device-count message.  The kernels line counts (a)-(c)'s
   launches.
19. (run after phase 16) serving over a process-group mesh and the
   time-sharded long shot (``parallel.timeshard``): (a) JAX's headline
   4 s shot (1 998 848 samples, 61 tiles) on an NCCL world of one
   ``("time",)`` mesh, the flagship in bf16 and float32 and deep3 in
   bf16, as (T,) and (20, T): the spectrogram within 5e-5 of
   ``ops.stft.spectrogram`` (its last column a copy), the labels within
   1e-5 of ``classical_pipeline`` of it, the enhanced output bit for bit
   the kernels on it and at SSIM >= 0.999 against the plain float32
   module, one launch of each stage; ms a (T,) shot beside the unsharded
   service plus the labels; (c) ``EnhanceService(mesh=)`` on an NCCL
   world of one bit for bit the service at both depths; (b) two gloo
   ranks on the one card, spawned once: the shot split two ways against
   the world of one, the channel-sharded services within 1e-6 of the
   single one, ``serve_once`` over 4 SPEC binaries on rank 0 while rank 1
   follows.  The kernels line counts (a)-(c)'s launches.
20. (run after phase 18, phase 7's tiles still on the card) multi-GPU
   streamed, sweep and raw-to-model training: (a) on an NCCL world of one,
   each against the unsharded call from the same weights, the training
   losses and parameters bit for bit (val_loss within TOL_F32_REL):
   ``fit_streaming(mesh=)`` on K5 over phase 17's records (``TileStore``,
   read off the card), chunks of 2048, 2 epochs; ``sweep_fit_serial
   (mesh=)`` of the kernel grid, 1 epoch; ``sweep_fit`` of that grid on a
   "sweep" world of one (float32, cuDNN deterministic, 1024 tiles, every
   history bit for bit); ``train_from_raw(mesh=)`` of phase 15 (c)'s 4
   shots on K1 and K5, 2 epochs; s/epoch of each side; (b) one spawn of
   two gloo ranks sharing the card (started before (a), released after
   it, warmed up meanwhile): one streamed epoch within rtol 1e-5 of (a)'s
   first (each parameter tensor within TOL_MESH_PARAMS of its norm), the
   same epoch on the float32 kernels against a float32 world of one's
   (reported), both bit for bit the epoch with each batch's two blocks
   summed on one card, the
   grid padded to 4 within rtol 1e-4 of the unsharded envelope (rank 1
   returns None), ``train_from_raw`` over the two ranks within
   TOL_DP_GLOO, the all-gather's bytes and the peak memory; (c)
   ``train-raw`` and ``sweep --devices N`` above the visible GPUs exit
   with the device-count message.  The kernels line counts (a) and (b)'s
   launches.

21. (run after phase 19) the headline: ``python -m specenh_torch.cli
   bench`` in process (``bench.headline``: the flagship bf16 service's
   spectrograms/s behind its two gates, the training engines' s/epoch, the
   SVD's specs/s behind its two gates, deep3's and the 4 s long shot's ms,
   the streamed read from an in-memory store: the card has no h5py):
   one JSON line with the JAX headline's 17 keys in its order, each number
   finite and > 0, the four gates passed, ``vs_baseline`` from the cached
   CPU baseline; each measure's launches counted (K1, the serving stages,
   every K5 and K7 entry point); the line is printed after ``headline:``.
   The kernels line counts these launches.

Prints a JSON line of the kernels, one row per pair of CUDA entry point and
TPU kernel it replaces, the card's name and power limit, then as its last
line ``{"ok": true, "device": {...}}``.  Weights are glorot-initialised
from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from specenh_torch import ModelConfig, SpecParams, TrainConfig, _build
from specenh_torch.bench import headline as HL
from specenh_torch.bench.harness import (enhance_shot_plain, example_shot,
                                         make_enhance_shot_fn, time_cuda)
from specenh_torch.bench.reference import (HAS_CV2, pipeline_ref, spectrogram_ref, ssim,
                                           svd_compute_signal_ref, svd_denoise_ref)
from specenh_torch.config import MODEL_PRESETS, Config, PatchSpec, SweepConfig
from specenh_torch.data.dataset import split_tiles, synthetic_shot_batch
from specenh_torch.data.tiles import patch, unpatch
from specenh_torch.io.binfmt import write_shot_bin
from specenh_torch.io.memstore import MemoryStore, TileStore
from specenh_torch.io.store import StoreWriterPool
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
from specenh_torch.bench import probe_split as PS
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
EPOCHS_DP = 2        # phase 18, the flagship's data-parallel runs
N_CUT, N_CUT_TUNE = 1024, 512  # phase 14 (c), (d): the envelope's and the mixed grid's cut
STREAM_CHUNK = 2048  # phase 17: tiles a streamed chunk
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
TOL_SSIM_CARD = 1e-8  # the gates' SSIM on the card vs the host's ssim, same channel
TOL_DP_GLOO = 1e-4   # phase 18 (c): two ranks' epoch losses vs the world of one, relative
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
SERVE_SHOTS = 8     # phase 16: phase 15 (c)'s 4 binaries and 4 more
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


@functools.lru_cache(maxsize=None)
def shot(sp, n_channels: int, seed: int) -> np.ndarray:
    """``example_shot``, drawn once a run (the phases serve the same three
    shots; host numpy, read only by the callers)."""
    return example_shot(sp, n_channels, seed)


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


def ssim_card(a: torch.Tensor, b: torch.Tensor, win_size: int = 7, k1: float = 0.01,
              k2: float = 0.03) -> torch.Tensor:
    """``utils.metrics.ssim`` (data range 1) of each (H, W) pair of (C, H, W)
    ``a`` and ``b`` on the card, in float64: the same uniform window by
    cumulative sums, ddof-1 moments and constants; one value a channel.
    ``gated_run`` holds it against the host's ``ssim`` on the worst
    channel (TOL_SSIM_CARD)."""
    a, b, w = a.to(torch.float64), b.to(torch.float64), win_size

    def mean_filter(x):
        p = F.pad(x.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
        return (p[..., w:, w:] - p[..., :-w, w:] - p[..., w:, :-w] + p[..., :-w, :-w]) / (w * w)

    c1, c2, cov_norm = k1 ** 2, k2 ** 2, w * w / (w * w - 1)
    mu_a, mu_b = mean_filter(a), mean_filter(b)
    var_a = cov_norm * (mean_filter(a * a) - mu_a * mu_a)
    var_b = cov_norm * (mean_filter(b * b) - mu_b * mu_b)
    cov = cov_norm * (mean_filter(a * b) - mu_a * mu_b)
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return (num / den).mean(dim=(-2, -1))


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
        e_all = ssim_card(enh, torch.from_numpy(e_ref).to(enh.device)).cpu()
        worst = int(e_all.argmin())
        e_ssim = float(e_all[worst])
        e_host = ssim(enh[worst].cpu().numpy(), e_ref[worst])
        check(abs(e_host - e_ssim) <= TOL_SSIM_CARD,
              f"{tag}: SSIM on the card {e_ssim!r} vs the host's {e_host!r}, channel {worst}")
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
    shots = [shot(sp, n_channels, seed) for seed in (0, 1, 2)]
    traces = [torch.from_numpy(s).to(dev) for s in shots]
    refs = [(spectrogram_ref(host[0], sp)[0], enhance_shot_plain(model, t, sp)[1].cpu().numpy())
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
    shots = [shot(sp, N_CHANNELS, seed) for seed in (0, 1, 2)]
    traces = [torch.from_numpy(s_).to(dev) for s_ in shots]
    refs = [(spectrogram_ref(host[0], sp)[0], enhance_shot_plain(model, t, sp)[1].cpu().numpy())
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
    OK, then their times and their blocks, and for each probe and its
    library call the split of ``bench/probe_split.py``: (a) the event
    median of single calls, (b) the device time, (c) the rate in a burst.
    Returns the launches and the times."""
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
    entries = {}
    for kern, (name, (fn, plain, shape)) in zip(PROBE_KERNELS, PW.PROBES.items()):
        x = xs[name]
        entries[kern] = (lambda f=fn, x=x: f(x), lambda p=plain, x=x: p(x),
                         lambda lf=PS.LIBRARY[name], x=x: lf(x), 0.0,
                         nbytes(x) + nbytes(plain(x)))
        gx, gy = PW.grid(name, shape)
        log(f"K11 {kern.symbol}: {gx * gy} blocks ({gx} x {gy})")
    times = time_entries(gpu, entries, torch.float32, " (launch-bound)")
    for name, r in PS.split(PS.probe_functions(torch.device("cuda"), SEED)).items():
        log(f"[{gpu}] K11 split, {name}: (a) {r['a_ms']:.4f} ms a call (turns "
            f"{min(r['a_turns']):.4f}-{max(r['a_turns']):.4f}), (b) {r['b_ms']:.4f} "
            f"device ms a call, (c) {r['c_ms']:.4f} ms a call in a burst of {PS.BURST} "
            f"(host {r['host_ms']:.4f} ms a call)")
    return launches, times


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
    host = shot(sp, N_CHANNELS, SEED)
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
            x = host if seed == SEED else shot(sp, N_CHANNELS, seed)
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


def recipe_shots(sp) -> np.ndarray:
    """Phase 7's raw campaign: N_SHOTS synthetic shots of N_CHANNELS."""
    return synthetic_shot_batch(N_SHOTS, N_CHANNELS, sp.n_samples, sp.fs, seed=SEED)


def make_data(dev, sp, shots):
    """Phase 7: the recipe's tiles on the card (hyperparam_scan.py:126-149):
    the synthetic shots ``shots`` (``recipe_shots``) through the dataset
    build's ``process_shot_fn`` (K1, then the classical label pipeline),
    specs and labels patched, split 60/25/15.  Returns the split and K1's
    launches."""
    t0 = time.perf_counter()
    fn = process_shot_fn(Config(spec=sp), dev)
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


def host_rss() -> str:
    """This process's resident host memory and its peak (getrusage)."""
    import resource

    with open("/proc/self/status") as fh:
        st = dict(ln.split(":", 1) for ln in fh if ":" in ln)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    return f"host RSS {st.get('VmRSS', 'not reported').strip()}, peak {peak:.2f} GiB"


def same_state(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a.model.state_dict().values(),
                                                  b.model.state_dict().values()))


def host_syncs(fn, *args, **kw) -> int:
    """The synchronizing CUDA calls ``torch.cuda.set_sync_debug_mode("warn")``
    reports while ``fn`` runs."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def upload_rates(gpu, host: np.ndarray) -> None:
    """Phase 17: one chunk's x (host float32) to the card from pageable
    and from pinned memory (CUDA events); and on the host, what keeping a
    chunk pinned would cost (page-locking a new chunk with
    ``cudaHostRegister``) against what the staging copy costs (a copy into
    a buffer pinned once)."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    gb = src.nbytes / 1e9
    dst = torch.empty(src.shape, device="cuda")
    pinned = torch.empty(src.shape, pin_memory=True)
    fills = []
    for _ in range(3):
        t0 = time.perf_counter()
        pinned.copy_(src)
        fills.append(time.perf_counter() - t0)
    t_fill = float(np.median(fills))
    fresh = np.array(host)  # a new chunk, its pages touched
    cudart = torch.cuda.cudart()
    t0 = time.perf_counter()
    err = cudart.cudaHostRegister(fresh.ctypes.data, fresh.nbytes, 0)
    t_reg = time.perf_counter() - t0
    check(int(err) == 0, f"cudaHostRegister: error {err}")
    t0 = time.perf_counter()
    cudart.cudaHostUnregister(fresh.ctypes.data)
    t_unreg = time.perf_counter() - t0
    ms_pinned = time_cuda(lambda: dst.copy_(pinned, non_blocking=True), warmup=1, iters=5)
    ms_page = time_cuda(lambda: dst.copy_(src), warmup=1, iters=3)
    log(f"[{gpu}] phase 17 upload of one chunk's x ({gb:.3f} GB): pinned {ms_pinned:.3f} ms "
        f"({gb / ms_pinned * 1e3:.2f} GB/s), pageable {ms_page:.3f} ms ({gb / ms_page * 1e3:.2f} "
        f"GB/s) (CUDA events); host side: the staging copy into a buffer pinned once "
        f"{t_fill * 1e3:.1f} ms ({gb / t_fill:.2f} GB/s), page-locking a new chunk "
        f"(cudaHostRegister) {t_reg * 1e3:.1f} ms ({gb / t_reg:.2f} GB/s) and unlocking it "
        f"{t_unreg * 1e3:.1f} ms")
    del pinned, dst


def stream_phase(dev, gpu, data) -> None:
    """Phase 17: out-of-core training (``train_stream.fit_streaming``) on
    phase 7's tiles, laid out as 400 records of (256, 3840) in an
    in-memory store, chunks of STREAM_CHUNK tiles: the flagship on K5
    resident, streamed from the store with ``cache`` "never" and "auto",
    with bf16 chunks, from the f32 and the bf16 tile caches, and resumed;
    deep3 on K7 from f32 and bf16 chunks; the kernel grid through
    ``sweep_fit_serial_streamed`` (tile cache) against ``sweep_fit_serial``.
    Gates, each fatal, on the training losses and the parameters bit for
    bit (val_loss, from the float32 module on cuDNN, within TOL_F32_REL):
    (a) shuffle off and one chunk: the streamed fit is the resident fit;
    (b) the "auto" run is the f32 tile-cache run; (c) bf16 chunks train as
    the f32 chunks, on K5 and K7; (d) 2 epochs and a resumed third are 3
    epochs; (e) the streamed sweep is the resident one per config,
    configs 2-3 reading nothing from the store; (f) every launch is a K5
    (K7) entry point, ``ae_train_loss`` once a step.
    Printed: s/epoch (epoch 1 apart), the upload rates, the card's busy
    share of a profiled streamed epoch, host syncs an epoch, peak device
    memory, host RSS."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from specenh_torch import train_stream as TS

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="stream-")
    shuffled, ordered = TrainConfig(), TrainConfig(shuffle=False)
    store = MemoryStore(*(unpatch(torch.cat(t)).cpu().numpy() for t in
                          ((data.x_train, data.x_tune, data.x_test),
                           (data.y_train, data.y_tune, data.y_test))), N_CHANNELS)
    plan = TS.plan_stream_split(store, num_samples=N_SHOTS, cfg=shuffled, seed=SEED)
    n, nv = plan.n_tiles("train"), plan.n_tiles("tune")
    check((n, nv, plan.n_tiles("test")) == (7200, 3000, 1800),
          f"phase 17 plan {n}, {nv}, {plan.n_tiles('test')}")
    resident = [a for split in ("train", "tune")
                for a in TS._read_chunk(store, getattr(plan, split), PatchSpec())]
    nb = -(-n // BATCH)
    log(f"phase 17: {len(store.x)} records of {store.x.shape[1:]} in host memory ("
        f"{(store.x.nbytes + store.y.nbytes) / 1e9:.2f} GB), plan 7200/3000/1800 tiles "
        f"(shots sampled with seed {SEED}), chunks of {STREAM_CHUNK}; {host_rss()}")

    def run(tag, cfg, epochs, tc=shuffled, streamed=True, **kw):
        """One counted run from the seed's weights: (state, history)."""
        depth = cfg.depth
        state = TR.create_state(cfg, tc, generator=torch.Generator().manual_seed(SEED),
                                device=dev)
        mpath = os.path.join(work, f"{tag}.jsonl")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reads = store.reads
        epoch_fn = TR.kernel_epoch_for(cfg, tc)
        if streamed:
            kw.setdefault("chunk_tiles", STREAM_CHUNK)
            (st, hist), tl = counted(TS.fit_streaming, state, store, plan, tc, epochs=epochs,
                                     epoch_fn=epoch_fn, metrics_path=mpath, **kw)
        else:
            (st, hist), tl = counted(TR.fit, state, *resident, cfg=tc, epochs=epochs,
                                     epoch_fn=epoch_fn, metrics_path=mpath, **kw)
        peak = torch.cuda.max_memory_allocated(dev) - base
        with open(mpath) as fh:
            secs = [json.loads(ln)["sec"] for ln in fh]
        want = (set(TK.TRAIN_KERNELS if depth == 2 else TRAIN3_KERNELS) - set(K5B_KERNELS)
                | {AK.CONVT})
        steps = hist["new_epochs"] * nb
        check(set(tl) == want and tl[TK.TRAIN_LOSS] == steps and tl[TK.TRAIN_SUM] == steps,
              f"phase 17 {tag}: launches {[(k.symbol, v) for k, v in tl.items()]} for {steps} "
              "steps")  # gate (f)
        add_sweep_launches(tl, depth, serving=False, phase="17")
        later = f", later epochs {np.mean(secs[1:]):.4f} s ({secs[1:]})" if len(secs) > 1 else ""
        log(f"[{gpu}] phase 17 {tag}: epoch 1 {secs[0]:.4f} s{later}; {tl[TK.TRAIN_LOSS]} "
            f"steps; store reads {store.reads - reads}; peak device memory "
            f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held; {host_rss()}; loss "
            f"{hist['loss']}, val_loss {hist['val_loss']}")
        return st, hist

    def same(a, b, tag, val=True):
        """A gate: the training losses and the parameters bit for bit; with
        ``val``, val_loss within TOL_F32_REL (the validation pass is the
        float32 module on cuDNN, whose algorithm may differ between runs)."""
        gap = max(abs(u - v) / v for u, v in zip(a[1]["val_loss"], b[1]["val_loss"]))
        check(a[1]["loss"] == b[1]["loss"] and same_state(a[0], b[0])
              and (not val or gap <= TOL_F32_REL), f"phase 17 gate {tag}: {a[1]} vs {b[1]}")
        log(f"  gate {tag}: losses and parameters bit for bit; val_loss "
            + (f"bit for bit: {a[1]['val_loss'] == b[1]['val_loss']} (gap {gap:.3g})" if val
               else f"not compared (bf16-rounded tune tiles; gap {gap:.3g})"))

    # (a) the identity contract
    same(run("resident fit (shuffle off)", FLAGSHIP, 2, tc=ordered, streamed=False),
         run("streamed, one chunk (shuffle off)", FLAGSHIP, 2, tc=ordered, chunk_tiles=8192),
         "(a) streamed == resident")
    run("cache never", FLAGSHIP, 1, cache="never")
    auto = run("cache auto", FLAGSHIP, 3)
    bf16 = run("cache auto, bf16 chunks", FLAGSHIP, 3, cache_dtype="bf16")
    same(bf16, auto, "(c) bf16 chunks == f32 chunks, K5", val=False)
    tc32, tc16 = os.path.join(work, "tc32"), os.path.join(work, "tc16")
    same(run("f32 tile cache (built)", FLAGSHIP, 3, tile_cache=tc32), auto,
         "(b) auto == f32 tile cache")
    same(run("bf16 tile cache (built)", FLAGSHIP, 3, tile_cache=tc16, cache_dtype="bf16"), bf16,
         "(b) bf16 chunks == bf16 tile cache")
    ck = os.path.join(work, "ck")
    run("2 epochs, checkpointed", FLAGSHIP, 2, checkpoint_dir=ck)
    same(run("resumed to 3", FLAGSHIP, 3, checkpoint_dir=ck, resume=True), auto,
         "(d) 2 + resumed 1 == 3 epochs")
    same(run("deep3 K7, bf16 chunks", DEEP3, 1, cache_dtype="bf16"),
         run("deep3 K7, f32 chunks", DEEP3, 1), "(c) bf16 chunks == f32 chunks, K7", val=False)

    # the card's busy share of one epoch from the RAM chunk cache: a
    # 2-epoch "auto" run with torch.profiler (device events) started once
    # epoch 1's last validation chunk is done and the card has drained
    state = TR.create_state(FLAGSHIP, shuffled, generator=torch.Generator().manual_seed(SEED),
                            device=dev)
    epoch_fn = TR.kernel_epoch_for(FLAGSHIP, shuffled)
    prof, t_start, evals = profile(activities=[ProfilerActivity.CUDA]), [], []
    n_tune = len(TS._chunk_plans(plan.tune, STREAM_CHUNK))
    eval_epoch = TS.eval_epoch

    def eval_then_profile(*a, **k):
        out = eval_epoch(*a, **k)
        evals.append(1)
        if len(evals) == n_tune:
            torch.cuda.synchronize()
            prof.start()
            t_start.append(time.perf_counter())
        return out

    TS.eval_epoch = eval_then_profile
    try:
        TS.fit_streaming(state, store, plan, shuffled, epochs=2, chunk_tiles=STREAM_CHUNK,
                         epoch_fn=epoch_fn)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_start[0]) * 1e3
        prof.stop()
    finally:
        TS.eval_epoch = eval_epoch
    busy, copy = device_busy(prof)
    share = ("not measured (the profiler recorded no device time)" if busy is None else
             f"{busy / wall:.4f} ({busy:.1f} ms of {wall:.1f}; memory copies {copy:.1f} ms)")
    # the synchronizing calls of one streamed epoch (from the f32 tile
    # cache) and of one resident epoch
    kw = dict(epochs=1, chunk_tiles=STREAM_CHUNK, epoch_fn=epoch_fn, tile_cache=tc32)
    syncs = host_syncs(TS.fit_streaming, state, store, plan, shuffled, **kw)
    syncs_res = host_syncs(TR.fit, state, *resident, cfg=shuffled, epochs=1, epoch_fn=epoch_fn)
    log(f"[{gpu}] phase 17 epoch 2 of a cache=\"auto\" run (from RAM), profiled: the card busy "
        f"{share}; synchronizing calls (set_sync_debug_mode): {syncs} in one streamed epoch, "
        f"{syncs_res} in one resident fit's epoch")
    upload_rates(gpu, resident[0][:STREAM_CHUNK, ..., 0])
    del state, prof
    for f in os.listdir(work):
        if f.startswith(("tc32", "tc16")):
            os.remove(os.path.join(work, f))

    # (e) the kernel grid streamed through a new tile cache, against the
    # resident serial sweep; each config's store reads
    grid = [ModelConfig(filters=(32, 32), kernels=(k, k), out_kernel=k)
            for k in SweepConfig().kernel_vals]
    ref, tl = counted(SW.sweep_fit_serial, grid, *resident, ordered, epochs=1, device=dev)
    add_sweep_launches(tl, 2, serving=False, phase="17")
    reads, fit_streaming = [], TS.fit_streaming

    def logged(*a, **k):
        r0 = store.reads
        out = fit_streaming(*a, **k)
        reads.append(store.reads - r0)
        return out

    TS.fit_streaming = logged
    try:
        t0 = time.perf_counter()
        got, tl = counted(SW.sweep_fit_serial_streamed, grid, store, plan, ordered, epochs=1,
                          chunk_tiles=8192, tile_cache=os.path.join(work, "sweep"), device=dev)
        wall = time.perf_counter() - t0
    finally:
        TS.fit_streaming = fit_streaming
    check(tl[TK.TRAIN_LOSS] == len(grid) * nb, f"phase 17 (e): {tl[TK.TRAIN_LOSS]} steps")
    add_sweep_launches(tl, 2, serving=False, phase="17")
    check(reads[0] > 0 and reads[1:] == [0, 0], f"phase 17 (e): store reads per config {reads}")
    # the steps are the kernels' (a fixed order); the validation pass is
    # the float32 module on cuDNN, whose algorithm may differ between two
    # runs: val is held to TOL_F32_REL
    val_gap = float(np.max(np.abs(got.val_history - ref.val_history) / ref.val_history))
    check(np.array_equal(got.train_history, ref.train_history) and val_gap <= TOL_F32_REL
          and all(torch.equal(got.stacked_params[k], v) for k, v in ref.stacked_params.items()),
          f"phase 17 (e): streamed sweep {got.train_history}, {got.val_history} vs resident "
          f"{ref.train_history}, {ref.val_history}")
    log(f"[{gpu}] phase 17 (e) sweep_fit_serial_streamed, k3/k5/k7 x 1 epoch through a new "
        f"tile cache: {wall:.2f} s, store reads per config {reads}; train losses and "
        f"parameters == sweep_fit_serial's bit for bit, val_loss {got.val_losses.tolist()} "
        f"(relative gap {val_gap:.3g}, bit for bit: "
        f"{np.array_equal(got.val_history, ref.val_history)})")
    shutil.rmtree(work)
    log(f"gates (training losses and parameters bit for bit): (a) streamed == resident, "
        f"(b) auto == tile cache, (c) bf16 == f32 chunks on K5 and K7, (d) resume == "
        f"uninterrupted, (e) streamed sweep == resident sweep with configs 2-3 reading "
        f"nothing; (f) K5/K7 launches only, one ae_train_loss a step; {host_rss()}")
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")


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
    traces = torch.from_numpy(shot(sp, N_CHANNELS, SEED)).to(dev)
    specs, k1 = counted(SF.spectrogram_fused, traces, sp)
    check(k1 == {SF.STFT_KERNEL: 1}, f"phase 15 (a): K1 launches {k1}")
    row(SF.STFT_KERNEL, "K1")["launches"] += 1
    del traces
    fns = {"denoise_signal": SVD.denoise_signal,
           "denoise_signal(use_optimal)": lambda x: SVD.denoise_signal(x, use_optimal=True),
           "compute_signal": SVD.compute_signal, "deflate_top1": SVD.deflate_top1}
    lowrank = HL.lowrank_batch(dev, N_CHANNELS, 7)
    for name, x in (("K1 spectrograms", specs), ("low-rank batch", lowrank)):
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
    xg = HL.gate_matrix(11)
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


def train_raw_phase(dev, gpu, d: str) -> None:
    """Phase 15 (c): the CLI's raw-to-model path in process (see the
    docstring), counted, in the work directory ``d`` (its binaries and
    model directories serve phase 16)."""
    from specenh_torch import cli

    n_train = int(RAW_SHOTS * N_CHANNELS * 30 * TrainConfig().split_fracs[0])
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


def analyses_phase(dev, gpu, d: str) -> None:
    """Phase 15: the SVD denoiser, the cross power and train-raw."""
    t0 = time.perf_counter()
    svd_phase(dev, SpecParams(), gpu)
    crosspower_phase(dev, gpu)
    train_raw_phase(dev, gpu, d)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")


class MemorySink:
    """An in-memory store for ``serve_once``'s writers (the card has no
    h5py): the arrays each ``write_channel`` persists, by (group,
    channel)."""

    def __init__(self, path: str):
        self.path = path
        self.channels: dict = {}

    def write_channel(self, shot, chn, spec, f, t, out, prefix="ece"):
        self.channels[(f"{prefix}_{shot}", chn)] = (spec, out)

    def flush(self):
        pass

    def close(self):
        pass


def device_busy(prof) -> tuple:
    """(busy ms, copy ms) of the card in a torch.profiler run: the union of
    its device events' intervals, and the part in memory copies; (None,
    None) where the profiler recorded no device time."""
    from torch.autograd import DeviceType

    spans, copy_us = [], 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.append((e.time_range.start, e.time_range.end))
            if "memcpy" in e.name.lower():
                copy_us += e.time_range.end - e.time_range.start
    if not spans:
        return None, None
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, copy_us / 1e3


def drain(dev, model_cfg, model, watch: str, writers: int, tag: str, profiled=False):
    """One ``serve_once`` of the shots in ``watch`` by a new
    ``EnhanceService`` into ``writers`` in-memory sinks, counted (or, with
    ``profiled``, under torch.profiler); returns what it measured."""
    from torch.profiler import ProfilerActivity, profile

    from specenh_torch.io.store import CampaignManifest
    from specenh_torch.serve import EnhanceService, serve_once
    from specenh_torch.utils.logging import MetricsLogger

    work = os.path.join(os.path.dirname(watch), f"{tag}-{writers}{'-prof' if profiled else ''}")
    os.makedirs(work)
    sinks = [MemorySink(f"sink{k}") for k in range(writers)]
    manifest = CampaignManifest(os.path.join(work, "serve.jsonl"))
    mpath = os.path.join(work, "metrics.jsonl")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t_made = time.time()
    service = EnhanceService(Config(), model_cfg, model, n_channels=N_CHANNELS, device=dev)
    before = {"ae": _build.conv_template_launches("ae")}
    prof = None
    with MetricsLogger(mpath) as metrics:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                counts = serve_once(service, watch, StoreWriterPool.from_stores(sinks),
                                    manifest, metrics, verbose=False)
                torch.cuda.synchronize()
            launches = {}
        else:
            counts, launches = counted(serve_once, service, watch,
                                       StoreWriterPool.from_stores(sinks), manifest, metrics,
                                       verbose=False)
    peak = torch.cuda.max_memory_allocated(dev)
    with open(mpath) as fh:
        events = [json.loads(line) for line in fh]
    return dict(service=service, sinks=sinks, manifest=manifest, counts=counts,
                launches=launches, templates=template_deltas(before)["ae"], events=events,
                t_made=t_made, peak=peak, base=base,
                busy=device_busy(prof) if prof is not None else (None, None))


def serve_phase(dev, gpu, d: str, nvcc_s: dict) -> None:
    """Phase 16: the watch-directory service (``serve.serve_once``) on the
    card, over 8 SPEC binaries of 20 x 1e6 samples (phase 15 (c)'s 4 and 4
    more) and a truncated one, with phase 15 (c)'s trained scan_k3 model
    (1 and 2 writer threads) and deep3 model (2 shots); then a second
    drain of the same directory.  Gated: the counts, every persisted
    channel bit for bit the service called directly, the metrics events,
    the launches per shot.  Printed: shots/s, latency, read time, the bare
    service's ms/shot, the device's busy share, peak memory, warm start."""
    from specenh_torch.io.native import read_shot
    from specenh_torch.serve import serve_once

    t_phase = time.perf_counter()
    sp = SpecParams()
    check(torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev),
          "phase 16: the dispatching thread is not on the default stream")
    watch, watch3 = os.path.join(d, "watch"), os.path.join(d, "watch3")
    os.makedirs(watch)
    os.makedirs(watch3)
    bins = sorted(os.listdir(os.path.join(d, "bin")))
    check(len(bins) == RAW_SHOTS, f"phase 16: phase 15 (c) left {bins}")
    for name in bins:
        os.link(os.path.join(d, "bin", name), os.path.join(watch, name))
    # the campaign's next shots, 100004-100007 (the writer pool routes
    # 100000-100003 to one shard of two and these to the other)
    extra = synthetic_shot_batch(n_shots=SERVE_SHOTS - RAW_SHOTS, n_channels=N_CHANNELS,
                                 n_samples=sp.n_samples, seed=1)
    for s, x in enumerate(extra):
        write_shot_bin(os.path.join(watch, f"ece_{100000 + RAW_SHOTS + s}.bin"), x)
    del extra
    with open(os.path.join(watch, bins[0]), "rb") as fh:
        head = fh.read(4096)
    with open(os.path.join(watch, "ece_100000a.bin"), "wb") as fh:  # truncated, sorts mid-stream
        fh.write(head)
    shots = sorted(f for f in os.listdir(watch) if f != "ece_100000a.bin")
    deep3_shots = shots[RAW_SHOTS - 1:RAW_SHOTS + 1]  # 100003 and 100004: one on each shard
    for name in deep3_shots:
        os.link(os.path.join(watch, name), os.path.join(watch3, name))
    heads = set()
    for name in shots:
        with open(os.path.join(watch, name), "rb") as fh:
            heads.add(fh.read(1 << 16))
    check(len(heads) == len(shots), "phase 16: two shots share their traces")

    models = {}
    for tag in ("scan_k3", "deep3"):
        state, model_cfg = TR.load_model(os.path.join(d, tag, "model"), device=dev)
        models[tag] = (model_cfg, state.model)
    for tag, where, writers, n_good in (("scan_k3", watch, 1, SERVE_SHOTS),
                                        ("scan_k3", watch, 2, SERVE_SHOTS),
                                        ("deep3", watch3, 2, 2)):
        model_cfg, model = models[tag]
        depth = model_cfg.depth
        r = drain(dev, model_cfg, model, where, writers, tag)
        n_bad = 1 if where == watch else 0
        check(r["counts"] == {"done": n_good, "failed": n_bad},
              f"phase 16 {tag}/{writers}: counts {r['counts']}")
        per_shot = {SF.STFT_KERNEL: 1, AK.TILE_IN: 1, AK.CONV_POOL: depth - 1,
                    AK.CONVT: depth, AK.TILE_OUT: 1}
        want = {k: n * n_good for k, n in per_shot.items()}
        check(r["launches"] == want, f"phase 16 {tag}/{writers}: launches "
              f"{[(k.symbol, v) for k, v in r['launches'].items()]}, want "
              f"{[(k.symbol, v) for k, v in want.items()]}")
        check(r["templates"][QUAD] == 0 and r["templates"][CT_RELU] == 0,
              f"phase 16 {tag}/{writers}: conv templates {r['templates']}")
        row(SF.STFT_KERNEL, "K1")["launches"] += want[SF.STFT_KERNEL]
        add_sweep_launches({k: v for k, v in want.items() if k is not SF.STFT_KERNEL}, depth,
                           serving=True, phase="16")
        shot_ev = [e for e in r["events"] if e["event"] == "shot_enhanced"]
        batch = [e for e in r["events"] if e["event"] == "serve_batch"]
        check(len(shot_ev) == n_good and len(batch) == 1
              and all(e["read_s"] >= 0 and e["latency_s"] >= e["read_s"] for e in shot_ev)
              and batch[0]["done"] == n_good and batch[0]["writers"] == writers,
              f"phase 16 {tag}/{writers}: metrics events {r['events']}")
        check(all(s.channels for s in r["sinks"]),
              f"phase 16 {tag}/{writers}: a writer persisted nothing")
        # every persisted channel bit for bit the service called directly
        service = r["service"]
        persisted = {k: v for s in r["sinks"] for k, v in s.channels.items()}
        names = shots if where == watch else deep3_shots
        check(len(persisted) == n_good * N_CHANNELS, f"phase 16: {len(persisted)} channels")
        host = []
        for name in names:
            traces = read_shot(os.path.join(where, name), N_CHANNELS, sp.n_samples)
            host.append(traces)
            specs, enh = (t.cpu().numpy() for t in service.fn(service.params, traces))
            group = "enhanced_" + name[len("ece_"):-len(".bin")]
            for c in range(N_CHANNELS):
                got_s, got_e = persisted[(group, c + 1)]
                check(np.array_equal(got_s, specs[c]) and np.array_equal(got_e, enh[c]),
                      f"phase 16 {tag}/{writers}: {group} channel {c + 1} differs from the "
                      "direct call")
        del persisted, r["sinks"]
        lat = np.array([e["latency_s"] for e in shot_ev])
        reads = np.array([e["read_s"] for e in shot_ev])
        warm = min(e["time"] for e in shot_ev) - r["t_made"]
        daemon_ms = batch[0]["seconds"] / n_good * 1e3
        # the bare service on the same shots: traces on the card, from the
        # host, and from the host with the outputs copied back
        on_card = torch.from_numpy(host[0]).to(dev)
        bare = time_cuda(service.fn, service.params, on_card, warmup=2, iters=5)
        from_host = time_cuda(service.fn, service.params, host[0], warmup=1, iters=5)
        round_trip = time_cuda(lambda: [t.cpu() for t in service.fn(service.params, host[0])],
                               warmup=1, iters=5)
        del on_card, host
        p = drain(dev, model_cfg, model, where, writers, tag, profiled=True)
        busy, copy = p["busy"]
        p_batch = [e for e in p["events"] if e["event"] == "serve_batch"][0]
        check(p["counts"] == r["counts"], f"phase 16 {tag}/{writers}: profiled counts "
              f"{p['counts']}")
        share = ("not measured (the profiler recorded no device time)" if busy is None else
                 f"{busy / (p_batch['seconds'] * 1e3):.4f} ({busy:.1f} ms of a "
                 f"{p_batch['seconds'] * 1e3:.1f} ms profiled drain; memory copies "
                 f"{copy:.1f} ms)")
        log(f"[{gpu}] phase 16 {tag} ({model_cfg.filters}/k{model_cfg.kernels[0][0]}), "
            f"{writers} writer(s), {n_good} shots + {n_bad} truncated: counts {r['counts']}; "
            f"{batch[0]['shots_per_sec']:.3f} shots/s ({daemon_ms:.1f} ms a shot; drain "
            f"{batch[0]['seconds']:.3f} s); latency_s median {np.median(lat):.3f}, p90 "
            f"{np.percentile(lat, 90):.3f}; read_s median {np.median(reads):.4f}; bare service "
            f"{bare:.4f} ms a shot on the card, {from_host:.4f} from host numpy, "
            f"{round_trip:.4f} with the outputs copied back (CUDA events); device busy share "
            f"{share}; peak allocated {p['peak'] / 2**30:.3f} GiB profiled, "
            f"{r['peak'] / 2**30:.3f} GiB ({(r['peak'] - r['base']) / 2**30:.3f} above the "
            f"{r['base'] / 2**30:.3f} held before); warm start {warm:.3f} s from "
            f"EnhanceService(...) to the first shot persisted (kernels built; the cold "
            f"start's build share: phase 2's nvcc, ae.cu {nvcc_s.get('ae', 0):.1f} s and "
            f"stft.cu {nvcc_s.get('stft', 0):.1f} s in parallel); launches per shot "
            + ", ".join(f"{k.symbol}={v}" for k, v in per_shot.items()))
        if (tag, writers) == ("scan_k3", 1):
            # a second drain of the same directory with the same manifest: idempotent
            again, took = counted(serve_once, service, watch,
                                  StoreWriterPool.from_stores([MemorySink("again")]),
                                  r["manifest"], verbose=False)
            check(again == {"done": 0, "failed": 0} and not took,
                  f"phase 16: the second drain gave {again}, launches {took}")
            log(f"[{gpu}] phase 16 second drain of the same directory: {again}, no launch")
        r["manifest"].close()
        p["manifest"].close()
        del r, p, service
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")


def keras_weights(cfg: ModelConfig, seed: int) -> list:
    """A Keras-layout weight list of ``cfg`` drawn with numpy, in Keras's
    layer order: HWIO conv kernels, the transposes' (kh, kw, OUT, IN)
    kernels from the deepest up, the head; glorot-uniform kernels, small
    normal biases."""
    rng = np.random.default_rng(seed)
    f, d = cfg.filters, cfg.depth
    shapes = [(*cfg.kernels[i], (1, *f)[i], f[i]) for i in range(d)]
    shapes += [(*cfg.kernels[i], f[i], f[min(i + 1, d - 1)]) for i in reversed(range(d))]
    shapes.append((*cfg.out_kernel, f[0], 1))
    out = []
    for j, s in enumerate(shapes):
        lim = (6.0 / (s[0] * s[1] * (s[2] + s[3]))) ** 0.5
        n_out = s[2] if d <= j < 2 * d else s[3]
        out += [rng.uniform(-lim, lim, s).astype(np.float32),
                rng.normal(0.0, 0.05, n_out).astype(np.float32)]
    return out


def add_serve_launches(launches: dict, depth: int) -> None:
    """A gated service run's launches into the kernels line's rows: K1 and
    the serving stages at ``depth``."""
    row(SF.STFT_KERNEL, "K1")["launches"] += launches[SF.STFT_KERNEL]
    for kern, kid in SERVE_IDS[depth].items():
        ROWS[(kern, kid)]["launches"] += launches[kern]


def keras_phase(dev, sp) -> None:
    """Phase 18 (a): Keras-layout weight lists drawn with numpy for the
    flagship and deep3, converted by ``models.keras_import``, served on
    three full-width shots through the bf16 service with both gates
    against the plain float32 service on the same weights."""
    from specenh_torch.models.keras_import import (model_config_from_keras_weights,
                                                   params_from_keras_weights)

    for cfg, seed in ((FLAGSHIP, 1), (DEEP3, 2)):
        w = keras_weights(cfg, seed)
        got = model_config_from_keras_weights(w)
        check(got == cfg, f"phase 18 (a): config {got} from the weight list, expected {cfg}")
        model = make_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        model.load_state_dict(params_from_keras_weights(w, cfg))
        run = run_service(dev, sp, cfg, model.eval(), N_CHANNELS)
        add_serve_launches(run["launches"], cfg.depth)
        log(f"phase 18 (a): depth-{cfg.depth} service on Keras-layout weights (seed {seed}): "
            f"both gates held on 3 shots")
        del run, model


def gloo_rank(rank: int, port: int, x, y, sd: dict, epochs: int, out) -> None:
    """Phase 18 (c), one of two ranks on the one card over gloo: ``dp_fit``
    on K5 from ``sd``; puts (rank, per-epoch losses, per-step losses,
    per-epoch seconds, parameters, gloo all-reduce ms, its launches, the
    wall-clock times its target started, joined the group and finished
    training) or (rank, "error", traceback) on ``out``."""
    t_start = time.time()
    import traceback

    from specenh_torch.parallel.data_parallel import dp_fit
    from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
    from specenh_torch.parallel.mesh import make_mesh
    from specenh_torch.parallel.multihost import initialize_distributed

    try:
        initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout=120)
        mesh = make_mesh(2, device="cuda:0")
        t_joined = time.time()
        tc = TrainConfig()
        state = TR.create_state(FLAGSHIP, tc, device=mesh.device)
        state.model.load_state_dict(sd)
        epoch = dp_kernel_epoch_for(FLAGSHIP, tc, mesh)
        steps = []

        def recorded(st, *a):
            st, losses = epoch(st, *a)
            steps.append(losses.cpu())
            return st, losses

        for kern in _build.KERNELS:
            kern.launches = 0
        with tempfile.TemporaryDirectory() as d:
            _, h = dp_fit(state, x, y, mesh, epochs=epochs, batch_size=BATCH, seed=tc.seed,
                          epoch_fn=recorded, metrics_path=os.path.join(d, "m.jsonl"))
            secs = ([json.loads(ln)["sec"] for ln in open(os.path.join(d, "m.jsonl"))]
                    if rank == 0 else [])
        t_trained = time.time()
        launches = {k.symbol: k.launches for k in _build.KERNELS if k.launches}
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        buf = torch.zeros(flat.numel() + 2, device=mesh.device)
        for _ in range(5):
            torch.distributed.all_reduce(buf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            torch.distributed.all_reduce(buf)
        torch.cuda.synchronize()
        ar_ms = (time.perf_counter() - t0) / 50 * 1e3
        out.put((rank, h["loss"], torch.cat(steps).tolist(), secs, flat.cpu().numpy(), ar_ms,
                 launches, (t_start, t_joined, t_trained)))
        torch.distributed.destroy_process_group()
    except Exception:
        out.put((rank, "error", traceback.format_exc()))


def dp_phase(dev, gpu, data) -> None:
    """Phase 18 (b)-(e): data-parallel training (``parallel.dp_fit`` with
    ``dp_kernel_epoch_for``).  (b) a world of one over NCCL on the recipe's
    tiles: the flagship on K5, bf16, 2 epochs with validation, and deep3 on
    K7, 1 epoch, each ``fit`` with ``kernel_epoch_for`` from the same
    weights bit for bit in training losses and parameters (val_loss, the
    float32 module on cuDNN, within TOL_F32_REL), counted: every K5 (K7)
    entry point launched; (c) two ranks on the one card over gloo (NCCL
    refuses a duplicate GPU), K5 on each rank's half of every batch, the
    last batch leaving rank 1 only padding: both ranks' parameters equal bit
    for bit, every step's loss finite, per-epoch losses within
    TOL_DP_GLOO relative of (b) and within the 0.1 % loss-curve gate; (d)
    s/epoch of (b) against ``fit`` in this run, the all-reduce's ms a call
    (NCCL, world of one; gloo, two ranks), s/epoch of (c); (e) ``train
    --devices N --engine kernel`` with N more than the visible GPUs exits
    with the device-count message."""
    import queue
    import socket

    import torch.multiprocessing as mp

    from specenh_torch import cli as TCLI
    from specenh_torch.parallel.data_parallel import dp_fit
    from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
    from specenh_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    tc = TrainConfig()
    n = len(data.x_train)
    nb = -(-n // BATCH)
    check(n % BATCH and n % BATCH <= BATCH // 2,
          f"phase 18: {n} tiles must leave rank 1 all padding in the last batch of {BATCH}")

    def state(cfg):
        return TR.create_state(cfg, tc, generator=torch.Generator().manual_seed(SEED),
                               device=dev)

    def secs(path):
        with open(path) as fh:
            return [json.loads(ln)["sec"] for ln in fh]

    mesh = make_mesh(1, device=dev)
    check(mesh.backend == "nccl" and mesh.shape == {"data": 1}, f"phase 18 mesh {mesh}")
    b_hist = {}
    with tempfile.TemporaryDirectory() as d:
        for cfg, epochs, val in ((FLAGSHIP, EPOCHS_DP, True), (DEEP3, 1, False)):
            vargs = (data.x_tune, data.y_tune) if val else ()
            s_fit, h_fit = TR.fit(state(cfg), data.x_train, data.y_train, *vargs, cfg=tc,
                                  epochs=epochs, epoch_fn=TR.kernel_epoch_for(cfg, tc),
                                  metrics_path=os.path.join(d, f"fit{cfg.depth}.jsonl"))
            (s_dp, h_dp), launches = counted(
                dp_fit, state(cfg), data.x_train, data.y_train, mesh, *vargs, epochs=epochs,
                batch_size=BATCH, seed=tc.seed, epoch_fn=dp_kernel_epoch_for(cfg, tc, mesh),
                metrics_path=os.path.join(d, f"dp{cfg.depth}.jsonl"))
            tag = "flagship K5" if cfg.depth == 2 else "deep3 K7"
            check(h_dp["loss"] == h_fit["loss"],
                  f"phase 18 (b) {tag}: dp_fit losses {h_dp['loss']} != fit {h_fit['loss']}")
            check(same_state(s_dp, s_fit), f"phase 18 (b) {tag}: parameters differ from fit")
            for a, b in zip(h_dp["val_loss"], h_fit["val_loss"]):
                check(abs(a - b) <= TOL_F32_REL * b, f"phase 18 (b) {tag}: val_loss {a} vs {b}")
            for kern in (*TRAIN3_KERNELS, AK.CONVT):
                check(launches.get(kern, 0) > 0, f"phase 18 (b): {kern.symbol} not launched")
            check(launches[TK.TRAIN_LOSS] == nb * epochs,
                  f"phase 18 (b): {launches[TK.TRAIN_LOSS]} losses in {nb * epochs} steps")
            add_sweep_launches(launches, cfg.depth, serving=False, phase="18")
            b_hist[cfg.depth] = h_dp
            t_fit, t_dp = secs(os.path.join(d, f"fit{cfg.depth}.jsonl")), secs(
                os.path.join(d, f"dp{cfg.depth}.jsonl"))
            log(f"[{gpu}] phase 18 (b) {tag}, world of one over NCCL, {epochs} epoch(s) of "
                f"{n} tiles: dp_fit losses {h_dp['loss']} == fit's, parameters bit for bit"
                + (f", val_loss {h_dp['val_loss']} (fit {h_fit['val_loss']})" if val else "")
                + f"; s/epoch dp_fit {t_dp} against fit {t_fit} (this run)")
            del s_fit, s_dp
        n_par = sum(p.numel() for p in state(FLAGSHIP).model.parameters())
        buf = torch.zeros(n_par + 2, device=dev)
        ms = time_cuda(torch.distributed.all_reduce, buf, warmup=5, iters=200)
        log(f"[{gpu}] phase 18 (d): one NCCL all_reduce of a flagship step's {n_par + 2} "
            f"floats, world of one: {ms:.4f} ms ({nb} a flagship epoch)")
    mesh.close()

    # (c) two gloo ranks on the one card, the tiles shared through CUDA IPC;
    # the cached free blocks go back first: each child needs room for its
    # context and the shared tiles' mapping
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0, t0_wall = time.perf_counter(), time.time()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    sd = {k: v.cpu() for k, v in state(FLAGSHIP).model.state_dict().items()}
    procs = [ctx.Process(target=gloo_rank,
                         args=(r, port, data.x_train, data.y_train, sd, EPOCHS_DP, q))
             for r in (0, 1)]
    for p in procs:
        p.start()
    results, deadline = {}, time.perf_counter() + 300
    try:
        while len(results) < len(procs):
            try:
                r = q.get(timeout=2)
                results[r[0]] = r
            except queue.Empty:
                gone = [k for k, p in enumerate(procs) if p.exitcode is not None
                        and k not in results]
                check(not gone, f"phase 18 (c): rank(s) {gone} exited with no result "
                      f"(exit codes {[procs[k].exitcode for k in gone]})")
                check(time.perf_counter() < deadline, "phase 18 (c): no result in 300 s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    got = [results[k] for k in sorted(results)]
    for r in got:
        check(r[1] != "error", f"phase 18 (c) rank {r[0]} failed:\n{r[-1]}")
    (_, l0, st0, sec0, p0, ar0, la0, w0), (_, l1, st1, _, p1, ar1, la1, w1) = got
    check(np.array_equal(p0, p1), "phase 18 (c): the two ranks' parameters differ")
    check(l0 == l1 and st0 == st1, "phase 18 (c): the two ranks' losses differ")
    check(len(st0) == nb * EPOCHS_DP and all(np.isfinite(st0)),
          f"phase 18 (c): {len(st0)} step losses, finite {all(np.isfinite(st0))}")
    ref = b_hist[2]["loss"]
    rel = [abs(a - b) / b for a, b in zip(l0, ref)]
    check(max(rel) <= TOL_DP_GLOO, f"phase 18 (c): epoch losses {l0} vs world of one {ref}")
    check(max(rel) <= TOL_LOSS_CURVE, "phase 18 (c): the loss-curve gate")
    for kern in _build.KERNELS:
        n_k = la0.get(kern.symbol, 0) + la1.get(kern.symbol, 0)
        if n_k:
            add_sweep_launches({kern: n_k}, 2, serving=False, phase="18 (c)")
    log(f"[{gpu}] phase 18 (c) two gloo ranks on one card, K5, {EPOCHS_DP} epochs: losses "
        f"{l0} (world of one {ref}; relative {', '.join(f'{v:.3g}' for v in rel)}, gate "
        f"{TOL_DP_GLOO:g}); parameters equal on both ranks; {len(st0)} steps finite (rank 1 "
        f"all padding in each epoch's last batch); s/epoch {sec0}; gloo all_reduce of the "
        f"step's floats {ar0:.4f} / {ar1:.4f} ms (ranks 0 / 1); wall with the two processes' "
        f"start {time.perf_counter() - t0:.1f} s: the ranks' targets started "
        f"{w0[0] - t0_wall:.1f} / {w1[0] - t0_wall:.1f} s after the spawn, joined the group "
        f"{w0[1] - t0_wall:.1f} / {w1[1] - t0_wall:.1f} s, finished training "
        f"{w0[2] - t0_wall:.1f} / {w1[2] - t0_wall:.1f} s")

    # (e) more devices than are visible: the device-count message, no fallback
    ask = max(2, torch.cuda.device_count() + 1)
    want = (f"--devices {ask}: requested {ask} devices but only "
            f"{torch.cuda.device_count()} available")
    with tempfile.TemporaryDirectory() as d:
        try:
            TCLI.main(["train", "--dataset", os.path.join(d, "none.hdf5"), "--out-dir", d,
                       "--devices", str(ask), "--engine", "kernel", "--quiet"])
            raise AssertionError("phase 18 (e): train --devices did not exit")
        except SystemExit as e:
            check(str(e) == want, f"phase 18 (e): exit {e!r}, expected {want!r}")
    log(f"phase 18 (e): train --devices {ask} --engine kernel exits: {want}")
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")


# phase 19: the time-sharded long shot (JAX's headline shot, headline.py:276-313)
LONGSHOT = SpecParams(cut_shot=4.0)
LONGSHOT_ITERS = 48    # CUDA-event calls timed after warm-up, as the headline's 48
TOL_TS_SPEC = 5e-5     # sharded spectrogram vs the unsharded one (JAX's tests/test_parallel.py)
TOL_TS_LABELS = 1e-5   # sharded labels vs classical_pipeline (JAX's tests)
TOL_MESH_SERVE = 1e-6  # the channel-sharded service vs the single one (JAX's tests)
MESH_SHOTS = 4         # phase 19 (b): serve_once over this many SPEC binaries


def profile_split(call, n: int) -> str:
    """``call()`` n times under torch.profiler: the card's busy ms a call,
    the collectives' share of it and the six device kernels with the most
    time, by name (the profiler's own host cost makes its wall time no
    measure of a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    busy, _ = device_busy(prof)
    if busy is None:
        return "device time not measured (the profiler recorded no device events)"
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            d = (e.time_range.end - e.time_range.start) / 1e3 / n
            by_name[e.name] = by_name.get(e.name, 0.0) + d
    nccl = sum(v for k, v in by_name.items() if "nccl" in k.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (f"the card busy {busy / n:.4f} ms a call, NCCL kernels {nccl:.4f} ms of it; the "
            f"most device time: "
            + "; ".join(f"{k[:60]} {v:.4f} ms" for k, v in top))


@torch.no_grad()
def longshot_gates(tag, fn, wts, model, x, k_tiles, gpu):
    """Phase 19 (a), one input: the time-sharded shot ``fn`` on a world of
    one, counted; spectrogram against ``ops.stft.spectrogram`` of ``x``
    within TOL_TS_SPEC on its frames and its last column a copy, labels
    against ``classical_pipeline`` of it within TOL_TS_LABELS, enhanced bit
    for bit ``ae_kernel_enhance_specs`` of it and at SSIM >= 0.999 against
    the plain float32 module on every channel.  Returns the launches."""
    from specenh_torch.ops.stft import spectrogram

    (spec, labels, enh), launches = counted(fn, wts, x)
    ref = spectrogram(x, LONGSHOT)
    nf = ref.shape[-1]
    check(spec.shape[-1] == nf + 1 and labels.shape == enh.shape == spec.shape,
          f"{tag}: shapes {tuple(spec.shape)}, {tuple(labels.shape)}, {tuple(enh.shape)}")
    e_spec = max_err(spec[..., :nf], ref)
    check(e_spec <= TOL_TS_SPEC and torch.equal(spec[..., -1], spec[..., -2]),
          f"{tag}: spectrogram |err| {e_spec:.3g} or its last column")
    e_lab = max_err(labels, EN.classical_pipeline(spec))
    check(e_lab <= TOL_TS_LABELS, f"{tag}: labels |err| {e_lab:.3g}")
    s3, e3 = (spec[None], enh[None]) if x.ndim == 1 else (spec, enh)
    check(torch.equal(e3, AK.ae_kernel_enhance_specs(wts, s3, k_tiles)),
          f"{tag}: enhanced differs from ae_kernel_enhance_specs of its spectrogram")
    plain = torch.cat([AK.ae_kernel_enhance_specs_plain(model, s3[c:c + 1], k_tiles)
                       for c in range(s3.shape[0])])
    e_ssim = float(ssim_card(e3, plain).min())
    check(e_ssim >= GATE_ENH_SSIM, f"{tag}: enhanced SSIM {e_ssim:.6f}")
    log(f"[{gpu}] phase 19 (a) {tag}: spectrogram |err| {e_spec:.3g} (tol {TOL_TS_SPEC}), labels "
        f"|err| {e_lab:.3g} (tol {TOL_TS_LABELS}), enhanced bit for bit the kernels on its "
        f"spectrogram, SSIM vs the plain f32 module min over {s3.shape[0]} ch {e_ssim:.6f}")
    return launches


def mesh_rank(rank: int, port: int, inp: dict, out) -> None:
    """Phase 19 (b), one of two ranks on the one card over gloo: the 4 s
    shot split two ways (gathered, gated and timed on rank 0), the
    channel-sharded flagship and deep3 services on a 20-channel shot, and
    ``serve_once`` of ``inp["watch"]`` on rank 0 while rank 1 follows.
    Puts (rank, results) or (rank, "error", traceback) on ``out``."""
    import traceback

    from specenh_torch.io.native import read_shot
    from specenh_torch.io.store import CampaignManifest
    from specenh_torch.parallel import timeshard as TS
    from specenh_torch.parallel.mesh import make_mesh
    from specenh_torch.parallel.multihost import initialize_distributed
    from specenh_torch.serve import EnhanceService, serve_once
    from specenh_torch.utils.logging import MetricsLogger

    t_start = time.time()
    try:
        initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout=120)
        tmesh = make_mesh(2, ("time",), device=inp["device"])
        dmesh = make_mesh(2, ("data",), device=inp["device"])
        dev = tmesh.device
        res, launches = {"joined": time.time() - t_start}, {}

        def model_of(cfg):
            m = make_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
            m.load_state_dict(inp["sd"][cfg.depth])
            return m.eval()

        def tally(got, depth):
            for kern, n in got.items():
                launches[(kern.symbol, depth)] = launches.get((kern.symbol, depth), 0) + n

        # the 4 s shot, two shards of 30 tiles
        model = model_of(FLAGSHIP)
        x = torch.from_numpy(inp["x2"]).to(dev)
        fn = TS.make_sharded_enhance_shot(FLAGSHIP, LONGSHOT, tmesh, n_samples=x.shape[-1])
        wts = fn.prepare(model)
        local, got = counted(fn, wts, TS.shard_of(tmesh, x))
        tally(got, 2)
        spec, labels, enh = TS.gather_shards(tmesh, *local)
        res["local"] = tuple(local[0].shape)
        ms = time_cuda(fn, wts, TS.shard_of(tmesh, x), warmup=2, iters=LONGSHOT_ITERS)
        if rank == 0:
            ref_spec, ref_lab, ref_plain = (torch.from_numpy(a).to(dev) for a in inp["ref2"])
            k = spec.shape[-1] // 128
            res["shot"] = dict(
                spec=max_err(spec, ref_spec), labels=max_err(labels, ref_lab),
                equal=torch.equal(enh[None], AK.ae_kernel_enhance_specs(wts, spec[None], k)),
                ssim=float(ssim_card(enh[None], ref_plain[None]).min()), ms=ms, k=k)
        # the channel-sharded services, 10 channels a rank
        traces = torch.from_numpy(inp["traces"]).to(dev)
        res["service"] = {}
        for cfg in (FLAGSHIP, DEEP3):
            model = model_of(cfg)
            fn = make_enhance_shot_fn(cfg, SpecParams(), device=dev, mesh=dmesh,
                                      n_channels=N_CHANNELS)
            wts = fn.prepare(model)
            (specs, enh), got = counted(fn, wts, traces)
            tally(got, cfg.depth)
            ms = time_cuda(fn, wts, traces, warmup=1, iters=5)
            if rank == 0:
                single = make_enhance_shot_fn(cfg, SpecParams(), device=dev)
                s1, e1 = single(single.prepare(model), traces)
                res["service"][cfg.depth] = (max_err(specs, s1), max_err(enh, e1), ms)
        # the mesh daemon: serve_once on rank 0, follow() on rank 1
        service = EnhanceService(Config(), FLAGSHIP, model_of(FLAGSHIP), n_channels=N_CHANNELS,
                                 device=dev, mesh=dmesh)
        if rank == 0:
            work = inp["work"]
            manifest = CampaignManifest(os.path.join(work, "mesh.serve.jsonl"))
            sink = MemorySink("mesh")
            mpath = os.path.join(work, "mesh.metrics.jsonl")
            with MetricsLogger(mpath) as metrics:
                counts, got = counted(serve_once, service, inp["watch"],
                                      StoreWriterPool.from_stores([sink]), manifest, metrics,
                                      verbose=False)
            service.close()
            manifest.close()
            with open(mpath) as fh:
                batch = [e for e in map(json.loads, fh) if e["event"] == "serve_batch"][0]
            single = EnhanceService(Config(), FLAGSHIP, model_of(FLAGSHIP),
                                    n_channels=N_CHANNELS, device=dev)
            worst = 0.0
            for name in sorted(os.listdir(inp["watch"])):
                t_ = read_shot(os.path.join(inp["watch"], name), N_CHANNELS,
                               SpecParams().n_samples)
                s1, e1 = single.fn(single.params, t_)
                group = "enhanced_" + name[len("ece_"):-len(".bin")]
                for c in range(N_CHANNELS):
                    got_s, got_e = sink.channels[(group, c + 1)]
                    worst = max(worst, float(np.abs(got_s - s1[c].cpu().numpy()).max()),
                                float(np.abs(got_e - e1[c].cpu().numpy()).max()))
            res["serve"] = dict(counts=counts, channels=len(sink.channels), worst=worst,
                                shots_per_sec=batch["shots_per_sec"], seconds=batch["seconds"])
        else:
            res["followed"], got = counted(service.follow)
        tally(got, 2)
        res["launches"] = launches
        out.put((rank, res))
        torch.distributed.destroy_process_group()
    except Exception:
        out.put((rank, "error", traceback.format_exc()))


@torch.no_grad()
def mesh_phase(dev, gpu) -> None:
    """Phase 19: serving over a process-group mesh and the time-sharded
    long shot.  (a) JAX's headline long shot (``SpecParams(cut_shot=4.0)``,
    1 998 848 samples, 7808 frames, 61 tiles) through
    ``parallel.timeshard.make_sharded_enhance_shot`` on an NCCL world of
    one ``("time",)`` mesh: the flagship in bf16 and float32 and deep3 in
    bf16, each as (T,) and (20, T), gated (``longshot_gates``) and
    counted; ms a (T,) shot (CUDA events, 48 calls after warm-up) beside
    the unsharded service at ``cut_shot=4.0`` plus ``classical_pipeline``.
    (c) ``EnhanceService(mesh=)`` on an NCCL world of one ("data") is the
    service without a mesh bit for bit at both depths.  (b) one spawn of
    two gloo ranks on the one card (``mesh_rank``): the shot split two
    ways (1 966 080 samples, 30 tiles a rank) against the world of one
    (spectrogram 5e-5, labels 1e-5), the enhanced output bit for bit the
    kernels on its gathered spectrogram and at SSIM >= 0.999 against the
    plain float32 module; the channel-sharded flagship and deep3 services
    on a 20 x 1e6 shot within 1e-6 of the single service; ``serve_once``
    over 4 SPEC binaries, every persisted channel within 1e-6 of the
    single service, shots/s.  The kernels line counts (a)-(c)'s launches."""
    import queue
    import socket

    import torch.multiprocessing as mp

    from specenh_torch.parallel import timeshard as TS
    from specenh_torch.parallel.mesh import make_mesh
    from specenh_torch.serve import EnhanceService

    t_phase = time.perf_counter()
    sp = LONGSHOT
    t1 = TS.usable_samples_tiled(sp.n_samples, 1, sp)
    t2 = TS.usable_samples_tiled(sp.n_samples, 2, sp)
    host = shot(sp, N_CHANNELS, SEED)
    tmesh = make_mesh(1, ("time",), device=dev)
    dmesh = make_mesh(1, ("data",), device=dev)
    check(tmesh.backend == "nccl" and tmesh.shape == {"time": 1} and dmesh.shape == {"data": 1},
          f"phase 19 meshes {tmesh}, {dmesh}")
    sd, times = {}, []
    for cfg, dtype in ((FLAGSHIP, torch.bfloat16), (FLAGSHIP, torch.float32),
                       (DEEP3, torch.bfloat16)):
        model = make_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
        sd[cfg.depth] = {k: v.cpu() for k, v in model.state_dict().items()}
        fn = TS.make_sharded_enhance_shot(cfg, sp, tmesh, dtype=dtype, n_samples=t1)
        wts = fn.prepare(model)
        tag = f"depth-{cfg.depth} {str(dtype).split('.')[-1]}"
        for x in (torch.from_numpy(host[0, :t1]).to(dev), torch.from_numpy(host[:, :t1]).to(dev)):
            launches = longshot_gates(f"{tag} {tuple(x.shape)}", fn, wts, model, x, t1 // 256 // 128,
                                      gpu)
            want = {AK.TILE_IN: 1, AK.CONV_POOL: cfg.depth - 1, AK.CONVT: cfg.depth,
                    AK.TILE_OUT: 1}
            check(launches == want, f"phase 19 (a) {tag}: launches "
                  f"{[(k.symbol, v) for k, v in launches.items()]}")
            add_sweep_launches(launches, cfg.depth, serving=True, phase="19 (a)")
        x = torch.from_numpy(host[0, :t1]).to(dev)
        ms = time_cuda(fn, wts, x, warmup=2, iters=LONGSHOT_ITERS)
        times.append(f"{tag} {ms:.4f} ms")
        if (cfg, dtype) == (FLAGSHIP, torch.bfloat16):
            log(f"[{gpu}] phase 19 (a) {tag} (T,) shot, 5 calls profiled: "
                + profile_split(lambda: fn(wts, x), 5))
            svc = make_enhance_shot_fn(cfg, sp, device=dev)
            swts = svc.prepare(model)

            def unsharded(t):
                specs, enh = svc(swts, t)
                return enh, EN.classical_pipeline(specs)

            whole = torch.from_numpy(host[:1]).to(dev)  # (1, 2e6): the service takes 4 s
            ms_svc = time_cuda(unsharded, whole, warmup=2, iters=LONGSHOT_ITERS)
            ms_front = time_cuda(svc, swts, whole, warmup=2, iters=LONGSHOT_ITERS)
            times.append(f"(the unsharded service at cut_shot=4.0 on (1, 2e6) plus "
                         f"classical_pipeline {ms_svc:.4f} ms, the service alone {ms_front:.4f})")
        del model, fn, wts
    log(f"[{gpu}] phase 19 (a) ms a 4 s (T,) shot on an NCCL world of one, CUDA events, "
        f"{LONGSHOT_ITERS} calls: " + "; ".join(times))

    # (c) the mesh service on a world of one is the service without a mesh
    traces = shot(SpecParams(), N_CHANNELS, SEED)
    for cfg in (FLAGSHIP, DEEP3):
        model = make_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
        service = EnhanceService(Config(), cfg, model, n_channels=N_CHANNELS, device=dev,
                                 mesh=dmesh)
        got, launches = counted(service.dispatch, traces)
        service.close()
        single = make_enhance_shot_fn(cfg, SpecParams(), device=dev)
        want = single(single.prepare(model), traces)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"phase 19 (c) depth {cfg.depth}: the mesh service differs from the service")
        add_serve_launches({k: launches.get(k, 0) for k in SERVE_KERNELS}, cfg.depth)
        log(f"phase 19 (c) depth-{cfg.depth} EnhanceService(mesh=) on an NCCL world of one: "
            f"bit for bit the service, launches "
            + ", ".join(f"{k.symbol}={v}" for k, v in launches.items()))

    # (b)'s references on the world of one: the shot at the two-way length
    x2 = host[0, :t2]
    model = make_model(FLAGSHIP, generator=torch.Generator().manual_seed(SEED), device=dev).eval()
    fn = TS.make_sharded_enhance_shot(FLAGSHIP, sp, tmesh, n_samples=t2)
    spec, labels, _ = fn(fn.prepare(model), torch.from_numpy(x2).to(dev))
    plain = AK.ae_kernel_enhance_specs_plain(model, spec[None], spec.shape[-1] // 128)[0]
    ref2 = tuple(t.cpu().numpy() for t in (spec, labels, plain))
    tmesh.close()
    del model, fn, spec, labels, plain

    with tempfile.TemporaryDirectory() as work:
        watch = os.path.join(work, "watch")
        os.makedirs(watch)
        bins = synthetic_shot_batch(n_shots=MESH_SHOTS, n_channels=N_CHANNELS,
                                    n_samples=SpecParams().n_samples, seed=3)
        for s_, b in enumerate(bins):
            write_shot_bin(os.path.join(watch, f"ece_{200000 + s_}.bin"), b)
        del bins
        inp = dict(sd=sd, x2=x2, ref2=ref2, traces=traces, watch=watch, work=work,
                   device=str(dev))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # room for the children's contexts
        t0 = time.perf_counter()
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            port = s_.getsockname()[1]
        procs = [ctx.Process(target=mesh_rank, args=(r, port, inp, q)) for r in (0, 1)]
        for p in procs:
            p.start()
        results, deadline = {}, time.perf_counter() + 300
        try:
            while len(results) < len(procs):
                try:
                    r = q.get(timeout=2)
                    results[r[0]] = r
                except queue.Empty:
                    gone = [k for k, p in enumerate(procs) if p.exitcode is not None
                            and k not in results]
                    check(not gone, f"phase 19 (b): rank(s) {gone} exited with no result "
                          f"(exit codes {[procs[k].exitcode for k in gone]})")
                    check(time.perf_counter() < deadline, "phase 19 (b): no result in 300 s")
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    for r in results.values():
        check(r[1] != "error", f"phase 19 (b) rank {r[0]} failed:\n{r[-1]}")
    r0, r1 = results[0][1], results[1][1]
    sh = r0["shot"]
    check(r0["local"] == r1["local"] == (256, t2 // 2 // sp.hop),
          f"phase 19 (b) shards {r0['local']}")
    check(sh["spec"] <= TOL_TS_SPEC and sh["labels"] <= TOL_TS_LABELS and sh["equal"]
          and sh["ssim"] >= GATE_ENH_SSIM, f"phase 19 (b) the 2-way shot: {sh}")
    for depth, (e_s, e_e, _) in r0["service"].items():
        check(e_s <= TOL_MESH_SERVE and e_e <= TOL_MESH_SERVE,
              f"phase 19 (b) depth-{depth} service |err| {e_s:.3g}, {e_e:.3g}")
    for r in (r0, r1):
        took = {sym for (sym, depth), n in r["launches"].items() if n and depth == 2}
        check(took == {k.symbol for k in SERVE_KERNELS},
              f"phase 19 (b): a rank's depth-2 launches {r['launches']}")
    sv = r0["serve"]
    check(sv["counts"] == {"done": MESH_SHOTS, "failed": 0} and r1["followed"] == MESH_SHOTS
          and sv["channels"] == MESH_SHOTS * N_CHANNELS and sv["worst"] <= TOL_MESH_SERVE,
          f"phase 19 (b) serve_once {sv}, rank 1 followed {r1['followed']}")
    by_symbol = {kern.symbol: kern for kern in _build.KERNELS}
    for (sym, depth), n_k in [*r0["launches"].items(), *r1["launches"].items()]:
        kern = by_symbol[sym]
        if kern is SF.STFT_KERNEL:
            row(kern, "K1")["launches"] += n_k
        else:
            add_sweep_launches({kern: n_k}, depth, serving=True, phase="19 (b)")
    log(f"[{gpu}] phase 19 (b) two gloo ranks on one card: the 4 s shot split 2 ways "
        f"({t2} samples, {sh['k']} tiles gathered): spectrogram |err| {sh['spec']:.3g}, labels "
        f"|err| {sh['labels']:.3g} vs the world of one, enhanced bit for bit the kernels on its "
        f"spectrogram, SSIM vs the plain f32 module {sh['ssim']:.6f}; {sh['ms']:.4f} ms a shot "
        f"(CUDA events on rank 0, {LONGSHOT_ITERS} calls); services on {N_CHANNELS} x 1e6, "
        f"{N_CHANNELS // 2} ch a rank: "
        + "; ".join(f"depth {d} |err| specs {e_s:.3g} enhanced {e_e:.3g}, {ms:.4f} ms a shot"
                    for d, (e_s, e_e, ms) in sorted(r0["service"].items()))
        + f"; serve_once of {MESH_SHOTS} shots: {sv['counts']}, rank 1 followed "
        f"{r1['followed']}, persisted channels |err| {sv['worst']:.3g} vs the single service, "
        f"{sv['shots_per_sec']:.3f} shots/s (drain {sv['seconds']:.3f} s); the ranks joined "
        f"{r0['joined']:.1f} / {r1['joined']:.1f} s after their start; wall with the spawn "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")


# phase 20: multi-GPU streamed, raw-to-model and sweep training
MESH_TRAIN_EPOCHS = 2  # phase 20: the streamed fit's and train_from_raw's epochs
# phase 20 (b): each parameter tensor after the two ranks' streamed epoch on
# the bf16 kernels against the world of one's, ||err|| / ||p||.  The pair is
# first held bit for bit to the same epoch with each batch's two blocks
# summed on one card (two_block_epoch_for), in bf16 and in float32: the dp
# sum is exact, and the gap to the world of one is the regrouped sums'
# rounding, which Adam's normalised steps carry on over 57 steps.  It is
# fixed by the code: 9.13e-4 of dec_deconvs.1's norm in each of three runs
# on an H100 80GB HBM3 at 700 W (float32: 1.08e-5, enc_convs.0.bias), the
# epoch's loss within 1.1e-7.  The gate is about twice it.
TOL_MESH_PARAMS = 2e-3


def raw_traces() -> np.ndarray:
    """Phase 15 (c)'s 4 shots in memory: ``synth-shots --shots 4
    --channels 20`` (its default seed and 1e6 samples) as the (80, 1e6)
    float32 traces ``train-raw`` reads from their binaries, shot-major."""
    sp = SpecParams()
    b = synthetic_shot_batch(n_shots=RAW_SHOTS, n_channels=N_CHANNELS,
                             n_samples=1_000_000, seed=0)
    return np.ascontiguousarray(b.reshape(RAW_SHOTS * N_CHANNELS, -1)[:, :sp.n_samples])


def two_block_epoch_for(cfg: ModelConfig, dtype):
    """``dp_kernel_epoch_for``'s epoch on two ranks, emulated on one card:
    each half of a batch (a rank's block) through the training kernels,
    the two packed sums added in float32 (what an all-reduce of two ranks
    computes: one addition, which commutes), then the same scaling and
    Adam step.  Two gloo ranks must give its parameters bit for bit."""
    depth = AK.kernel_depth(cfg)
    scale = float(TK.TILE_F * TK.TILE_T)

    def epoch(state, x, y, batch_idx, batch_mask):
        x, y = TK._tiles(x), TK._tiles(y)
        named = list(state.model.named_parameters())
        losses = []
        for idx, m in zip(batch_idx, batch_mask):
            state.optimizer.zero_grad(set_to_none=True)
            tw = TK.build_train_weights(state.model, dtype, depth)
            h, flat = len(idx) // 2, 0
            for blk in (slice(0, h), slice(h, None)):
                bce, msum, grads = TK.loss_grad_sums(tw, x[idx[blk]], y[idx[blk]], m[blk])
                flat = flat + torch.cat([bce.reshape(1), msum.reshape(1),
                                         *(grads[n].reshape(-1) for n, _ in named)])
            denom = flat[1] * scale
            g = torch.ones_like(denom) / denom
            off = 2
            for _, p in named:
                p.grad = flat[off:off + p.numel()].view_as(p) * g
                off += p.numel()
            state.optimizer.step()
            state.step += 1
            losses.append(flat[0] / denom)
        return state, torch.stack(losses)

    return epoch


def mesh_train_rank(rank: int, port: int, inp: dict, go, out) -> None:
    """Phase 20 (b), one of two ranks on the one card over gloo, once
    ``go`` is set: one epoch of the streamed fit on K5
    (``dp_kernel_epoch_for``) over the phase-17 records, in bf16 and in
    float32, the envelope's 3-config grid padded to 4 on a "sweep" mesh, and ``train_from_raw`` of the raw shots on K1 and K5.
    Puts (rank, results) or (rank, "error", traceback) on ``out``."""
    import traceback

    from specenh_torch import e2e
    from specenh_torch import train_stream as TS
    from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
    from specenh_torch.parallel.mesh import make_mesh
    from specenh_torch.parallel.multihost import initialize_distributed

    t_start = time.time()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout=120)
        data = make_mesh(2, ("data",), device=inp["device"])
        sweep = make_mesh(2, ("sweep",), device=inp["device"])
        store = TileStore(inp["parts"], inp["n_channels"])
        tc = TrainConfig()
        plan = TS.plan_stream_split(store, num_samples=inp["n_shots"], cfg=tc, seed=inp["seed"])
        # warm up while (a) runs: the kernels' modules, cuDNN's and the
        # front's first calls load once, outside the timed work below
        warm = TR.create_state(FLAGSHIP, tc, device=data.device)
        xw, yw = inp["cut"][0][:2], inp["cut"][1][:2]
        TK.loss_grad_sums(TK.build_train_weights(warm.model, torch.bfloat16, 2), xw, yw,
                          torch.ones(2, device=data.device))
        with torch.no_grad():
            warm.model(xw, logits=True)
            env_cfg = SW.envelope_config(inp["grid"])
            p_w, m_w = SW.init_stacked_params(inp["grid"], env_cfg, 0, data.device)
            SW._envelope_logits({k: p_w[k] * m_w[k] for k in p_w}, env_cfg, len(inp["grid"]),
                                xw, torch.float32)
        process_shot_fn(Config(), data.device)(inp["traces"][:1])
        torch.cuda.synchronize()
        del warm, p_w, m_w
        joined = time.time()
        go.wait()
        t_go = time.perf_counter()
        res = {"joined": joined, "secs": []}

        def launches():
            return {k.symbol: k.launches for k in _build.KERNELS if k.launches}

        def zero():
            for kern in _build.KERNELS:
                kern.launches = 0

        state = TR.create_state(FLAGSHIP, tc, device=data.device)
        state.model.load_state_dict(inp["sd"])
        zero()
        with tempfile.TemporaryDirectory() as d:
            m = os.path.join(d, "m.jsonl")
            _, h = TS.fit_streaming(state, store, plan, tc, epochs=1,
                                    chunk_tiles=inp["chunk"], mesh=data, metrics_path=m,
                                    epoch_fn=dp_kernel_epoch_for(FLAGSHIP, tc, data))
            torch.cuda.synchronize()
            secs = [json.loads(ln)["sec"] for ln in open(m)] if rank == 0 else []
        # numpy, not tensors: a tensor on the queue is shared through a file
        # descriptor that dies with this process
        res["stream"] = (h, {k: v.cpu().numpy() for k, v in state.model.state_dict().items()},
                         secs, launches())
        # the same epoch on the float32 kernels
        state = TR.create_state(FLAGSHIP, tc, device=data.device)
        state.model.load_state_dict(inp["sd"])
        zero()
        _, h = TS.fit_streaming(state, store, plan, tc, epochs=1, chunk_tiles=inp["chunk"],
                                mesh=data, epoch_fn=dp_kernel_epoch_for(FLAGSHIP, tc, data,
                                                                        dtype=torch.float32))
        torch.cuda.synchronize()
        res["stream32"] = (h, {k: v.cpu().numpy() for k, v in state.model.state_dict().items()},
                           launches())
        del state, store
        res["secs"].append(round(time.perf_counter() - t_go, 1))

        t0 = time.perf_counter()
        env = SW.sweep_fit(inp["grid"], *inp["cut"], tc, epochs=1, mesh=sweep)
        torch.cuda.synchronize()
        res["sweep"] = (None if env is None else (env.train_history, env.val_history),
                        time.perf_counter() - t0)
        res["secs"].append(round(time.perf_counter() - t_go, 1))

        zero()
        torch.cuda.reset_peak_memory_stats(data.device)
        t0 = time.perf_counter()
        st, h = e2e.train_from_raw(inp["traces"].cpu().numpy(), Config(), FLAGSHIP, tc,
                                   epochs=inp["epochs"], mesh=data,
                                   epoch_fn=dp_kernel_epoch_for(FLAGSHIP, tc, data))
        torch.cuda.synchronize()
        res["raw"] = (h, time.perf_counter() - t0, launches(),
                      torch.cuda.max_memory_allocated(data.device),
                      {k: v.cpu().numpy() for k, v in st.model.state_dict().items()})
        res["secs"].append(round(time.perf_counter() - t_go, 1))
        out.put((rank, res))
        torch.distributed.destroy_process_group()
    except Exception:
        out.put((rank, "error", traceback.format_exc()))


def mesh_train_phase(dev, gpu, data, raw_host: np.ndarray) -> None:
    """Phase 20: multi-GPU streamed, raw-to-model and sweep training.
    (a) on an NCCL world of one, each against the unsharded call on the
    same weights and tiles, bit for bit in the training losses and
    parameters (val_loss, the float32 module's, within TOL_F32_REL where
    the dp eval sums it in another order), counted: ``fit_streaming(mesh=)``
    on K5 (``dp_kernel_epoch_for``) over phase 17's records
    (``TileStore``), chunks of STREAM_CHUNK, 2 epochs; ``sweep_fit_serial(mesh=)`` of the kernel
    grid k3/k5/k7 on the recipe's tiles, 1 epoch on K5; ``sweep_fit`` of
    that grid on a "sweep" world of one, float32 under cuDNN's
    deterministic algorithms, N_CUT tiles and the stand-in labels, 1
    epoch; ``train_from_raw(mesh=)`` of phase 15 (c)'s 4 shots on K1 and
    K5, 2 epochs; s/epoch of each side.  (b) one spawn of two gloo ranks on
    the one card (NCCL refuses two ranks on one GPU), their start overlapped
    with (a), warmed up meanwhile: one epoch of the streamed fit (its
    loss within rtol 1e-5 of (a)'s first, each parameter tensor within
    TOL_MESH_PARAMS of its norm; the same epoch on the float32 kernels
    against a float32 world of one's, reported; each pair's parameters bit
    for bit the epoch with each batch's two rank blocks summed on one card,
    ``two_block_epoch_for``, run in (a)), the 3-config grid padded to 4 (rank 0's
    histories within rtol 1e-4 of the unsharded run's; rank 1 returns
    None) and ``train_from_raw`` over the two ranks (each its 40
    channels; losses within TOL_DP_GLOO of (a)'s), with the bytes the
    all-gather moved and the peak device memory.  (c) ``train-raw`` and
    ``sweep --devices N`` above the visible GPUs exit with the device-count
    message.  ``raw_host`` is ``raw_traces()``, drawn beside the build.  The
    kernels line counts (a) and (b)'s launches."""
    import queue
    import socket

    import torch.multiprocessing as mp

    from specenh_torch import cli as TCLI
    from specenh_torch import e2e
    from specenh_torch import train_stream as TS
    from specenh_torch.parallel.dp_kernel import dp_kernel_epoch_for
    from specenh_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    tc = TrainConfig()
    grid = [ModelConfig(filters=(32, 32), kernels=(k, k), out_kernel=k)
            for k in SweepConfig().kernel_vals]
    xc, xvc = data.x_train[:N_CUT], data.x_tune[:N_CUT_TUNE]
    cut = (xc, (0.8 * xc + 0.1).clamp(0, 1), xvc, (0.8 * xvc + 0.1).clamp(0, 1))
    parts = [(data.x_train, data.y_train), (data.x_tune, data.y_tune),
             (data.x_test, data.y_test)]
    traces = torch.from_numpy(raw_host).to(dev)
    sd = {k: v.cpu() for k, v in TR.create_state(
        FLAGSHIP, tc, generator=torch.Generator().manual_seed(SEED),
        device=dev).model.state_dict().items()}

    # (b)'s ranks start first: their start-up overlaps (a), their work waits
    torch.cuda.synchronize()
    ctx = mp.get_context("spawn")
    q, go = ctx.Queue(), ctx.Event()
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    inp = dict(parts=parts, cut=cut, grid=grid, traces=traces, sd=sd, device=str(dev),
               n_channels=N_CHANNELS, n_shots=N_SHOTS, seed=SEED, chunk=STREAM_CHUNK,
               epochs=MESH_TRAIN_EPOCHS)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t_phase
    t_spawn, t_spawn_wall = time.perf_counter(), time.time()
    procs = [ctx.Process(target=mesh_train_rank, args=(r, port, inp, go, q)) for r in (0, 1)]
    # start() hands each child its inputs through a pipe the child reads only
    # once it has imported this script: a thread waits for that, not (a)
    starter = threading.Thread(target=lambda: [p.start() for p in procs])
    starter.start()
    try:
        # (a) an NCCL world of one against the unsharded calls
        t0 = time.perf_counter()
        mesh = make_mesh(1, device=dev)
        t_mesh = time.perf_counter() - t0
        check(mesh.backend == "nccl", f"phase 20 mesh {mesh}")
        store = TileStore(parts, N_CHANNELS)
        plan = TS.plan_stream_split(store, num_samples=N_SHOTS, cfg=tc, seed=SEED)
        n_all = sum(len(x) for x, _ in parts)
        check((plan.n_tiles("train"), plan.n_tiles("tune")) ==
              (int(n_all * 0.6), int(n_all * 0.85) - int(n_all * 0.6)),
              f"phase 20 plan {plan.n_tiles('train')}, {plan.n_tiles('tune')} of {n_all}")
        nb = -(-plan.n_tiles("train") // BATCH)

        def state():
            st = TR.create_state(FLAGSHIP, tc, device=dev)
            st.model.load_state_dict(sd)
            return st

        def gate(tag, a, b, hist=("loss",), val=True):
            """Training losses and parameters bit for bit; val_loss within
            TOL_F32_REL."""
            (sa, ha), (sb, hb) = a, b
            check(all(ha[k] == hb[k] for k in hist) and same_state(sa, sb),
                  f"phase 20 (a) {tag}: {ha} vs {hb}")
            if val:
                gap = max(abs(u - v) / v for u, v in zip(ha["val_loss"], hb["val_loss"]))
                check(gap <= TOL_F32_REL, f"phase 20 (a) {tag}: val_loss {ha} vs {hb}")

        log(f"phase 20 set-up: {time.perf_counter() - t_phase:.1f} s (inputs {t_data:.1f}, "
            f"the NCCL world of one {t_mesh:.1f})")
        a_runs, a_secs = {}, {}
        with tempfile.TemporaryDirectory() as d:
            ck = os.path.join(d, "ck")
            for tag, kw in (("unsharded", dict(epoch_fn=TR.kernel_epoch_for(FLAGSHIP, tc))),
                            ("mesh", dict(mesh=mesh, checkpoint_dir=ck,
                                          epoch_fn=dp_kernel_epoch_for(FLAGSHIP, tc, mesh)))):
                m = os.path.join(d, f"{tag}.jsonl")
                a_runs[tag], tl = counted(TS.fit_streaming, state(), store, plan, tc,
                                          epochs=MESH_TRAIN_EPOCHS, chunk_tiles=STREAM_CHUNK,
                                          metrics_path=m, **kw)
                with open(m) as fh:
                    a_secs[tag] = [json.loads(ln)["sec"] for ln in fh]
                check(tl.get(TK.TRAIN_LOSS, 0) == nb * MESH_TRAIN_EPOCHS,
                      f"phase 20 (a) streamed {tag}: {tl.get(TK.TRAIN_LOSS, 0)} steps")
                add_sweep_launches(tl, 2, serving=False, phase="20")
            # (b) trains one epoch: it is held to the mesh run's first
            epoch1 = torch.load(os.path.join(ck, "epoch_0000", "state.pt"),
                                weights_only=True)["model"]
        gate("fit_streaming(mesh=)", a_runs["mesh"], a_runs["unsharded"])
        stream_hist = a_runs["mesh"][1]
        stream_params = {k: v.cpu().numpy() for k, v in epoch1.items()}
        log(f"[{gpu}] phase 20 (a) fit_streaming K5, NCCL world of one, {MESH_TRAIN_EPOCHS} "
            f"epochs of {plan.n_tiles('train')} tiles in chunks of {STREAM_CHUNK}: losses "
            f"{stream_hist['loss']} == the unsharded stream's, parameters bit for bit, val_loss "
            f"{stream_hist['val_loss']} (unsharded {a_runs['unsharded'][1]['val_loss']}); "
            f"s/epoch mesh {a_secs['mesh']} against unsharded {a_secs['unsharded']} (this run)")
        # (b)'s float32 epoch is held to a float32 world of one's
        t0 = time.perf_counter()
        (st32, h32), tl = counted(TS.fit_streaming, state(), store, plan, tc, epochs=1,
                                  chunk_tiles=STREAM_CHUNK, mesh=mesh,
                                  epoch_fn=dp_kernel_epoch_for(FLAGSHIP, tc, mesh,
                                                               dtype=torch.float32))
        check(tl.get(TK.TRAIN_LOSS, 0) == nb, f"phase 20 (a) float32 stream: "
              f"{tl.get(TK.TRAIN_LOSS, 0)} steps")
        add_sweep_launches(tl, 2, serving=False, phase="20")
        stream32 = (h32["loss"], {k: v.cpu().numpy() for k, v in st32.model.state_dict().items()})
        log(f"[{gpu}] phase 20 (a) fit_streaming on the float32 K5 kernels, NCCL world of one, "
            f"1 epoch: loss {h32['loss']}, {time.perf_counter() - t0:.2f} s")
        # and each dtype's two-rank epoch emulated on this card (two_block_epoch_for)
        two_block = {}
        for dt in (torch.bfloat16, torch.float32):
            (st2, h2), tl = counted(TS.fit_streaming, state(), store, plan, tc, epochs=1,
                                    chunk_tiles=STREAM_CHUNK,
                                    epoch_fn=two_block_epoch_for(FLAGSHIP, dt))
            add_sweep_launches(tl, 2, serving=False, phase="20")
            two_block[dt] = (h2["loss"], {k: v.cpu().numpy()
                                          for k, v in st2.model.state_dict().items()})
        del a_runs, store, st32, st2
        log(f"phase 20 (a) streamed: {time.perf_counter() - t_phase:.1f} s")

        ser, ser_s = {}, {}
        for tag, kw in (("unsharded", dict(device=dev)), ("mesh", dict(mesh=mesh))):
            t0 = time.perf_counter()
            ser[tag], tl = counted(SW.sweep_fit_serial, grid, data.x_train, data.y_train,
                                   data.x_tune, data.y_tune, tc, epochs=1, **kw)
            ser_s[tag] = time.perf_counter() - t0
            check(tl.get(TK.TRAIN_LOSS, 0) == len(grid) * -(-len(data.x_train) // BATCH),
                  f"phase 20 (a) serial sweep {tag}: {tl.get(TK.TRAIN_LOSS, 0)} steps")
            add_sweep_launches(tl, 2, serving=False, phase="20")
        a, b = ser["mesh"], ser["unsharded"]
        val_gap = float(np.max(np.abs(a.val_history - b.val_history) / b.val_history))
        check(np.array_equal(a.train_history, b.train_history) and val_gap <= TOL_F32_REL
              and all(torch.equal(a.stacked_params[k], v) for k, v in b.stacked_params.items()),
              f"phase 20 (a) sweep_fit_serial(mesh=): {a.train_history} vs {b.train_history}")
        log(f"[{gpu}] phase 20 (a) sweep_fit_serial(mesh=), k3/k5/k7 x 1 epoch on "
            f"{len(data.x_train)} tiles, K5 bf16 through dp_fit: train losses and stacked "
            f"parameters == the unsharded sweep's bit for bit, val_loss relative gap "
            f"{val_gap:.3g}; s/epoch of the grid mesh {ser_s['mesh']:.3f} against unsharded "
            f"{ser_s['unsharded']:.3f} (this run)")
        del ser
        log(f"phase 20 (a) serial sweep: {time.perf_counter() - t_phase:.1f} s")

        mesh_s = make_mesh(1, ("sweep",), device=dev)
        env, env_s = {}, {}
        with cudnn_deterministic():
            for tag, kw in (("unsharded", dict(device=dev)), ("mesh", dict(mesh=mesh_s))):
                t0 = time.perf_counter()
                env[tag], tl = counted(SW.sweep_fit, grid, *cut, tc, epochs=1, **kw)
                env_s[tag] = time.perf_counter() - t0
                check(not tl, f"phase 20 (a) envelope: launched {[k.symbol for k in tl]}")
        a, b = env["mesh"], env["unsharded"]
        check(np.array_equal(a.train_history, b.train_history)
              and np.array_equal(a.val_history, b.val_history)
              and all(torch.equal(a.stacked_params[k], v) for k, v in b.stacked_params.items()),
              f"phase 20 (a) sweep_fit on a sweep mesh: {a.val_history} vs {b.val_history}")
        log(f"[{gpu}] phase 20 (a) sweep_fit f32 (cuDNN deterministic) on a \"sweep\" world "
            f"of one, k3/k5/k7 x 1 epoch on {N_CUT} tiles: histories and stacked parameters "
            f"== the unsharded envelope's bit for bit (val_loss {b.val_losses.tolist()}); "
            f"s/epoch mesh {env_s['mesh']:.3f} against unsharded {env_s['unsharded']:.3f}")

        log(f"phase 20 (a) envelope: {time.perf_counter() - t_phase:.1f} s")
        raw, raw_s = {}, {}
        for tag, kw in (("unsharded", dict(device=dev,
                                           epoch_fn=TR.kernel_epoch_for(FLAGSHIP, tc))),
                        ("mesh", dict(mesh=mesh,
                                      epoch_fn=dp_kernel_epoch_for(FLAGSHIP, tc, mesh)))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            raw[tag], tl = counted(e2e.train_from_raw, raw_host, Config(), FLAGSHIP, tc,
                                   epochs=MESH_TRAIN_EPOCHS, **kw)
            raw_s[tag] = (time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev) - base)
            check(tl.pop(SF.STFT_KERNEL, 0) == 1, f"phase 20 (a) train_from_raw {tag}: K1")
            row(SF.STFT_KERNEL, "K1")["launches"] += 1
            n_train = int(RAW_SHOTS * N_CHANNELS * 30 * tc.split_fracs[0])
            check(tl.get(TK.TRAIN_LOSS, 0) == MESH_TRAIN_EPOCHS * -(-n_train // BATCH),
                  f"phase 20 (a) train_from_raw {tag}: {tl.get(TK.TRAIN_LOSS, 0)} steps")
            add_sweep_launches(tl, 2, serving=False, phase="20")
        gate("train_from_raw(mesh=)", raw["mesh"], raw["unsharded"])
        n_tiles = RAW_SHOTS * N_CHANNELS * 30
        gathered = 2 * n_tiles * 256 * 128 * 4
        log(f"[{gpu}] phase 20 (a) train_from_raw(mesh=) of {RAW_SHOTS} shots x {N_CHANNELS} "
            f"channels on K1 and K5, NCCL world of one, {MESH_TRAIN_EPOCHS} epochs: losses "
            f"{raw['mesh'][1]['loss']} == the unsharded run's, parameters bit for bit, val_loss "
            f"{raw['mesh'][1]['val_loss']}; wall {raw_s['mesh'][0]:.2f} s against "
            f"{raw_s['unsharded'][0]:.2f} s (host clock, the front included); peak device "
            f"memory {raw_s['mesh'][1] / 2**30:.3f} GiB above what was held (unsharded "
            f"{raw_s['unsharded'][1] / 2**30:.3f}); the all-gather of {n_tiles} tile pairs "
            f"({gathered / 1e9:.3f} GB) moves nothing between cards in a world of one")
        mesh.close()

        log(f"phase 20 (a): {time.perf_counter() - t_phase:.1f} s")

        # (b) the two gloo ranks
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # room for the children's working sets
        starter.join()
        t_go = time.perf_counter()
        go.set()
        results, deadline = {}, time.perf_counter() + 300
        while len(results) < len(procs):
            try:
                r = q.get(timeout=2)
                results[r[0]] = r
            except queue.Empty:
                gone = [k for k, p in enumerate(procs) if p.exitcode is not None
                        and k not in results]
                check(not gone, f"phase 20 (b): rank(s) {gone} exited with no result "
                      f"(exit codes {[procs[k].exitcode for k in gone]})")
                check(time.perf_counter() < deadline, "phase 20 (b): no result in 300 s")
    finally:
        go.set()
        starter.join()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    for r in results.values():
        check(r[1] != "error", f"phase 20 (b) rank {r[0]} failed:\n{r[-1]}")
    r0, r1 = results[0][1], results[1][1]
    by_symbol = {kern.symbol: kern for kern in _build.KERNELS}

    def count(launches, tag):
        for sym, n_k in launches.items():
            kern = by_symbol[sym]
            if kern is SF.STFT_KERNEL:
                row(kern, "K1")["launches"] += n_k
            else:
                add_sweep_launches({kern: n_k}, 2, serving=False, phase=f"20 (b) {tag}")

    def stream_gap(tag, got, ref_loss, ref_params, tol=None):
        """The two ranks' streamed epoch (equal on both) against the world
        of one's: the loss within 1e-5 relative, each parameter tensor
        within ``tol`` of its norm where given; returns (loss gap, worst
        tensor gap, worst max |err|)."""
        (h_0, p_0, *_), (h_1, p_1, *_) = got
        check(h_0["loss"] == h_1["loss"] and all(np.array_equal(p_0[k], p_1[k]) for k in p_0),
              f"phase 20 (b) {tag}: the ranks differ")
        rel_ = abs(h_0["loss"][0] - ref_loss) / ref_loss
        errs = {k: float(np.abs(p_0[k] - v).max()) for k, v in ref_params.items()}
        p_rel = {k: float(np.linalg.norm(p_0[k] - v) / np.linalg.norm(v))
                 for k, v in ref_params.items()}
        log(f"phase 20 (b) {tag}: loss {h_0['loss']} (world of one {ref_loss}), parameters' "
            f"max |err| per tensor against the world of one's epoch 1 " + ", ".join(
                f"{k} {e:.3g} (of max |p| {float(np.abs(ref_params[k]).max()):.3g}; "
                f"||err|| / ||p|| {p_rel[k]:.3g})" for k, e in errs.items()))
        gap = max(p_rel.values())
        check(rel_ <= 1e-5 and (tol is None or gap <= tol), f"phase 20 (b) {tag} loss "
              f"{h_0['loss']} vs {ref_loss}, parameters ||err|| / ||p|| {gap:.3g} (gate {tol})")
        return rel_, gap, max(errs.values())

    h0, secs, la0, la1 = r0["stream"][0], r0["stream"][2], r0["stream"][3], r1["stream"][3]
    for key, dt in (("stream", torch.bfloat16), ("stream32", torch.float32)):
        (h_0, p_0, *_), (loss2, p2) = r0[key], two_block[dt]
        diff = [k for k in p2 if not np.array_equal(p_0[k], p2[k])]
        emu = {k: float(np.linalg.norm(p2[k] - v) / np.linalg.norm(v))
               for k, v in (stream_params if key == "stream" else stream32[1]).items()}
        log(f"phase 20 (b) {dt}: the pair against the two-block epoch on one card: loss "
            f"{h_0['loss']} vs {loss2}, tensors differing {diff}; the two-block epoch against "
            f"the world of one, ||err|| / ||p|| per tensor "
            + ", ".join(f"{k} {v:.3g}" for k, v in emu.items()))
        check(h_0["loss"] == loss2 and not diff,
              f"phase 20 (b) {dt}: the gloo pair is not the two-block epoch bit for bit")
    rel, p_gate, p_err = stream_gap("streamed epoch, bf16 kernels", (r0["stream"], r1["stream"]),
                                    stream_hist["loss"][0], stream_params, TOL_MESH_PARAMS)
    rel32, p_gate32, p_err32 = stream_gap("streamed epoch, float32 kernels",
                                          (r0["stream32"], r1["stream32"]), stream32[0][0],
                                          stream32[1])
    for la in (la0, la1, r0["stream32"][2], r1["stream32"][2]):
        count(la, "streamed")
    log(f"phase 20 (b): ranks' seconds {r0['secs']} / {r1['secs']}")
    (env0, env_t0), (env1, env_t1) = r0["sweep"], r1["sweep"]
    check(env1 is None and env0 is not None, "phase 20 (b) sweep: rank 1 returned a result")
    ref = env["unsharded"]
    env_rel = max(float(np.max(np.abs(g - w) / w)) for g, w in
                  zip(env0, (ref.train_history, ref.val_history)))
    check(env0[0].shape == ref.train_history.shape and env_rel <= 1e-4,
          f"phase 20 (b) sweep histories {env0} vs {ref.train_history}, {ref.val_history}")
    (rh0, rt0, rl0, rm0, rp0), (rh1, rt1, rl1, rm1, rp1) = r0["raw"], r1["raw"]
    raw_rel = max(abs(u - v) / v for u, v in zip(rh0["loss"], raw["mesh"][1]["loss"]))
    check(rh0["loss"] == rh1["loss"] and all(np.array_equal(rp0[k], rp1[k]) for k in rp0)
          and raw_rel <= TOL_DP_GLOO,
          f"phase 20 (b) train_from_raw losses {rh0['loss']} vs {raw['mesh'][1]['loss']}")
    for la in (rl0, rl1):
        check(la.get(SF.STFT_KERNEL.symbol) == 1, f"phase 20 (b) train_from_raw K1 {la}")
        count(la, "train_from_raw")
    log(f"[{gpu}] phase 20 (b) two gloo ranks on one card (ready {r0['joined'] - t_spawn_wall:.1f}"
        f" / {r1['joined'] - t_spawn_wall:.1f} s after the spawn, overlapped with (a)): the "
        f"streamed fit, K5, "
        f"1 epoch, loss {h0['loss']} (world of one {stream_hist['loss'][:1]}; relative "
        f"{rel:.3g}, gate 1e-5), parameters ||err|| / ||p|| at most {p_gate:.3g} a tensor "
        f"(gate {TOL_MESH_PARAMS:g}; max |err| {p_err:.3g}); on the float32 kernels against a "
        f"float32 world of one, loss relative {rel32:.3g}, parameters ||err|| / ||p|| at most "
        f"{p_gate32:.3g} a tensor (max |err| {p_err32:.3g}); both pairs bit for bit the "
        f"two-block epoch on one card, "
        f"s/epoch {secs}; the envelope's grid padded to 4, "
        f"2 configs a rank: rank 0's histories within {env_rel:.3g} relative of the unsharded "
        f"run (gate 1e-4), rank 1 None, {env_t0:.2f} / {env_t1:.2f} s; train_from_raw, "
        f"{N_CHANNELS * RAW_SHOTS // 2} channels a rank: losses {rh0['loss']} (world of one "
        f"{raw['mesh'][1]['loss']}; relative {raw_rel:.3g}, gate {TOL_DP_GLOO:g}), "
        f"{rt0:.2f} / {rt1:.2f} s, the all-gather moved {gathered / 2 / 1e9:.3f} GB into each "
        f"rank through the host (gloo), peak device memory {rm0 / 2**30:.3f} / "
        f"{rm1 / 2**30:.3f} GiB; wall from go {time.perf_counter() - t_go:.1f} s, from the "
        f"spawn {time.perf_counter() - t_spawn:.1f} s")

    # (c) more devices than are visible: the device-count message
    ask = max(2, torch.cuda.device_count() + 1)
    want = (f"--devices {ask}: requested {ask} devices but only "
            f"{torch.cuda.device_count()} available")
    with tempfile.TemporaryDirectory() as d:
        for argv in (["train-raw", "--data-dir", d, "--out-dir", d],
                     ["sweep", "--dataset", os.path.join(d, "none.hdf5"), "--out-dir", d]):
            try:
                TCLI.main([*argv, "--devices", str(ask), "--quiet"])
                raise AssertionError(f"phase 20 (c): {argv[0]} --devices did not exit")
            except SystemExit as e:
                check(str(e) == want, f"phase 20 (c): exit {e!r}, expected {want!r}")
    log(f"phase 20 (c): train-raw and sweep --devices {ask} exit: {want}")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")

# phase 21: the headline benchmark through the CLI
HEADLINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "train_s_per_epoch", "train_tiles_per_sec",
    "train_s_per_epoch_f32", "train_s_per_epoch_bf16", "train_s_per_epoch_kernel",
    "train3_s_per_epoch_f32", "train3_s_per_epoch_kernel", "svd_specs_per_sec",
    "svd_compute_specs_per_sec", "serve3_ms_per_shot", "longshot4s_ms",
    "stream_host_tiles_per_sec", "stream_host_gbps")  # the JAX headline's, in its order
HEADLINE_GATES = ("# spectrogram SSIM vs CPU reference: ",
                  "# enhanced-output SSIM vs f32 service: ",
                  "# SVD denoise SSIM vs numpy reference: ",
                  "# SVD compute_signal SSIM vs numpy reference: ")


def headline_phase(dev, gpu) -> None:
    """Phase 21: ``python -m specenh_torch.cli bench`` in process (the
    parser, the dispatch and ``bench.headline.main`` on the card), its
    stdout and stderr captured: one JSON line with the JAX headline's 17
    keys in order, each number finite and > 0, the four gates' lines,
    ``value`` and ``vs_baseline`` from ``measure_card``'s spectrograms/s
    and the cached baseline; the launches of each measure, counted by
    wrapping the module's functions (and each training kernel epoch by its
    depth): the flagship service's 1 + 3 + 20 bf16 calls and 1 float32
    call, deep3's 26, the long shot's 50 (its STFT is the matmul front),
    the K5 and K7 epochs' steps, every K5 and K7 entry point, nothing else.
    Prints the line after ``headline:``; the kernels line counts these
    launches."""
    from specenh_torch import cli as TCLI

    t_phase = time.perf_counter()
    per, results = {}, {}

    def launched():
        return {kern: kern.launches for kern in _build.KERNELS}

    def tally(key, before):
        now = launched()
        acc = per.setdefault(key, {})
        for kern, n in now.items():
            if n > before[kern]:
                acc[kern] = acc.get(kern, 0) + n - before[kern]

    def wrapped(name, fn):
        def call(*a, **kw):
            before = launched()
            results[name] = out = fn(*a, **kw)
            tally(name, before)
            return out
        return call

    def kernel_epoch_for(cfg, tc, *a, **kw):
        epoch = saved["kernel_epoch_for"](cfg, tc, *a, **kw)

        def counted_epoch(*args):
            before = launched()
            out = epoch(*args)
            tally(f"train depth {cfg.depth}", before)
            return out
        return counted_epoch

    names = ("measure_card", "measure_train", "measure_svd", "measure_deep3_serving",
             "measure_longshot", "measure_stream_host")
    saved = {n: getattr(HL, n) for n in (*names, "kernel_epoch_for")}
    out, err = io.StringIO(), io.StringIO()
    try:
        for n in names:
            setattr(HL, n, wrapped(n, saved[n]))
        HL.kernel_epoch_for = kernel_epoch_for
        for kern in _build.KERNELS:
            kern.launches = 0
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            TCLI.main(["bench"])
        torch.cuda.synchronize()
        total = {kern: kern.launches for kern in _build.KERNELS if kern.launches}
    finally:
        for n, f in saved.items():
            setattr(HL, n, f)
        for ln in err.getvalue().splitlines():
            log(f"phase 21 stderr: {ln}")
    wall = time.perf_counter() - t_phase
    lines = out.getvalue().splitlines()
    check(len(lines) == 1, f"phase 21: cli bench printed {len(lines)} lines: {lines}")
    rec = json.loads(lines[0])
    check(tuple(rec) == HEADLINE_KEYS, f"phase 21: keys {list(rec)}")
    nums = {k: v for k, v in rec.items() if k not in ("metric", "unit")}
    check(all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0 for v in nums.values()),
          f"phase 21: a value is not finite and > 0: {nums}")
    for g in HEADLINE_GATES:
        check(g in err.getvalue(), f"phase 21: no gate line {g!r}")
    with open(HL.BASELINE_CACHE) as fh:
        cpu = json.load(fh)["spectrograms_per_sec_cpu"]
    card = results["measure_card"]
    check(rec["value"] == round(card, 2) and rec["vs_baseline"] == round(card / cpu, 2),
          f"phase 21: value {rec['value']}, vs_baseline {rec['vs_baseline']} from "
          f"{card} spectrograms/s and the cached {cpu}")

    # the launches: each measure's, all of them attributed
    nb = -(-7200 // BATCH)

    def stages(calls, depth):
        return {AK.TILE_IN: calls, AK.CONV_POOL: calls * (depth - 1), AK.CONVT: calls * depth,
                AK.TILE_OUT: calls}

    want = {"measure_card": {SF.STFT_KERNEL: 25, **stages(25, 2)},
            "measure_deep3_serving": {SF.STFT_KERNEL: 26, **stages(26, 3)},
            "measure_longshot": stages(50, 2)}
    for key, w in want.items():
        check(per.get(key) == w, f"phase 21 {key}: launches "
              f"{ {k.symbol: v for k, v in per.get(key, {}).items()} }, expected "
              f"{ {k.symbol: v for k, v in w.items()} }")
    for depth, epochs in ((2, 6), (3, 4)):
        tl = per.get(f"train depth {depth}", {})
        kerns = set(TK.TRAIN_KERNELS if depth == 2 else TRAIN3_KERNELS) - set(K5B_KERNELS)
        check(set(tl) == kerns | {AK.CONVT} and tl[TK.TRAIN_LOSS] == epochs * nb
              and tl[TK.TRAIN_SUM] == epochs * nb,
              f"phase 21 training depth {depth}: {[(k.symbol, v) for k, v in tl.items()]}")
    for key in ("measure_svd", "measure_stream_host"):
        check(not per.get(key), f"phase 21 {key} launched {per.get(key)}")
    check(per["measure_train"] == {k: per["train depth 2"].get(k, 0)
                                   + per["train depth 3"].get(k, 0)
                                   for k in per["measure_train"]},
          "phase 21: measure_train launched outside its kernel epochs")
    attributed = {}
    for key in ("measure_card", "measure_deep3_serving", "measure_longshot", "measure_train"):
        for kern, n in per[key].items():
            attributed[kern] = attributed.get(kern, 0) + n
    check(attributed == total, "phase 21: launches outside the measures")

    for key, depth in (("measure_card", 2), ("measure_deep3_serving", 3),
                       ("measure_longshot", 2)):
        tl = dict(per[key])
        row(SF.STFT_KERNEL, "K1")["launches"] += tl.pop(SF.STFT_KERNEL, 0)
        add_sweep_launches(tl, depth, serving=True, phase="21")
    for depth in (2, 3):
        add_sweep_launches(per[f"train depth {depth}"], depth, serving=False, phase="21")
    log(f"[{gpu}] phase 21 cli bench: 17 keys, the four gates passed, {wall:.1f} s; launches "
        + "; ".join(f"{key}: " + ", ".join(f"{k.symbol}={v}" for k, v in tl.items())
                    for key, tl in per.items() if tl))
    log("headline: " + lines[0])


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

    laps = [time.perf_counter()]

    def lap(tag: str) -> None:
        laps.append(time.perf_counter())
        log(f"{tag}: {laps[-1] - laps[-2]:.1f} s")

    # the build runs nvcc in threads; the shots the phases use are drawn
    # on the host meanwhile
    built, sp = {}, SpecParams()

    def build():
        try:
            built["secs"] = _build.build_all()
        except BaseException as e:  # re-raised below, after the join
            built["error"] = e

    build_thread = threading.Thread(target=build)
    build_thread.start()
    for seed in (0, 1, 2):
        shot(sp, N_CHANNELS, seed)
    campaign = recipe_shots(sp)
    raw = raw_traces()  # phase 20's
    t_shots = time.perf_counter() - laps[0]
    build_thread.join()
    if "error" in built:
        raise built["error"]
    secs = built["secs"]
    lap(f"phase 2: the build {max(secs.values()):.1f} s, the host's shots {t_shots:.1f} s "
        "beside it, in all")
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

    traces = torch.from_numpy(shot(sp, N_CHANNELS, SEED)).to(dev)
    err_k1 = check_stft(sp, traces)
    specs = SF.spectrogram_fused(traces, sp)
    run, model = serve_family(
        dev, sp, gpu, FLAGSHIP, specs, (torch.bfloat16,),
        (("flagship k3", N_CHANNELS, FLAGSHIP),
         ("k7", 1, ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7))),
         ("manual (64,32)/k5", 1, ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)),
                                              out_kernel=(5, 5)))))
    lap("phases 3-5")
    check_tile_in_out(dev, sp, traces, specs)
    lap("phase 3, S1 and S4 at ten geometries")
    row(SF.STFT_KERNEL, "K1").update(launches=run["launches"][SF.STFT_KERNEL],
                                     max_abs_err=err_k1, **time_stft(sp, gpu, traces))
    fused_front(dev, sp, gpu, traces, model, run)
    del run
    lap("phase 12")
    serve_family(
        dev, sp, gpu, DEEP3, specs, (torch.bfloat16, torch.float32),
        (("deep3 (16,32,64)/k5", N_CHANNELS, DEEP3),
         ("(64,32,64)/k7", 1, ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3,
                                          out_kernel=(7, 7)))))
    lap("phase 6")
    serve_module_route(dev, sp, gpu)
    del traces, specs
    lap("phase 13")

    k1_build = dataset_build(dev, sp, gpu)
    lap("phase 7a")
    data, k1_data = make_data(dev, sp, campaign)
    del campaign
    lap("phase 7")
    row(SF.STFT_KERNEL, "K1")["launches"] += k1_build + k1_data
    train_family(dev, gpu, FLAGSHIP, data,
                 (("k5", ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5))),
                  ("k7", ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7))),
                  ("manual (64,32)/k5", ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)),
                                                    out_kernel=(5, 5)))),
                 EPOCHS, TK.kernel_value_and_grad, TK.build_train_weights)
    lap("phases 8-10")
    train_family(dev, gpu, DEEP3, data,
                 (("(64,32,64)/k7", ModelConfig(filters=(64, 32, 64), kernels=((7, 7),) * 3,
                                                out_kernel=(7, 7))),
                  ("(48,48,64)/k3", ModelConfig(filters=(48, 48, 64), kernels=((3, 3),) * 3,
                                                out_kernel=(3, 3)))),
                 EPOCHS3, TK3.kernel_value_and_grad3, TK3.build_train3_weights)
    lap("phase 11")
    sweep_phase(dev, gpu, data)
    stream_phase(dev, gpu, data)
    dp_phase(dev, gpu, data)
    mesh_train_phase(dev, gpu, data, raw)
    del data
    lap("phases 14, 17, 18 (b)-(e) and 20")
    keras_phase(dev, sp)
    lap("phase 18 (a)")
    with tempfile.TemporaryDirectory() as work:
        analyses_phase(dev, gpu, work)
        serve_phase(dev, gpu, work, secs)
    mesh_phase(dev, gpu)
    lap("phases 15, 16, 19")
    headline_phase(dev, gpu)
    lap("phase 21")

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
