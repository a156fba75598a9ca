#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, on a machine with an H100

Phases, each of which raises on failure (no CPU fallback, nothing caught):

1. the device: a CUDA device must be present; prints its name and power
   limit and turns TF32 off, so the plain float32 references are float32;
2. builds every kernel from ``specenh_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch twin at the serving path's shapes
   (a 20-channel, 2 s shot; the flagship AE), and the whole AE in float32
   and bf16, plus the k7 and (64, 32)/k5 geometries on one channel;
4. the service ``make_enhance_shot_fn(dtype=bfloat16)`` on three synthetic
   shots, with the repo's two gates: spectrogram SSIM >= 0.99 against the
   SciPy recipe, enhanced SSIM >= 0.999 against the plain float32 service
   on every channel; every kernel must have launched during it;
5. CUDA-event timings of each kernel and its twin, ms/shot, spectrograms/s
   and peak device memory;
6. (phase 2 builds ``ae_train.cu`` with the others and prints its ptxas
   registers and spills) the training data: 20 synthetic shots x 20
   channels through the STFT kernel and ``patch``, 12 000 tiles split
   60/25/15, stand-in labels clip(0.8 x + 0.1, 0, 1), all on the card;
7. each training kernel (K5 and K5b entry points) against its plain twin,
   stage by stage on the same inputs, on one 128-tile batch of the
   flagship in bf16 and float32, and k5, k7 and (64, 32)/k5 on 4 tiles;
8. the kernels' loss and gradients against torch autograd of the module;
9. ``train.fit`` on the reference recipe: 3 epochs on the kernel engine
   (bf16, K5), 1 epoch of K5 and 1 of K5b (``pre_layout=True``) from the
   same weights, which must agree bit for bit, then 3 epochs on the
   autograd engine in float32; gated on the loss curves, and every
   training kernel must have launched in the kernel runs;
10. timings: each training kernel per 128-tile step beside its twin, the
   one PyTorch call that computes the same function and its bound; s/epoch,
   tiles/s and the peak memory of a step for each engine.

Prints a JSON line of the kernels, the card's name and power limit, then as
its last line ``{"ok": true, "device": {...}}``.  Weights are
glorot-initialised from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from specenh_torch import ModelConfig, SpecParams, TrainConfig, _build
from specenh_torch.bench.harness import (enhance_shot_plain, example_shot,
                                         make_enhance_shot_fn, time_cuda)
from specenh_torch.bench.reference import spectrogram_ref, ssim
from specenh_torch.data.dataset import split_tiles, synthetic_shot_batch
from specenh_torch.data.tiles import patch
from specenh_torch.models.autoencoder import convt_pad_before, make_model
from specenh_torch.ops import ae_kernel as AK
from specenh_torch.ops import ae_train_kernel as TK
from specenh_torch.ops import stft_fused as SF
from specenh_torch import train as TR

N_CHANNELS = 20
SEED = 0
# K1: float32 FMA in another order than cuBLAS; near psd*w ~ eps a relative
# error of the DFT sum shows up as an absolute error of the log.
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

# training
N_SHOTS = 20         # hyperparam_scan.py:176-184: 20 shots x 20 channels
EPOCHS = 3
BATCH = 128          # one step of the recipe
TOL_GRAD_SUM = 1e-4  # a gradient sum vs its twin on the same inputs: f32 order
TOL_F32_REL = 1e-5   # a float32 stage vs its twin, relative to its scale
TOL_MASK_FRAC = 1e-4  # routing / relu masks may differ only on ties and zeros
TOL_AUTOGRAD_F32 = 1e-4  # float32 kernel gradients vs autograd, of max |g|
TOL_AUTOGRAD_BF16 = 5e-2  # bf16 kernel gradients vs f32 autograd, of max |g|
# bf16 kernel loss per epoch vs the f32 autograd run, relative: > 10x the
# spread seen on the card, well under the 2.2 % by which a model whose
# parameters were never updated is off in epoch 1
TOL_LOSS_CURVE = 1e-3
# the card's peaks (NVIDIA H100 SXM data sheet, dense): operands' type -> FLOP/s
PEAK = {torch.bfloat16: (989e12, "bf16 tensor 989 TFLOP/s"),
        torch.float32: (67e12, "fp32 67 TFLOP/s")}
HBM = 3.35e12

_AE, _TR = "specenh_torch/csrc/ae.cu", "specenh_torch/csrc/ae_train.cu"
_K5, _K5B = "specenh/ops/ae_train_kernel.py:745", "specenh/ops/ae_train_kernel.py:819"
SERVE_KERNELS = (SF.STFT_KERNEL, AK.TILE_IN, AK.CONV_POOL, AK.CONVT, AK.TILE_OUT)
REPLACES = {
    SF.STFT_KERNEL: ("specenh_torch/csrc/stft.cu", "specenh/ops/stft_fused.py:198"),
    AK.TILE_IN: (_AE, "specenh/ops/parity_turn.py:131"),
    AK.CONV_POOL: (_AE, "specenh/ops/ae_kernel.py:534"),
    AK.CONVT: (_AE, "specenh/ops/ae_kernel.py:534"),
    AK.TILE_OUT: (_AE, "specenh/ops/parity_turn.py:224"),
    TK.TRAIN_IN: (_TR, _K5), TK.TRAIN_IN_PRE: (_TR, _K5B),
    TK.TRAIN_CONV_POOL: (_TR, _K5), TK.TRAIN_LOSS: (_TR, _K5),
    TK.TRAIN_LOSS_PRE: (_TR, _K5B), TK.DGRAD_CONV: (_TR, _K5),
    TK.DGRAD_CONVT: (_TR, _K5), TK.WGRAD: (_TR, _K5), TK.WGRAD_X: (_TR, _K5),
    TK.TRAIN_SUM: (_TR, _K5),
}


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


def check_kernels(dev, sp, cfg, traces):
    """Phase 3: every kernel against its plain twin; returns the inputs
    each kernel saw on the serving path and its max |err|."""
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

    gen = torch.Generator().manual_seed(SEED)
    model = make_model(cfg, generator=gen, device=dev).eval()
    k = sp.n_frames // 128
    wts = AK.build_kernel_weights(model, torch.bfloat16)
    x1 = AK.ae_tile_in(wts, specs, k)
    x2 = AK.ae_conv_pool(wts, x1)
    x3 = AK.ae_convt(wts, x2, 2)
    x4 = AK.ae_convt(wts, x3, 3)
    y = AK.ae_tile_out(wts, x4, k)
    errs = {
        AK.TILE_IN: check_bf16_stage("ae_tile_in", x1, AK.ae_tile_in_plain(wts, specs, k)),
        AK.CONV_POOL: check_bf16_stage("ae_conv_pool", x2, AK.ae_conv_pool_plain(wts, x1)),
        AK.CONVT: max(check_bf16_stage("ae_convt 2", x3, AK.ae_convt_plain(wts, x2, 2)),
                      check_bf16_stage("ae_convt 3", x4, AK.ae_convt_plain(wts, x3, 3))),
    }
    errs[AK.TILE_OUT] = max_err(y, AK.ae_tile_out_plain(wts, x4, k))
    check(errs[AK.TILE_OUT] <= TOL_F32, f"ae_tile_out |err| {errs[AK.TILE_OUT]:.3g}")
    for kern, e in errs.items():
        log(f"{kern.symbol} (bf16, {tuple(specs.shape)} specs): max|err| {e:.3g}")
    errs[SF.STFT_KERNEL] = err_k1
    stage_inputs = dict(specs=specs, x1=x1, x2=x2, x3=x3, x4=x4, k=k, wts=wts)

    for name, c, gcfg in (
        ("flagship k3", traces.shape[0], cfg),
        ("k7", 1, ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7))),
        ("manual (64,32)/k5", 1, ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)),
                                             out_kernel=(5, 5))),
    ):
        m = model if gcfg == cfg else make_model(gcfg, generator=gen, device=dev).eval()
        s = specs[:c]
        with torch.no_grad():
            want = AK.ae_kernel_enhance_specs_plain(m, s, k)
        e32 = max_err(AK.ae_kernel_enhance_specs(AK.build_kernel_weights(m, torch.float32), s, k), want)
        d16 = (AK.ae_kernel_enhance_specs(AK.build_kernel_weights(m, torch.bfloat16), s, k)
               - want).abs()
        e16, m16 = float(d16.max()), float(d16.mean())
        log(f"AE {name}, {c} ch: f32 max|err| {e32:.3g} (tol {TOL_F32}); bf16 max|err| "
            f"{e16:.3g} mean {m16:.3g} (tol {TOL_BF16_MAX}, {TOL_BF16_MEAN})")
        check(e32 <= TOL_F32, f"AE {name} f32 |err| {e32:.3g}")
        check(e16 <= TOL_BF16_MAX and m16 <= TOL_BF16_MEAN, f"AE {name} bf16 |err| {e16:.3g}/{m16:.3g}")
    return model, errs, stage_inputs


def run_service(dev, sp, cfg, model, n_channels):
    """Phase 4: the bf16 service on three shots, gated; returns the launch
    counts of that run."""
    fn = make_enhance_shot_fn(cfg, sp, dtype=torch.bfloat16, device=dev)
    wts = fn.prepare(model)
    shots = [example_shot(sp, n_channels, seed) for seed in (0, 1, 2)]
    traces = [torch.from_numpy(s).to(dev) for s in shots]
    for kern in _build.KERNELS:
        kern.launches = 0
    outs = [fn(wts, t) for t in traces]
    torch.cuda.synchronize(dev)
    launches = {kern: kern.launches for kern in _build.KERNELS}
    for kern in SERVE_KERNELS:
        check(launches[kern] > 0, f"{kern.symbol} was not launched by the service")
    log("service launches: " + ", ".join(f"{k.symbol}={launches[k]}" for k in SERVE_KERNELS))
    k = sp.n_frames // 128
    for seed, host, t, (specs, enh) in zip((0, 1, 2), shots, traces, outs):
        check(specs.shape == (n_channels, sp.n_freqs_kept, sp.n_frames), f"specs {tuple(specs.shape)}")
        check(enh.shape == (n_channels, sp.n_freqs_kept, k * 128), f"enhanced {tuple(enh.shape)}")
        check(bool(torch.isfinite(specs).all() and torch.isfinite(enh).all()), "non-finite output")
        s_ssim = ssim(specs[0].cpu().numpy(), spectrogram_ref(host[0], sp))
        _, enh32 = enhance_shot_plain(model, t, sp)
        e_host, r_host = enh.cpu().numpy(), enh32.cpu().numpy()
        e_ssim = min(ssim(e_host[c], r_host[c]) for c in range(n_channels))
        log(f"shot seed {seed}: spectrogram SSIM vs SciPy {s_ssim:.6f} (gate {GATE_SPEC_SSIM}), "
            f"enhanced SSIM vs f32 plain service, min over {n_channels} ch {e_ssim:.6f} "
            f"(gate {GATE_ENH_SSIM})")
        check(s_ssim >= GATE_SPEC_SSIM, f"spectrogram SSIM {s_ssim:.6f}")
        check(e_ssim >= GATE_ENH_SSIM, f"enhanced SSIM {e_ssim:.6f}")
    return fn, wts, traces[0], launches


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


def time_all(sp, gpu, model, fn, wts, traces, st):
    """Phase 5: each kernel, its twin, the one PyTorch call computing the
    same function and its bound; then the service."""
    x1, x2, x3, x4, k, specs = st["x1"], st["x2"], st["x3"], st["x4"], st["k"], st["specs"]
    w = st["wts"]
    bf = torch.bfloat16
    tiles = patch(specs[:, :, : k * 128]).to(bf)[:, None].contiguous()
    cw = [AK._conv_w(w, i).to(bf) for i in (0, 1, 4)]
    tw = [w.w[i].permute(0, 3, 1, 2).flip(2, 3).to(bf).contiguous() for i in (2, 3)]
    b16 = [b.to(bf) for b in w.b]
    pads = [w.k(i) // 2 for i in range(5)]
    convt_pad = [w.k(i) - 1 - convt_pad_before(w.k(i)) for i in range(5)]
    window = torch.hamming_window(sp.nperseg, periodic=True, device=traces.device)
    library = {
        SF.STFT_KERNEL: lambda: torch.stft(traces, sp.nperseg, sp.hop, window=window,
                                           center=False, return_complex=True),
        AK.TILE_IN: lambda: F.conv2d(tiles, cw[0], b16[0], padding=pads[0]),
        AK.CONV_POOL: lambda: F.conv2d(x1, cw[1], b16[1], padding=pads[1]),
        AK.CONVT: lambda: (F.conv_transpose2d(x2, tw[0], b16[2], stride=2, padding=convt_pad[2],
                                              output_padding=1),
                           F.conv_transpose2d(x3, tw[1], b16[3], stride=2, padding=convt_pad[3],
                                              output_padding=1)),
        AK.TILE_OUT: lambda: F.conv2d(x4, cw[2], b16[4], padding=pads[4]),
    }
    c, b = traces.shape[0], x1.shape[0]
    nf, n = sp.n_freqs_onesided, sp.nperseg
    out_specs = c * 256 * k * 128 * 4
    # K1's function needs no more than an FFT's work per frame: detrend and
    # window (~7 n), a real FFT (2.5 n log2 n), the PSD, its log and the
    # min/max (~6 per bin); the kernel's dense DFT GEMM is its own choice.
    stft_ops = c * sp.n_frames * (7 * n + 2.5 * n * np.log2(n) + 6 * nf)
    work = {  # (FLOPs, bytes, operand type) of each kernel at these shapes
        SF.STFT_KERNEL: (stft_ops, c * sp.n_samples * 4 + c * nf * sp.n_frames * 4,
                         torch.float32),
        AK.TILE_IN: (2 * b * 256 * 128 * w.cout(0) * w.k(0) ** 2, out_specs + nbytes(x1), bf),
        AK.CONV_POOL: (2 * b * 128 * 64 * w.cout(0) * w.cout(1) * w.k(1) ** 2,
                       nbytes(x1, x2), bf),
        AK.CONVT: (2 * b * (64 * 32 * w.cout(1) * w.cout(2) * w.k(2) ** 2
                            + 128 * 64 * w.cout(2) * w.cout(3) * w.k(3) ** 2),
                   nbytes(x2, x3, x3, x4), bf),
        AK.TILE_OUT: (2 * b * 256 * 128 * w.cout(3) * w.k(4) ** 2, nbytes(x4) + out_specs, bf),
    }
    pairs = {
        SF.STFT_KERNEL: (lambda: SF.stft_ft_log(traces, sp),
                         lambda: SF.stft_ft_log_plain(traces, sp)),
        AK.TILE_IN: (lambda: AK.ae_tile_in(w, specs, k),
                     lambda: AK.ae_tile_in_plain(w, specs, k)),
        AK.CONV_POOL: (lambda: AK.ae_conv_pool(w, x1),
                       lambda: AK.ae_conv_pool_plain(w, x1)),
        AK.CONVT: (lambda: (AK.ae_convt(w, x2, 2), AK.ae_convt(w, x3, 3)),
                   lambda: (AK.ae_convt_plain(w, x2, 2), AK.ae_convt_plain(w, x3, 3))),
        AK.TILE_OUT: (lambda: AK.ae_tile_out(w, x4, k),
                      lambda: AK.ae_tile_out_plain(w, x4, k)),
    }
    times = {}
    for kern, (kf, pf) in pairs.items():
        ms, plain_ms = pair_times(gpu, kern.symbol, kf, pf)
        lib_ms = time_cuda(library[kern])
        b_ms, b_by = bound(*work[kern])
        times[kern] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by)
        log(f"[{gpu}] {kern.symbol}: library call {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {work[kern][0] / 1e9:.3f} GFLOP, {work[kern][1] / 1e6:.1f} MB, "
            f"{PEAK[work[kern][2]][1]}, 3.35 TB/s)")
    with torch.no_grad():
        ae_k = time_cuda(lambda: AK.ae_kernel_enhance_specs(w, specs, k))
        ae_p = time_cuda(lambda: AK.ae_kernel_enhance_specs_plain(model, specs, k))
        m16 = make_model(model.cfg, generator=torch.Generator().manual_seed(SEED),
                         device=specs.device).to(torch.bfloat16).eval()
        ae_p16 = time_cuda(lambda: AK.ae_kernel_enhance_specs_plain(m16, specs, k))
    log(f"[{gpu}] whole AE, {specs.shape[0]} ch: kernels (bf16) {ae_k:.4f} ms, plain module "
        f"f32 {ae_p:.4f} ms, plain module bf16 {ae_p16:.4f} ms")

    torch.cuda.reset_peak_memory_stats()
    ms = time_cuda(fn, wts, traces, warmup=3, iters=20)
    peak = torch.cuda.max_memory_allocated()
    ms_plain = time_cuda(enhance_shot_plain, model, traces, sp, warmup=2, iters=10)
    c = traces.shape[0]
    log(f"[{gpu}] service bf16: {ms:.4f} ms/shot (median of 20), {c / ms * 1e3:.2f} "
        f"spectrograms/s, peak device memory {peak / 2**30:.3f} GiB; plain f32 service "
        f"{ms_plain:.4f} ms/shot")
    return times


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


def make_data(dev, sp):
    """Phase 6: the recipe's tiles on the card (hyperparam_scan.py:126-149):
    synthetic shots through the STFT kernel, patched, split 60/25/15."""
    t0 = time.perf_counter()
    shots = synthetic_shot_batch(N_SHOTS, N_CHANNELS, sp.n_samples, sp.fs, seed=SEED)
    with torch.no_grad():
        x = torch.cat([patch(SF.spectrogram_fused(torch.from_numpy(s).to(dev), sp))
                       for s in shots])
    del shots
    check(tuple(x.shape) == (N_SHOTS * N_CHANNELS * 30, 256, 128), f"tiles {tuple(x.shape)}")
    check(bool(torch.isfinite(x).all()), "non-finite tiles")
    data = split_tiles(x, (0.8 * x + 0.1).clamp(0, 1), TrainConfig().split_fracs)
    log(f"data: {x.shape[0]} tiles -> train {len(data.x_train)}, tune {len(data.x_tune)}, "
        f"test {len(data.x_test)} in {time.perf_counter() - t0:.1f} s")
    return data


def check_train_stages(tw, x, y, mask, tag):
    """Phase 7: every training kernel against its twin, stage by stage on
    the same inputs (the kernels' own outputs feed the next stage); the K5b
    entry points must equal K5's bit for bit.  Returns the max |err| of
    each kernel and the stage tensors."""
    dt = tw.dtype
    act = check_bf16_stage if dt == torch.bfloat16 else check_f32
    errs = {}

    def note(kern, e):
        errs[kern] = max(errs.get(kern, 0.0), e)

    x16, y16 = x.to(dt), y.to(dt)
    p1, pm1 = TK.ae_train_in(tw, x)
    r1, rm1 = TK.ae_train_in_plain(tw, x)
    note(TK.TRAIN_IN, act(f"{tag} ae_train_in", p1, r1))
    check_mask(f"{tag} pool-1 routing", pm1, rm1)
    q1, qm1 = TK.ae_train_in(tw, x16, pre=True)
    check(torch.equal(q1, p1) and torch.equal(qm1, pm1), f"{tag} ae_train_in_pre != ae_train_in")
    note(TK.TRAIN_IN_PRE, act(f"{tag} ae_train_in_pre", q1, r1))
    p2, pm2 = TK.ae_train_conv_pool(tw, p1)
    r2, rm2 = TK.ae_train_conv_pool_plain(tw, p1)
    note(TK.TRAIN_CONV_POOL, act(f"{tag} ae_train_conv_pool", p2, r2))
    fr = check_mask(f"{tag} pool-2 routing", pm2, rm2)
    d4 = AK.ae_convt(tw.fwd, p2, 2)
    rd4 = AK.ae_convt_plain(tw.fwd, p2, 2)
    act(f"{tag} convT2", d4, rd4)
    e = AK.ae_convt(tw.fwd, d4, 3)
    re_ = AK.ae_convt_plain(tw.fwd, d4, 3)
    act(f"{tag} convT1", e, re_)
    fr = max(fr, check_mask(f"{tag} relu d4", d4 > 0, rd4 > 0),
             check_mask(f"{tag} relu e", e > 0, re_ > 0))
    logits, dz5, bce, db5 = TK.ae_train_loss(tw, e, y, mask)
    rl, rdz5, rbce, rdb5 = TK.ae_train_loss_plain(tw, e, y, mask)
    note(TK.TRAIN_LOSS, max(check_f32(f"{tag} logits", logits, rl),
                            act(f"{tag} dz5", dz5, rdz5),
                            check_sum(f"{tag} BCE sum", bce, rbce),
                            check_sum(f"{tag} db5", db5, rdb5)))
    pre = TK.ae_train_loss(tw, e, y16, mask, pre=True)
    check(all(torch.equal(a, b) for a, b in zip(pre, (logits, dz5, bce, db5))),
          f"{tag} ae_train_loss_pre != ae_train_loss")
    note(TK.TRAIN_LOSS_PRE, errs[TK.TRAIN_LOSS])

    def wgrad(i, a, d, bits=None, pre=False):
        got = TK.ae_train_wgrad(tw, i, a, d, bits, pre=pre)
        note(TK.WGRAD_X if i == 0 and not pre else TK.WGRAD,
             check_sum(f"{tag} dW{i}", got, TK.ae_train_wgrad_plain(tw, i, a, d, bits)))
        return got

    def dgrad(fn, plain, kern, i, d, gate, *bits):
        out, db = fn(tw, i, d, gate, *bits)
        rout, rdb = plain(tw, i, d, gate, *bits)
        note(kern, max(act(f"{tag} dgrad {i}", out, rout), check_sum(f"{tag} db{i}", db, rdb)))
        return out

    wgrad(4, e, dz5)
    dz4 = dgrad(TK.ae_train_dgrad_conv, TK.ae_train_dgrad_conv_plain, TK.DGRAD_CONV, 4, dz5, e)
    wgrad(3, d4, dz4)
    dz3 = dgrad(TK.ae_train_dgrad_convt, TK.ae_train_dgrad_convt_plain, TK.DGRAD_CONVT, 3, dz4, d4)
    wgrad(2, p2, dz3)
    dp2 = dgrad(TK.ae_train_dgrad_convt, TK.ae_train_dgrad_convt_plain, TK.DGRAD_CONVT, 2, dz3, pm2)
    wgrad(1, p1, dp2, pm2)
    dp1 = dgrad(TK.ae_train_dgrad_conv, TK.ae_train_dgrad_conv_plain, TK.DGRAD_CONV, 1, dp2, pm1, pm2)
    g0 = wgrad(0, x, dp1, pm1)
    check(torch.equal(wgrad(0, x16, dp1, pm1, pre=True), g0), f"{tag} dW0 of K5b != K5")
    part = torch.randn(4096, 288, generator=torch.Generator().manual_seed(SEED)).to(x.device)
    note(TK.TRAIN_SUM, check_sum(f"{tag} ae_train_sum", TK.ae_train_sum(part), part.sum(0)))
    log(f"{tag}: every training stage within tolerance (masks differ on {fr:.3g} of entries; "
        "K5b entry points equal K5 bit for bit); max|err| " + ", ".join(
            f"{k.symbol} {v:.3g}" for k, v in errs.items()))
    return errs, dict(x=x, x16=x16, y=y, y16=y16, mask=mask, p1=p1, pm1=pm1, p2=p2, pm2=pm2,
                      d4=d4, e=e, dz5=dz5, dz4=dz4, dz3=dz3, dp2=dp2, dp1=dp1)


def check_autograd(model, x, y, mask):
    """Phase 8: the kernels' loss and gradients against torch autograd of
    the module in float32 (TF32 off)."""
    model.zero_grad()
    ref = TK.masked_bce_from_logits(model(x, logits=True), y, mask)
    ref.backward()
    ref = float(ref.detach())
    scale = max(float(p.grad.abs().max()) for p in model.parameters())
    for dt, tol in ((torch.float32, TOL_AUTOGRAD_F32), (torch.bfloat16, TOL_AUTOGRAD_BF16)):
        loss, grads = TK.kernel_value_and_grad(model, x, y, mask, dt)
        rel = max(float((grads[n] - p.grad).abs().max()) for n, p in model.named_parameters()) / scale
        lrel = abs(float(loss) - ref) / abs(ref)
        log(f"kernel grads ({dt}) vs f32 autograd, {x.shape[0]} tiles: max|dg|/max|g| {rel:.3g} "
            f"(tol {tol}), loss {float(loss):.7f} vs {ref:.7f} (rel {lrel:.3g})")
        check(rel <= tol, f"{dt} gradients off autograd by {rel:.3g}")
        if dt == torch.float32:
            check(lrel <= 1e-5, f"f32 loss off autograd by {lrel:.3g}")
    model.zero_grad()


def train_runs(dev, cfg, data):
    """Phase 9: fit on the recipe; returns the training kernels' launches
    and the two loss histories."""
    tc = TrainConfig()

    def state():
        return TR.create_state(cfg, tc, generator=torch.Generator().manual_seed(SEED), device=dev)

    args = (data.x_train, data.y_train, data.x_tune, data.y_tune)
    for kern in _build.KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    _, hk = TR.fit(state(), *args, cfg=tc, epochs=EPOCHS, epoch_fn=TR.kernel_epoch_for(cfg, tc))
    s5, _ = TR.fit(state(), *args, cfg=tc, epochs=1, epoch_fn=TR.kernel_epoch_for(cfg, tc))
    s5b, _ = TR.fit(state(), *args, cfg=tc, epochs=1,
                    epoch_fn=TR.kernel_epoch_for(cfg, tc, pre_layout=True))
    torch.cuda.synchronize(dev)
    launches = {kern: kern.launches for kern in _build.KERNELS}
    t_kernel = time.perf_counter() - t0
    log("training launches: " + ", ".join(f"{k.symbol}={n}" for k, n in launches.items()
                                          if n))
    for kern in (*TK.TRAIN_KERNELS, AK.CONVT):
        check(launches[kern] > 0, f"{kern.symbol} was not launched by training")
    t0 = time.perf_counter()
    _, ha = TR.fit(state(), *args, cfg=tc, epochs=EPOCHS)
    t_auto = time.perf_counter() - t0
    log(f"fit kernel bf16 (K5): loss {hk['loss']}, val_loss {hk['val_loss']}")
    log(f"fit autograd f32:     loss {ha['loss']}, val_loss {ha['val_loss']}")
    log(f"wall: kernel runs ({EPOCHS} + 1 + 1 epochs) {t_kernel:.1f} s, autograd run {t_auto:.1f} s")
    for i, (a, b) in enumerate(zip(hk["loss"], ha["loss"])):
        check(abs(a - b) <= TOL_LOSS_CURVE * b, f"epoch {i} loss {a} vs f32 autograd {b}")
    check(hk["loss"][-1] < hk["loss"][0], f"loss did not fall: {hk['loss']}")
    check(all(np.isfinite(hk["val_loss"] + ha["val_loss"])), "non-finite val_loss")
    same = all(torch.equal(a, b) for a, b in zip(s5.model.state_dict().values(),
                                                 s5b.model.state_dict().values()))
    check(same, "after one epoch the K5b run's parameters differ from K5's")
    log(f"gates: per-epoch loss within {TOL_LOSS_CURVE:.1%} of f32 autograd, falling, val finite; "
        "K5b parameters == K5 parameters bit for bit after one epoch")
    return launches


def time_training(gpu, cfg, data, tw, st):
    """Phase 10: each training kernel per 128-tile step, its twin, the one
    PyTorch call that computes the same function, its bound; then the
    engines' s/epoch, tiles/s and the peak memory of a step."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    bf, w = torch.bfloat16, tw.fwd
    b = st["x"].shape[0]
    c1, c2 = w.cout(0), w.cout(1)
    kk = [w.k(i) for i in range(5)]
    cw = [AK._conv_w(w, i).to(bf) for i in range(5)]       # (out, in, k, k)
    kflip = [w.w[i].flip(1, 2).permute(0, 3, 1, 2).to(bf).contiguous() for i in range(5)]
    dz2 = TK.route_expand(st["dp2"], st["pm2"]).to(bf)
    dz1 = TK.route_expand(st["dp1"], st["pm1"]).to(bf)
    x1 = st["x16"][:, None]
    plain = dict(wgrad=TK.ae_train_wgrad_plain, dgrad_conv=TK.ae_train_dgrad_conv_plain,
                 dgrad_convt=TK.ae_train_dgrad_convt_plain)

    def fl(h, wd, ci, co, k):
        return 2 * b * h * wd * ci * co * k * k

    s = st
    wg = [(4, s["e"], s["dz5"], None), (3, s["d4"], s["dz4"], None), (2, s["p2"], s["dz3"], None),
          (1, s["p1"], s["dp2"], s["pm2"])]
    parts = [(b * ((64 * 128 + 127) // 128), 2), (b * 64, c1), (b * 16, c1),
             (b * 64, c2), (b * 16, c2)] + [(b, tw.fwd.w[i].numel()) for i in range(5)]
    parts = [torch.rand(n, m, device=s["x"].device) for n, m in parts]
    wparts = 4 * sum(b * w.w[i].numel() for i in range(1, 5))
    entries = {  # kernel: (kernel launches, plain, library call, FLOPs, bytes, dtype)
        TK.TRAIN_IN: (lambda: TK.ae_train_in(tw, s["x"]), lambda: TK.ae_train_in_plain(tw, s["x"]),
                      lambda: F.conv2d(x1, cw[0], padding=kk[0] // 2),
                      fl(256, 128, 1, c1, kk[0]), nbytes(s["x"], s["p1"], s["pm1"])),
        TK.TRAIN_IN_PRE: (lambda: TK.ae_train_in(tw, s["x16"], pre=True),
                          lambda: TK.ae_train_in_plain(tw, s["x16"]),
                          lambda: F.conv2d(x1, cw[0], padding=kk[0] // 2),
                          fl(256, 128, 1, c1, kk[0]), nbytes(s["x16"], s["p1"], s["pm1"])),
        TK.TRAIN_CONV_POOL: (lambda: TK.ae_train_conv_pool(tw, s["p1"]),
                             lambda: TK.ae_train_conv_pool_plain(tw, s["p1"]),
                             lambda: F.conv2d(s["p1"], cw[1], padding=kk[1] // 2),
                             fl(128, 64, c1, c2, kk[1]), nbytes(s["p1"], s["p2"], s["pm2"])),
        TK.TRAIN_LOSS: (lambda: TK.ae_train_loss(tw, s["e"], s["y"], s["mask"]),
                        lambda: TK.ae_train_loss_plain(tw, s["e"], s["y"], s["mask"]),
                        lambda: F.conv2d(s["e"], cw[4], padding=kk[4] // 2),
                        fl(256, 128, c1, 1, kk[4]),
                        nbytes(s["e"], s["y"], s["y"], s["dz5"], s["mask"])),
        TK.TRAIN_LOSS_PRE: (lambda: TK.ae_train_loss(tw, s["e"], s["y16"], s["mask"], pre=True),
                            lambda: TK.ae_train_loss_plain(tw, s["e"], s["y16"], s["mask"]),
                            lambda: F.conv2d(s["e"], cw[4], padding=kk[4] // 2),
                            fl(256, 128, c1, 1, kk[4]),
                            nbytes(s["e"], s["y16"], s["y"], s["dz5"], s["mask"])),
        TK.DGRAD_CONV: (
            lambda: (TK.ae_train_dgrad_conv(tw, 4, s["dz5"], s["e"]),
                     TK.ae_train_dgrad_conv(tw, 1, s["dp2"], s["pm1"], s["pm2"])),
            lambda: (plain["dgrad_conv"](tw, 4, s["dz5"], s["e"]),
                     plain["dgrad_conv"](tw, 1, s["dp2"], s["pm1"], s["pm2"])),
            lambda: (conv2d_input(s["e"].shape, cw[4], s["dz5"], padding=kk[4] // 2),
                     conv2d_input(s["p1"].shape, cw[1], dz2, padding=kk[1] // 2)),
            fl(256, 128, 1, c1, kk[4]) + fl(128, 64, c2, c1, kk[1]),
            nbytes(s["dz5"], s["e"], s["dz4"], s["dp2"], s["pm2"], s["pm1"], s["dp1"])),
        TK.DGRAD_CONVT: (
            lambda: (TK.ae_train_dgrad_convt(tw, 3, s["dz4"], s["d4"]),
                     TK.ae_train_dgrad_convt(tw, 2, s["dz3"], s["pm2"])),
            lambda: (plain["dgrad_convt"](tw, 3, s["dz4"], s["d4"]),
                     plain["dgrad_convt"](tw, 2, s["dz3"], s["pm2"])),
            lambda: (F.conv2d(s["dz4"], kflip[3], stride=2, padding=kk[3] // 2),
                     F.conv2d(s["dz3"], kflip[2], stride=2, padding=kk[2] // 2)),
            fl(128, 64, c1, c2, kk[3]) + fl(64, 32, c2, c2, kk[2]),
            nbytes(s["dz4"], s["d4"], s["dz3"], s["dz3"], s["pm2"], s["dp2"])),
        TK.WGRAD: (
            lambda: [TK.ae_train_wgrad(tw, i, a, d, bits) for i, a, d, bits in wg],
            lambda: [plain["wgrad"](tw, i, a, d, bits) for i, a, d, bits in wg],
            lambda: (conv2d_weight(s["e"], cw[4].shape, s["dz5"], padding=kk[4] // 2),
                     conv2d_weight(s["dz4"], kflip[3].shape, s["d4"], stride=2, padding=kk[3] // 2),
                     conv2d_weight(s["dz3"], kflip[2].shape, s["p2"], stride=2, padding=kk[2] // 2),
                     conv2d_weight(s["p1"], cw[1].shape, dz2, padding=kk[1] // 2)),
            fl(256, 128, c1, 1, kk[4]) + fl(128, 64, c2, c1, kk[3]) + fl(64, 32, c2, c2, kk[2])
            + fl(128, 64, c1, c2, kk[1]),
            nbytes(s["e"], s["dz5"], s["d4"], s["dz4"], s["p2"], s["dz3"], s["p1"], s["dp2"],
                   s["pm2"]) + wparts),
        TK.WGRAD_X: (lambda: TK.ae_train_wgrad(tw, 0, s["x"], s["dp1"], s["pm1"]),
                     lambda: plain["wgrad"](tw, 0, s["x"], s["dp1"], s["pm1"]),
                     lambda: conv2d_weight(x1, cw[0].shape, dz1, padding=kk[0] // 2),
                     fl(256, 128, 1, c1, kk[0]),
                     nbytes(s["x"], s["dp1"], s["pm1"]) + 4 * b * w.w[0].numel()),
        TK.TRAIN_SUM: (lambda: [TK.ae_train_sum(p) for p in parts],
                       lambda: [p.sum(0) for p in parts],
                       lambda: [torch.sum(p, 0) for p in parts],
                       sum(p.numel() for p in parts), sum(nbytes(p) for p in parts)),
    }
    times = {}
    for kern, (kf, pf, lf, flops, nb) in entries.items():
        ms, plain_ms = pair_times(gpu, f"{kern.symbol} per {b}-tile step", kf, pf)
        with torch.no_grad():
            lib_ms = time_cuda(lf)
        b_ms, b_by = bound(flops, nb, tw.dtype if kern is not TK.TRAIN_SUM else torch.float32)
        times[kern] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by)
        log(f"[{gpu}] {kern.symbol}: library call {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{flops / 1e9:.3f} GFLOP, {nb / 1e6:.1f} MB), achieved "
            f"{flops / ms / 1e9:.2f} TFLOP/s")

    # one step of each engine, and one epoch of each
    tc = TrainConfig()
    x, y = data.x_train, data.y_train
    n = x.shape[0]
    bi, bm = TR._epoch_batches(n, BATCH, np.random.default_rng(SEED).permutation(n))
    bi, bm = torch.from_numpy(bi).to(x.device), torch.from_numpy(bm).to(x.device)
    for name, epoch_fn in (("kernel bf16 (K5)", TR.kernel_epoch_for(cfg, tc)),
                           ("kernel bf16 (K5b)", TR.kernel_epoch_for(cfg, tc, pre_layout=True)),
                           ("kernel f32", TR.kernel_epoch_for(cfg, tc, dtype=torch.float32)),
                           ("autograd f32", TR.train_epoch)):
        state = TR.create_state(cfg, tc, generator=torch.Generator().manual_seed(SEED),
                                device=x.device)
        epoch_fn(state, x, y, bi[:2], bm[:2])  # warm-up: two steps
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_cuda(lambda: epoch_fn(state, x, y, bi[:1], bm[:1]), warmup=1, iters=10)
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        epoch_fn(state, x, y, bi, bm)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        log(f"[{gpu}] {name}: {sec:.4f} s/epoch ({bi.shape[0]} steps of {BATCH}), "
            f"{n / sec:.1f} tiles/s; step {step_ms:.4f} ms (CUDA events, median of 10, "
            f"with the optimizer{'; K5b casts all tiles once per call' if 'K5b' in name else ''}); "
            f"peak device memory of a step {peak / 2**30:.3f} GiB above the "
            f"{base / 2**30:.3f} GiB resident")
    # a K5 step's kernels; the stage wrappers' times include their
    # ae_train_sum launches, so the sums' own row is left out here
    step = {k.symbol: t["ms"] for k, t in times.items()
            if k not in (TK.TRAIN_IN_PRE, TK.TRAIN_LOSS_PRE, TK.TRAIN_SUM)}
    step[f"{AK.CONVT.symbol} (forward)"] = time_cuda(
        lambda: (AK.ae_convt(w, s["p2"], 2), AK.ae_convt(w, s["d4"], 3)))
    k_sum = sum(step.values())
    log(f"[{gpu}] K5 step, sum of its kernels' times: {k_sum:.4f} ms: " + ", ".join(
        f"{name} {ms:.4f} ms ({ms / k_sum:.1%})"
        for name, ms in sorted(step.items(), key=lambda kv: -kv[1])))
    return times


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

    sp, cfg = SpecParams(), ModelConfig()
    traces = torch.from_numpy(example_shot(sp, N_CHANNELS, SEED)).to(dev)
    model, errs, st = check_kernels(dev, sp, cfg, traces)
    fn, wts, traces, launches = run_service(dev, sp, cfg, model, N_CHANNELS)
    times = time_all(sp, gpu, model, fn, wts, traces, st)
    del fn, wts, traces, st, model

    data = make_data(dev, sp)
    xb, yb = data.x_train[:BATCH], data.y_train[:BATCH]
    mb = torch.ones(BATCH, device=dev)
    tmodel = make_model(cfg, generator=torch.Generator().manual_seed(SEED), device=dev)
    for dt in (torch.bfloat16, torch.float32):
        tw = TK.build_train_weights(tmodel, dt)
        e_, st_ = check_train_stages(tw, xb, yb, mb, f"flagship {dt}, {BATCH} tiles")
        if dt == torch.bfloat16:
            errs.update(e_)
            tw16, tstate = tw, st_
    for name, gcfg in (("k5", ModelConfig(kernels=((5, 5), (5, 5)), out_kernel=(5, 5))),
                       ("k7", ModelConfig(kernels=((7, 7), (7, 7)), out_kernel=(7, 7))),
                       ("manual (64,32)/k5", ModelConfig(filters=(64, 32), kernels=((5, 5), (5, 5)),
                                                         out_kernel=(5, 5)))):
        m = make_model(gcfg, generator=torch.Generator().manual_seed(SEED), device=dev)
        for dt in (torch.bfloat16, torch.float32):
            check_train_stages(TK.build_train_weights(m, dt), xb[:4], yb[:4], mb[:4],
                               f"{name} {dt}, 4 tiles")
    check_autograd(tmodel, xb, yb, mb)
    launches.update({k: n for k, n in train_runs(dev, cfg, data).items()
                     if k in TK.TRAIN_KERNELS})
    times.update(time_training(gpu, cfg, data, tw16, tstate))

    rows = []
    for kern in _build.KERNELS:
        src, rep = REPLACES[kern]
        rows.append({"name": kern.symbol, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[kern],
                     "max_abs_err": errs[kern], **times[kern]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
