#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA GPU.

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
   and peak device memory.

Prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``.  Weights are glorot-initialised from a
seeded ``torch.Generator``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import torch

from specenh_torch import ModelConfig, SpecParams, _build
from specenh_torch.bench.harness import (enhance_shot_plain, example_shot,
                                         make_enhance_shot_fn, time_cuda)
from specenh_torch.bench.reference import spectrogram_ref, ssim
from specenh_torch.models.autoencoder import make_model
from specenh_torch.ops import ae_kernel as AK
from specenh_torch.ops import stft_fused as SF

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

REPLACES = {
    SF.STFT_KERNEL: ("specenh_torch/csrc/stft.cu", "specenh/ops/stft_fused.py:198"),
    AK.TILE_IN: ("specenh_torch/csrc/ae.cu", "specenh/ops/parity_turn.py:131"),
    AK.CONV_POOL: ("specenh_torch/csrc/ae.cu", "specenh/ops/ae_kernel.py:534"),
    AK.CONVT: ("specenh_torch/csrc/ae.cu", "specenh/ops/ae_kernel.py:534"),
    AK.TILE_OUT: ("specenh_torch/csrc/ae.cu", "specenh/ops/parity_turn.py:224"),
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
    """(kernel, registers, spill bytes) from the build's ptxas reports."""
    rows = []
    for logf in sorted(_build.BUILD_DIR.glob("*.log")):
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
                rows.append((name, int(m.group(1)), spill))
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
    for kern, n in launches.items():
        check(n > 0, f"{kern.symbol} was not launched by the service")
    log("service launches: " + ", ".join(f"{k.symbol}={n}" for k, n in launches.items()))
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


def time_all(sp, gpu, model, fn, wts, traces, st):
    """Phase 5: each kernel and its twin, then the service."""
    x1, x2, x3, x4, k, specs = st["x1"], st["x2"], st["x3"], st["x4"], st["k"], st["specs"]
    w = st["wts"]
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
        # plain, kernel, kernel, plain: drift on the card shows as a gap
        p1, k1, k2, p2 = time_cuda(pf), time_cuda(kf), time_cuda(kf), time_cuda(pf)
        times[kern] = (min(k1, k2), min(p1, p2))
        log(f"[{gpu}] {kern.symbol}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
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
    for name, regs, spill in ptxas_summary():
        log(f"  ptxas {name[:72]}: {regs} registers, {spill} B spill stores")

    sp, cfg = SpecParams(), ModelConfig()
    traces = torch.from_numpy(example_shot(sp, N_CHANNELS, SEED)).to(dev)
    model, errs, st = check_kernels(dev, sp, cfg, traces)
    fn, wts, traces, launches = run_service(dev, sp, cfg, model, N_CHANNELS)
    times = time_all(sp, gpu, model, fn, wts, traces, st)

    rows = []
    for kern in _build.KERNELS:
        src, rep = REPLACES[kern]
        ms, plain_ms = times[kern]
        rows.append({"name": kern.symbol, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[kern],
                     "max_abs_err": errs[kern], "ms": ms, "plain_ms": plain_ms})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
