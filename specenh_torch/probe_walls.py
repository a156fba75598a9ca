"""K11: the toolchain probes, on Hopper (the counterpart of the repo's
Mosaic probes in ``scripts/probe_mosaic_walls.py``, which this module keeps
its own copy of the shapes of).

Three constructs once retired the TPU's split-basis STFT kernel: a value
slice at row offset 1, an in-kernel transpose, and a stride-2 slice along
the fast axis.  ``csrc/probes.cu`` writes each as a CUDA kernel; each
wrapper launches it for a CUDA tensor and runs its plain twin (torch
slicing) for a CPU tensor.

    python -m specenh_torch.probe_walls     # on a machine with an H100

builds the probes, then runs each in a subprocess with a timeout (a
compiler or a kernel that hangs must not hang the run), holds its output
against the twin, prints ``OK``, ``FAIL: ...`` or ``HANG`` per probe and a
JSON dict of the results, and exits non-zero unless all three are OK.  It
raises without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

from specenh_torch._build import CudaKernel, build

__all__ = ["PROBES", "row_slice", "transpose", "stride2", "row_slice_plain",
           "transpose_plain", "stride2_plain", "run_probe", "main"]

_p, _i = ctypes.c_void_p, ctypes.c_int
ROW_SLICE = CudaKernel("probes", "probe_row_slice", [_p, _p, _i])
TRANSPOSE = CudaKernel("probes", "probe_transpose", [_p, _p, _i])
STRIDE2 = CudaKernel("probes", "probe_stride2", [_p, _p, _i, _i])

FB = 256  # the STFT block's rows; the row-slice probe's input has FB + 8


def _check(x: torch.Tensor, shape: Tuple[int, int]) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"expected a contiguous float32 {shape}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def row_slice_plain(x: torch.Tensor) -> torch.Tensor:
    return x[1:FB + 1].clone()


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def stride2_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, ::2].contiguous()


def row_slice(x: torch.Tensor) -> torch.Tensor:
    """(264, 256) float32 -> x[1:257], through a shared-memory read one row
    down."""
    _check(x, (FB + 8, 256))
    if not x.is_cuda:
        return row_slice_plain(x)
    out = torch.empty(FB, x.shape[1], dtype=x.dtype, device=x.device)
    ROW_SLICE(x.data_ptr(), out.data_ptr(), x.shape[1])
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(256, 256) float32 -> x.T, through padded shared memory."""
    _check(x, (256, 256))
    if not x.is_cuda:
        return transpose_plain(x)
    out = torch.empty_like(x)
    TRANSPOSE(x.data_ptr(), out.data_ptr(), x.shape[0])
    return out


def stride2(x: torch.Tensor) -> torch.Tensor:
    """(256, 512) float32 -> x[:, ::2], read at stride 2 from shared
    memory."""
    _check(x, (256, 512))
    if not x.is_cuda:
        return stride2_plain(x)
    out = torch.empty(x.shape[0], x.shape[1] // 2, dtype=x.dtype, device=x.device)
    STRIDE2(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1] // 2)
    return out


# name -> (wrapper, plain twin, input shape), the Mosaic probes' names
PROBES: Dict[str, Tuple[Callable, Callable, Tuple[int, int]]] = {
    "sublane_offset1_slice": (row_slice, row_slice_plain, (FB + 8, 256)),
    "in_kernel_transpose": (transpose, transpose_plain, (256, 256)),
    "stride2_lane_slice": (stride2, stride2_plain, (256, 512)),
}


def run_probe(name: str, device="cuda", seed: int = 0) -> bool:
    """One probe on seeded random input: is the wrapper's output equal to
    its twin's, bit for bit?"""
    fn, plain, shape = PROBES[name]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(device)
    got = fn(x)
    if got.is_cuda:
        torch.cuda.synchronize(got.device)
    return bool(torch.equal(got, plain(x)))


def main(timeout: int = 180) -> Dict[str, str]:
    """Build the probes, run each in a subprocess of its own, the three at
    once, each given ``timeout`` seconds; report."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes need a CUDA device")
    build("probes")  # once, here: the subprocesses find it built
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs = {}
    for name in PROBES:  # all three at once, each in its own process
        code = (f"from specenh_torch.probe_walls import run_probe\n"
                f"print('RESULT_OK' if run_probe({name!r}) else 'RESULT_DIFFERS')\n")
        procs[name] = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True, env=env, cwd=root)
    results = {}
    deadline = time.monotonic() + timeout
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 0.0))
            if p.returncode == 0 and "RESULT_OK" in out:
                results[name] = "OK"
            else:
                lines = (err or out).strip().splitlines()
                results[name] = "FAIL: " + (lines[-1][:160] if lines else "?")
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            results[name] = f"HANG (> {timeout}s, killed)"
        print(f"{name}: {results[name]}", flush=True)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    sys.exit(0 if all(v == "OK" for v in main().values()) else 1)
