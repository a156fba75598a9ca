"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, compiled for Hopper (sm_90a) at first use into ``build/kernels/``
at the repo root (git-ignored).  The library's file name carries a hash of
the sources and flags, so an edited ``.cu`` rebuilds and an unchanged one is
reused.  Nothing is downloaded: nvcc and the CUDA headers come from the
local CUDA toolkit.

A ``CudaKernel`` is one C entry point.  Every entry point takes the CUDA
stream as its last argument and returns ``cudaGetLastError()`` after its
launch; the call raises if that is not 0 and otherwise adds one to
``launches``, so a run can show that it went through the kernel.  The
libraries with the conv templates (``ae``, ``ae_train``) also
count the launches of each conv template (``conv_template_launches``), so
a run can show which template each launch site took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

__all__ = ["CudaKernel", "build", "build_all", "conv_template_launches", "CONV_TEMPLATES",
           "KERNELS", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
KERNELS: List["CudaKernel"] = []


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source
    is already built; returns the library's path.  The ptxas report
    (registers, spills) is kept beside it as ``.log``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def build_all(names: Sequence[str] = ("stft", "ae", "ae_train", "probes")
              ) -> Dict[str, float]:
    """Build the libraries in parallel; returns wall seconds per library."""
    secs: Dict[str, float] = {}
    errors: List[BaseException] = []

    def one(name):
        t0 = time.perf_counter()
        try:
            build(name)
        except BaseException as e:  # re-raised below, after the join
            errors.append(e)
        secs[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return secs


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            major, minor = torch.cuda.get_device_capability()
            if (major, minor) != (9, 0):
                raise RuntimeError(
                    f"the kernels are built for sm_90a (Hopper); this device "
                    f"is sm_{major}{minor}"
                )
            lib = ctypes.CDLL(str(build(name)))
            lib.specenh_error_string.argtypes = [ctypes.c_int]
            lib.specenh_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


CONV_TEMPLATES = ("conv_quad_kernel", "conv_igemm_kernel", "convt_relu_kernel",
                  "convt_igemm_kernel", "conv_out_mma_kernel", "conv_in_mma_kernel")


def conv_template_launches(name: str) -> Dict[str, int]:
    """The launches of each conv template (``csrc/ae_conv.cuh``: the
    stride-1 convs', the transposed convs', the bf16 out-conv's and the bf16
    one-channel-in convs') made through library ``name`` since it was
    loaded."""
    out = (ctypes.c_longlong * len(CONV_TEMPLATES))()
    _library(name).specenh_conv_launches(out)
    return dict(zip(CONV_TEMPLATES, out))


def _current_stream() -> int:
    """The handle of the current device's current CUDA stream, without
    building a ``torch.cuda.Stream`` object, which costs the host more than
    a launch."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


class CudaKernel:
    """One C entry point of a ``csrc`` library, with its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]  # + the stream
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, _current_stream())
        if err != 0:
            msg = _library(self.source).specenh_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
