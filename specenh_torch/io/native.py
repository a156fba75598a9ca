"""ctypes bindings for the native shot runtime (``native/specenh_native.cc``):
the mmap'd SPEC reader and its threaded prefetcher, the counterpart of
``specenh.io.native``.

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC -pthread
-shared`` (the flags of ``native/Makefile``) into ``build/native/`` at the
repo root (git-ignored); the file name carries a hash of the source and the
flags, so an edited source rebuilds.  Nothing is written into ``native/``.
Without a compiler (or with a library of another ABI) every entry point
reads in Python instead; ``native_available()`` says which reader runs.

    reader = NativePrefetcher(paths, n_channels=20, n_samples=1_000_000)
    for shot_idx, traces in reader:          # traces: (C, S) float32
        ...                                   # overlaps disk IO with compute
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = ["load_native", "native_available", "read_shot", "NativePrefetcher"]

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = _ROOT / "native" / "specenh_native.cc"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
ABI_VERSION = 2

_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libspecenh_native-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library for this source, compiled unless already built; None
    where there is no source or the compiler fails."""
    if not NATIVE_SRC.exists():
        return None
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def load_native(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed or not NATIVE_SRC.exists():
        return None
    so = _build() if build else _library_path()
    if so is None or not so.exists():
        _build_failed = build
        return None
    lib = ctypes.CDLL(str(so))
    # refuse a library of another C ABI: calling an old 2-argument
    # prefetcher_next through 3-argument argtypes would misreport corrupt
    # shots as successes
    try:
        lib.specenh_abi_version.restype = ctypes.c_int64
        abi = int(lib.specenh_abi_version())
    except AttributeError:
        abi = -1
    if abi != ABI_VERSION:
        _build_failed = True
        return None
    lib.specenh_read_shot.restype = ctypes.c_int
    lib.specenh_read_shot.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.specenh_shot_info.restype = ctypes.c_int
    lib.specenh_shot_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.specenh_prefetcher_create.restype = ctypes.c_void_p
    lib.specenh_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.specenh_prefetcher_next.restype = ctypes.c_int64
    lib.specenh_prefetcher_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.specenh_prefetcher_destroy.restype = None
    lib.specenh_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return load_native() is not None


def read_shot(path: str, n_channels: int, n_samples: int) -> np.ndarray:
    """(n_channels, n_samples) float32 from a SPEC binary, native if
    possible; the Python reader zero-pads a short file as the native one
    does."""
    lib = load_native()
    if lib is None:
        from specenh_torch.io.binfmt import read_shot_bin

        data = read_shot_bin(path)
        out = np.zeros((n_channels, n_samples), np.float32)
        cc = min(n_channels, data.shape[0])
        cs = min(n_samples, data.shape[1])
        out[:cc, :cs] = data[:cc, :cs]
        return out
    out = np.empty((n_channels, n_samples), np.float32)
    rc = lib.specenh_read_shot(
        path.encode(), n_channels, n_samples,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise IOError(f"native read failed for {path} (rc={rc})")
    return out


class NativePrefetcher:
    """Threaded shot prefetcher over SPEC binaries.

    Iterates (shot_index, traces) in COMPLETION order — key on the yielded
    index, not arrival position.  Corrupt files yield (shot_index, None)
    so callers can quarantine the FILE.  Without the native library it is
    a synchronous Python loop.
    """

    def __init__(
        self,
        paths: Sequence[str],
        n_channels: int,
        n_samples: int,
        n_threads: int = 4,
        queue_depth: int = 4,
    ):
        self.paths = [os.fspath(p) for p in paths]
        self.n_channels = n_channels
        self.n_samples = n_samples
        self._lib = load_native()
        self._handle = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._paths_keepalive = arr
            self._handle = self._lib.specenh_prefetcher_create(
                arr, len(self.paths), n_channels, n_samples, n_threads, queue_depth
            )

    def __iter__(self) -> Iterator[Tuple[int, Optional[np.ndarray]]]:
        if self._handle is None:  # the Python reader
            for i, p in enumerate(self.paths):
                try:
                    yield i, read_shot(p, self.n_channels, self.n_samples)
                except Exception:  # any unreadable file: the caller quarantines it
                    yield i, None
            return
        for _ in range(len(self.paths)):
            out = np.empty((self.n_channels, self.n_samples), np.float32)
            status = ctypes.c_int64(0)
            idx = self._lib.specenh_prefetcher_next(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(status),
            )
            if idx == -1:
                return
            if status.value != 0:
                yield int(idx), None
            else:
                yield int(idx), out

    def close(self):
        if self._handle is not None and self._lib is not None:
            self._lib.specenh_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
