"""Native (C++) host decoder: threaded JPEG/PNG decode + PIL-convention
bicubic resize + center crop — the port of srsem/native/__init__.py.

``decoder.cpp`` here is a byte-for-byte copy of the JAX package's source.
It builds at first use with g++ into ``build/srsem_torch/`` at the root of
the checkout (listed in ``.gitignore``), under a name hashed from the
source and the flags, as ``srsem_torch/ops/_build.py`` names the kernel
libraries, and loads with ``ctypes``.  Nothing builds at import.

    g++ -O3 -march=native -shared -fPIC -std=c++17 decoder.cpp \\
        -o build/srsem_torch/decoder-<hash>.so -ljpeg -lpng -lpthread

Where g++, ``jpeglib.h`` or ``png.h`` is missing, ``available()`` is False
and ``build_error()`` says why; callers then use the PIL path
(srsem_torch/data/preprocess.py), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srsem_torch"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg", "-lpng", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _target() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"decoder-{digest}.so"


def _build(target: Path) -> Optional[str]:
    """Compile the shared library to ``target``; an error string or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        return str(e)
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or none
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        target = _target()
        if not target.exists():
            _build_error = _build(target)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as e:
            _build_error = str(e)
            return None
        lib.srsem_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.srsem_decode.restype = ctypes.c_int
        lib.srsem_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.srsem_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library built (or was built) and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    _load()
    return _build_error


def decode(path: str, size: int, crop_pct: float = 1.0,
           fast_jpeg: bool = False) -> Optional[np.ndarray]:
    """Decode one image → (size, size, 3) uint8, or None on failure (or
    without the library).  ``fast_jpeg``: libjpeg's DCT-scaled decode at
    the largest M/8 downscale whose shortest edge still covers the resize
    target (PIL ``Image.draft`` semantics)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.srsem_decode(
        str(path).encode(), size, crop_pct, int(fast_jpeg),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def decode_batch(paths: Sequence[str], size: int, crop_pct: float = 1.0,
                 n_threads: int = 16,
                 fast_jpeg: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch in C++ worker threads → (images (N, size, size, 3)
    uint8, ok (N,) bool).  Failed rows are zero-filled with ok False (the
    NaN-row contract upstream).  Raises without the library."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_build_error}")
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    status = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.srsem_decode_batch(
        arr, n, size, crop_pct, int(fast_jpeg),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    return out, status == 0
