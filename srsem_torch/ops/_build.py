"""Build and load the port's CUDA kernels (``srsem_torch/csrc/*.cu``).

Each source compiles at first use with ``nvcc`` into a shared library with
a plain C interface under ``build/srsem_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, and is loaded with
``ctypes``.  A plain C interface keeps a build to
seconds; a source that includes PyTorch's headers takes minutes.  Nothing
compiles at import: the CPU tests import every module.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/srsem_torch/<name>-<hash>.so <src>

``build_all()`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "srsem_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Built:
    """A compiled kernel library and how its build went."""

    lib: ctypes.CDLL
    seconds: float  # 0.0 when the hashed library was already on disk
    log: str        # nvcc's -Xptxas -v output (registers, smem, spills)


_LOCK = threading.Lock()
_LOADED: Dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin) — the "
                           "CUDA kernels build only where the toolkit is")
    return str(path)


def _target(name: str) -> Path:
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in parts)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` (None when the library is already built)."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp, proc, t0: float) -> Built:
    log = ""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or none
    seconds = time.perf_counter() - t0 if proc is not None else 0.0
    return Built(ctypes.CDLL(str(target)), seconds, log)


def sources() -> List[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, Built]:
    """Build (in parallel) and load every kernel source; returns them."""
    with _LOCK:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in sources() if n not in _LOADED}
        for n, (target, tmp, proc) in started.items():
            _LOADED[n] = _finish(n, target, tmp, proc, t0)
        return dict(_LOADED)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LOADED:
            t0 = time.perf_counter()
            _LOADED[name] = _finish(name, *_start(name), t0)
        return _LOADED[name].lib
