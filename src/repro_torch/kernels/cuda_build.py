"""Build the port's CUDA sources at first use and load them with ctypes.

Each kernel source under ``repro_torch/kernels/<name>/csrc/`` exposes a
plain C interface (device pointers, sizes and the CUDA stream in, the
launch status out), so it compiles with ``nvcc`` alone in seconds and
never includes PyTorch's headers. The shared library goes to
``build/repro_torch_ext/`` at the root of the checkout, a directory
git ignores. Nothing here runs at import time, and a failed build
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_ext"
KERNELS_DIR = Path(__file__).resolve().parent
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: Dict[str, Tuple[ctypes.CDLL, str]] = {}
_lock = threading.Lock()            # guards _locks
_locks: Dict[str, threading.Lock] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "port's CUDA kernels are built from source at first use")
    return found


def source_of(name: str) -> Path:
    """``kernels/<name>/csrc/<name>.cu``."""
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def build(name: str) -> Tuple[Path, str]:
    """Compile kernel source ``name`` into ``BUILD_DIR/<name>.so``.
    Returns (library path, compiler output, with ptxas's register and
    spill report)."""
    src = source_of(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [nvcc_path(), "-Xptxas", "-v", *ARCH_FLAGS, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=False)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {src}:\n{proc.stdout}")
    lib = BUILD_DIR / f"{name}.so"
    os.replace(tmp, lib)              # atomic: a reader never sees half
    return lib, proc.stdout


def load(name: str) -> Tuple[ctypes.CDLL, str]:
    """The kernel library ``name`` and its compiler output, built and
    loaded once per process (a library left by another process may be
    stale, so it is never reused). Each source has its own lock, so
    threads loading different sources run their ``nvcc`` together."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            path, log = build(name)
            _loaded[name] = (ctypes.CDLL(str(path)), log)
        return _loaded[name]
