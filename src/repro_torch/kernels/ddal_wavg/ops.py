"""Dispatch for the eq. 4 share-step kernels.

``fused_wavg`` (the default ``store`` combiner's share step) and
``wavg`` (the legacy path, weights given) take the whole group's
stores at once: G (n, m, P). Each runs its CUDA kernel on CUDA tensors
and its plain version (``ref``) on CPU tensors, and nothing else: a
build or launch failure raises, and ``impl`` can only name the path
the tensors' device implies (``"auto"`` picks it). Each wrapper counts
its kernel launches in ``<wrapper>.launches``, so a run can show that
its share steps went through the kernel.

Unlike the reference's ``tree_fused_wavg``, there is no small-leaf
branch: an agent's parameters are one flat row (9155 elements for the
paper's A2C), and one launch covers every agent's store.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.ddal_wavg import ref

IMPLS = ("auto", "cuda", "plain")
MAX_PIECES = 4096           # the kernel stages 2·m floats in smem
MAX_AGENTS = 65535          # grid y


def _resolve(impl: str, G: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    want = "cuda" if G.is_cuda else "plain"
    if impl not in ("auto", want):
        raise ValueError(
            f"impl={impl!r} cannot run on {G.device} tensors: CUDA "
            f"tensors take the kernel, CPU tensors its plain version")
    return want


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures
    declared (pointers and the stream as c_void_p, never as int)."""
    from repro_torch.kernels import cuda_build
    lib, _ = cuda_build.load("ddal_wavg")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ddal_fused_wavg.argtypes = [p, p, p, p, p, p, i, i, ll, i, p]
    lib.ddal_fused_wavg.restype = i
    lib.ddal_wavg.argtypes = [p, p, p, i, i, ll, i, p]
    lib.ddal_wavg.restype = i
    lib.ddal_error_string.argtypes = [i]
    lib.ddal_error_string.restype = ctypes.c_char_p
    return lib


def _check(G: torch.Tensor, meta: dict) -> Tuple[int, int, int]:
    if G.dtype != torch.float32 or G.ndim != 3 or not G.is_contiguous():
        raise ValueError(
            f"G must be a contiguous (n, m, P) float32 tensor, got "
            f"{tuple(G.shape)} {G.dtype} contiguous={G.is_contiguous()}")
    n, m, p = G.shape
    if not (1 <= n <= MAX_AGENTS and 1 <= m <= MAX_PIECES and p >= 1):
        raise ValueError(
            f"kernel takes 1 <= n <= {MAX_AGENTS}, 1 <= m <= "
            f"{MAX_PIECES}, P >= 1; got (n, m, P) = {(n, m, p)}")
    for name, (x, dtype) in meta.items():
        if (x.dtype != dtype or tuple(x.shape) != (n, m)
                or not x.is_contiguous() or x.device != G.device):
            raise ValueError(
                f"{name} must be a contiguous ({n}, {m}) {dtype} tensor "
                f"on {G.device}, got {tuple(x.shape)} {x.dtype} on "
                f"{x.device}")
    return n, m, p


def _raise_on(lib, status: int, what: str):
    if status != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.ddal_error_string(status).decode()}")


def fused_wavg(G: torch.Tensor, T: torch.Tensor, R: torch.Tensor,
               valid: torch.Tensor, *, impl: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused eq. 4 share step for every agent: G (n, m, P), T, R
    (n, m) fp32, valid (n, m) bool → (ḡ (n, P) fp32, Σw (n,) fp32)."""
    if _resolve(impl, G) == "plain":
        return ref.fused_wavg(G, T, R, valid)
    n, m, p = _check(G, {"T": (T, torch.float32), "R": (R, torch.float32),
                         "valid": (valid, torch.bool)})
    out = torch.empty((n, p), dtype=torch.float32, device=G.device)
    wsum = torch.empty((n,), dtype=torch.float32, device=G.device)
    lib = _lib()
    status = lib.ddal_fused_wavg(
        G.data_ptr(), T.data_ptr(), R.data_ptr(), valid.data_ptr(),
        out.data_ptr(), wsum.data_ptr(), n, m, p, G.device.index,
        torch.cuda.current_stream(G.device).cuda_stream)
    _raise_on(lib, status, "ddal_fused_wavg")
    fused_wavg.launches += 1
    return out, wsum


def wavg(G: torch.Tensor, w: torch.Tensor, *, impl: str = "auto"
         ) -> torch.Tensor:
    """Σ_j w_j·G[j] for every agent: G (n, m, P), w (n, m) fp32 →
    (n, P) fp32."""
    if _resolve(impl, G) == "plain":
        return ref.wavg(G, w)
    n, m, p = _check(G, {"w": (w, torch.float32)})
    out = torch.empty((n, p), dtype=torch.float32, device=G.device)
    lib = _lib()
    status = lib.ddal_wavg(
        G.data_ptr(), w.data_ptr(), out.data_ptr(), n, m, p,
        G.device.index, torch.cuda.current_stream(G.device).cuda_stream)
    _raise_on(lib, status, "ddal_wavg")
    wavg.launches += 1
    return out


fused_wavg.launches = 0
wavg.launches = 0


def reset_launches() -> None:
    fused_wavg.launches = 0
    wavg.launches = 0
