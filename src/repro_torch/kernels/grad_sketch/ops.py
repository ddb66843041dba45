"""Dispatch for the gradient-sketch projection.

``sketch_flat`` projects a flat (n, P) gradient stack through the
seeded ±1 matrix into an (n, d) sketch: its CUDA kernel on CUDA
tensors, its plain version (``ref``) on CPU tensors, and nothing else
(``repro_torch.kernels.dispatch``). It counts its kernel launches in
``sketch_flat.launches``.

Unlike the reference's ``sketch_pytree``, which sketches leaf by leaf
(small leaves through a materialised sign block, the rest through the
kernel or tiled XLA) with offsets advancing by leaf size, the port
projects an agent's whole flat row in one launch at offset 0. The
projection is linear and its signs positional, so that equals the
reference's per-leaf sum up to the order of the fp32 adds. Any ``dim``
works: there is no alignment branch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.dispatch import resolve
from repro_torch.kernels.grad_sketch import ref

MAX_ROWS = 16 * 65535        # grid z · 16 rows per block
MAX_DIM = 128 * 65535        # grid y · 128 dims per block


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures
    declared (pointers and the stream as c_void_p, never as int)."""
    from repro_torch.kernels import cuda_build
    lib, _ = cuda_build.load("grad_sketch")
    p, i, ll, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_uint32)
    lib.grad_sketch_chunks.argtypes = [i, ll, i, ctypes.POINTER(ll)]
    lib.grad_sketch_chunks.restype = i
    lib.grad_sketch.argtypes = [p, p, p, i, ll, i, u32, u32, ll, i, i, p]
    lib.grad_sketch.restype = i
    lib.grad_sketch_error_string.argtypes = [i]
    lib.grad_sketch_error_string.restype = ctypes.c_char_p
    return lib


def sketch_flat(G: torch.Tensor, seed: int, dim: int, offset: int = 0, *,
                impl: str = "auto") -> torch.Tensor:
    """G (n, P) fp32, seed a host int (an int32 as ``fold_seed`` makes
    it) → G · S (n, dim) fp32, S[p, j] = sign of (seed, offset + p, j)."""
    if resolve(impl, G) == "plain":
        return ref.sketch_flat(G, seed, dim, offset)
    if G.dtype != torch.float32 or G.ndim != 2 or not G.is_contiguous():
        raise ValueError(
            f"G must be a contiguous (n, P) float32 tensor, got "
            f"{tuple(G.shape)} {G.dtype} contiguous={G.is_contiguous()}")
    n, p = G.shape
    if not (1 <= n <= MAX_ROWS and p >= 1 and 1 <= dim <= MAX_DIM):
        raise ValueError(
            f"kernel takes 1 <= n <= {MAX_ROWS}, P >= 1, 1 <= dim <= "
            f"{MAX_DIM}; got (n, P, dim) = {(n, p, dim)}")
    lib = _lib()
    chunk = ctypes.c_longlong()
    chunks = lib.grad_sketch_chunks(n, p, dim, ctypes.byref(chunk))
    partial = torch.empty((chunks, n, dim), dtype=torch.float32,
                          device=G.device)
    out = torch.empty((n, dim), dtype=torch.float32, device=G.device)
    status = lib.grad_sketch(
        G.data_ptr(), partial.data_ptr(), out.data_ptr(), n, p, dim,
        int(seed) & ref.MASK32, int(offset) & ref.MASK32, chunk.value,
        chunks, G.device.index,
        torch.cuda.current_stream(G.device).cuda_stream)
    if status != 0:
        raise RuntimeError(
            f"grad_sketch launch failed: "
            f"{lib.grad_sketch_error_string(status).decode()}")
    sketch_flat.launches += 1
    return out


sketch_flat.launches = 0
