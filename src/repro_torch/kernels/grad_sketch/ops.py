"""Dispatch for the gradient-sketch projection.

``sketch_flat`` projects a flat (n, P) gradient stack through the
seeded ±1 matrix into an (n, d) sketch: its CUDA kernel on CUDA
tensors, its plain version (``ref``) on CPU tensors, and nothing else:
the tensors' device is the only switch. It counts its kernel launches
in ``sketch_flat.launches``. The kernel's launch geometry is computed
here (``sketch_geometry``), where the CPU tests can hold it.

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
from typing import NamedTuple

import torch

from repro_torch.kernels.grad_sketch import ref

DIMS_PER_BLOCK = 128         # one sketch dim per thread
ROW_BLOCKS = (1, 2, 4, 8, 16)  # the kernel's row-block instances
MAX_GRID_YZ = 65535
MAX_GRID_X = 2 ** 31 - 1
MAX_ROWS = ROW_BLOCKS[-1] * MAX_GRID_YZ      # grid z · 16 rows per block
MAX_DIM = DIMS_PER_BLOCK * MAX_GRID_YZ       # grid y · 128 dims per block
SMS = 132                    # the H100 SXM's streaming multiprocessors
TARGET_BLOCKS = 16 * SMS     # first pass: about 16 blocks per SM ...
MIN_CHUNK = 32               # ... but no chunk shorter than this
UNROLL = 8                   # a chunk is a multiple of the kernel's unroll
REDUCE_OUTPUTS = 32          # outputs per block of the second pass


class SketchGeometry(NamedTuple):
    """The two passes' launch geometry: the first pass's grid is
    (chunks, ⌈d / 128⌉, ⌈n / rows⌉) blocks of 128 threads, block (c, ·,
    ·) taking positions c·chunk .. min(P, (c + 1)·chunk) - 1; the second
    pass strides ``reduce_blocks`` blocks over the n·d outputs, 32 per
    block."""
    rows: int
    chunk: int
    chunks: int
    reduce_blocks: int

    def grid(self, n: int, d: int):
        return (self.chunks, -(-d // DIMS_PER_BLOCK), -(-n // self.rows))


def sketch_geometry(n: int, P: int, d: int) -> SketchGeometry:
    """Rows per block: the smallest instance that covers n (16 past
    that); chunks: enough for about ``TARGET_BLOCKS`` blocks in the
    first pass, each at least ``MIN_CHUNK`` positions long (a multiple
    of ``UNROLL``), so that small P still gets several blocks per SM."""
    rows = next((r for r in ROW_BLOCKS if r >= n), ROW_BLOCKS[-1])
    others = -(-d // DIMS_PER_BLOCK) * -(-n // rows)
    want = max(1, -(-TARGET_BLOCKS // others))
    chunk = -(-P // want)
    chunk = max(MIN_CHUNK, -(-chunk // UNROLL) * UNROLL)
    chunks = -(-P // chunk)          # at most TARGET_BLOCKS
    reduce_blocks = min(-(-(n * d) // REDUCE_OUTPUTS), MAX_GRID_X)
    return SketchGeometry(rows, chunk, chunks, reduce_blocks)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures
    declared (pointers and the stream as c_void_p, never as int)."""
    from repro_torch.kernels import cuda_build
    lib, _ = cuda_build.load("grad_sketch")
    p, i, ll, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_uint32)
    lib.grad_sketch.argtypes = [p, p, p, i, ll, i, u32, u32, i, ll, i, i,
                                i, p]
    lib.grad_sketch.restype = i
    lib.grad_sketch_error_string.argtypes = [i]
    lib.grad_sketch_error_string.restype = ctypes.c_char_p
    return lib


def sketch_flat(G: torch.Tensor, seed: int, dim: int, offset: int = 0
                ) -> torch.Tensor:
    """G (n, P) fp32, seed a host int (an int32 as ``fold_seed`` makes
    it) → G · S (n, dim) fp32, S[p, j] = sign of (seed, offset + p, j)."""
    if not G.is_cuda:
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
    geo = sketch_geometry(n, p, dim)
    partial = torch.empty((geo.chunks, n, dim), dtype=torch.float32,
                          device=G.device)
    out = torch.empty((n, dim), dtype=torch.float32, device=G.device)
    lib = _lib()
    status = lib.grad_sketch(
        G.data_ptr(), partial.data_ptr(), out.data_ptr(), n, p, dim,
        int(seed) & ref.MASK32, int(offset) & ref.MASK32, geo.rows,
        geo.chunk, geo.chunks, geo.reduce_blocks, G.device.index,
        torch.cuda.current_stream(G.device).cuda_stream)
    if status != 0:
        raise RuntimeError(
            f"grad_sketch launch failed: "
            f"{lib.grad_sketch_error_string(status).decode()}")
    sketch_flat.launches += 1
    return out


sketch_flat.launches = 0
