"""Dispatch for the gradient-sketch projection.

``sketch_flat`` projects a flat (n, P) gradient stack through the
seeded ±1 matrix into an (n, d) sketch: its CUDA kernel on CUDA
tensors, its plain version (``ref``) on CPU tensors, and nothing else:
the tensors' device is the only switch. It counts its kernel launches
in ``sketch_flat.launches``. The kernel's launch geometry is computed
here (``sketch_geometry``), where the CPU tests can hold it.

The buffer trainer projects an agent's whole flat row in one launch
at offset 0. The streaming trainer's gradients are trees of stacked
(n, *param) leaves, and ``sketch_pytree`` (the reference's
``grad_sketch/ops.py:115``) streams them leaf by leaf: each leaf is
viewed as (n, p) and goes through ``sketch_flat`` at a running offset,
one launch per leaf, so the (n, P) concat is never built. Leaves go in
``jax.tree_util`` order (dict keys sorted), which fixes every offset
and so every sign. Unlike the reference there is no small-leaf branch:
every leaf takes the kernel on the card. The projection is linear and
its signs positional, so the result equals the reference's up to the
order of the fp32 adds. Any ``dim`` works: there is no alignment
branch.

On the model axis of a ``(data, model)`` mesh a rank holds a slice of
a leaf (``repro_torch.common.sharding.LeafShard``), and its sketch is
the partial G·S over the positions the slice holds in the full leaf:
a split of the leading dim is one contiguous range (a plain offset), a
column split a strided set, which ``sketch_flat``'s ``position_map`` =
(row stride, column offset, local width) passes to the kernel's
strided instances. ``sketch_pytree(..., shards=)`` sketches each leaf
the rank owns that way (a replicated leaf on model rank 0 only), so
the sum over the model axis of the ranks' sketches is the full tree's
sketch up to the order of the fp32 adds.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.common.pytree import tree_leaves_with_paths
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
    lib.grad_sketch.argtypes = [p, p, p, i, ll, i, u32, u32, ll, ll, ll, i,
                                ll, i, i, i, p]
    lib.grad_sketch.restype = i
    lib.grad_sketch_error_string.argtypes = [i]
    lib.grad_sketch_error_string.restype = ctypes.c_char_p
    return lib


def _contiguous_map(p: int, offset: int, position_map):
    """(offset, position map) with a map that is one contiguous range
    (a single row, or rows that follow each other) folded into the
    offset."""
    if position_map is None:
        return offset, None
    stride, c0, width = (int(v) for v in position_map)
    if width < 1 or p % width or stride < width or c0 + width > stride:
        raise ValueError(f"position map (stride, c0, width) = "
                         f"{(stride, c0, width)} does not fit P = {p}")
    if p == width or stride == width:
        return offset + c0, None
    return offset, (stride, c0, width)


def sketch_flat(G: torch.Tensor, seed: int, dim: int, offset: int = 0,
                position_map=None) -> torch.Tensor:
    """G (n, P) fp32, seed a host int (an int32 as ``fold_seed`` makes
    it) → G · S (n, dim) fp32, S[p, j] = sign of (seed, offset + p, j);
    with ``position_map`` = (stride, c0, width), of (seed, offset + (p //
    width) · stride + c0 + p % width, j)."""
    offset, position_map = _contiguous_map(G.shape[1], offset, position_map)
    if not G.is_cuda:
        return ref.sketch_flat(G, seed, dim, offset,
                               position_map=position_map)
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
    stride, c0, width = position_map or (0, 0, 0)
    status = lib.grad_sketch(
        G.data_ptr(), partial.data_ptr(), out.data_ptr(), n, p, dim,
        int(seed) & ref.MASK32, int(offset) & ref.MASK32, stride, c0, width,
        geo.rows,
        geo.chunk, geo.chunks, geo.reduce_blocks, G.device.index,
        torch.cuda.current_stream(G.device).cuda_stream)
    if status != 0:
        raise RuntimeError(
            f"grad_sketch launch failed: "
            f"{lib.grad_sketch_error_string(status).decode()}")
    sketch_flat.launches += 1
    return out


sketch_flat.launches = 0


def sketch_leaf(x: torch.Tensor, seed: int, dim: int, offset: int = 0,
                shard=None) -> torch.Tensor:
    """One stacked leaf (n, *param) → its (n, d) sketch contribution at
    positions offset .. offset + p − 1, p = |param|; with ``shard`` (a
    ``LeafShard``: ``x`` is the rank's slice of the full leaf) at the
    slice's positions in the full leaf. fp32 leaves are viewed, never
    copied; another dtype is cast to fp32 first."""
    n = x.shape[0]
    G = x.reshape(n, -1)
    if G.dtype != torch.float32:
        G = G.to(torch.float32)
    return sketch_flat(G.contiguous(), seed, dim, offset,
                       None if shard is None else shard.position_map())


def sketch_pytree(grads, seed: int, dim: int, shards=None) -> torch.Tensor:
    """A tree of stacked leaves (n, *param) → its (n, d) sketch, equal
    to projecting the agents' flat concatenated rows at offset 0: one
    ``sketch_flat`` per leaf, offsets advancing by leaf size in
    ``jax.tree_util`` order. With ``shards`` (a ``ModelShards``: the
    leaves are the rank's slices) the rank's partial sketch: each owned
    leaf at its slice's positions, offsets advancing by the full leaves'
    sizes."""
    leaves = [x for _, x in tree_leaves_with_paths(grads)]
    if not leaves:
        raise ValueError("sketch_pytree needs at least one leaf")
    n = leaves[0].shape[0]
    acc = torch.zeros((n, dim), dtype=torch.float32,
                      device=leaves[0].device)
    offset = 0
    for i, x in enumerate(leaves):
        if shards is None:
            acc = acc + sketch_leaf(x, seed, dim, offset)
            offset += x.numel() // n
            continue
        leaf = shards.leaves[i]
        if shards.owned[i]:
            acc = acc + sketch_leaf(x, seed, dim, offset, leaf)
        offset += math.prod(leaf.shape)
    return acc
