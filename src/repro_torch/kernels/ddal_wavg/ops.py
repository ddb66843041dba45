"""Dispatch for the eq. 4 share-step kernels.

``fused_wavg`` (the default ``store`` combiner's share step),
``fused_wavg_q`` (its int8 twin, for stores built with
``knowledge_quant_block > 0``) and ``wavg`` (the legacy path, weights
given) take the whole group's stores at once: G (n, m, P). Each runs
its CUDA kernel on CUDA tensors and its plain version (``ref``) on CPU
tensors, and nothing else: the tensors' device is the only switch.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a
run can show that its share steps went through the kernel. The
kernels' launch geometry is computed here (``wavg_geometry``,
``wavg_q_geometry``), where the CPU tests can hold it.

Unlike the reference's ``tree_fused_wavg`` / ``tree_fused_wavg_q``,
there is no small-leaf branch: an agent's parameters are one flat row
(9155 elements for the paper's A2C), and one launch covers every
agent's store. The int8 blocks still restart at every leaf of that row
(``repro_torch.common.pytree.BlockLayout``), as the reference's
per-leaf quantization has them.

``quantize_tree`` / ``dequantize_tree`` (the reference's
``ddal_wavg/ops.py:201,217``) are the int8 round trip over a tree of
stacked leaves that the streaming trainer's combiners push its window
through: plain PyTorch on both devices, as in the reference, where
they are XLA ops and no kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.common.pytree import BlockLayout, tree_map
from repro_torch.kernels.ddal_wavg import ref

MAX_PIECES = 4096           # the kernels stage m weights in smem
MAX_AGENTS = 65535          # grid y
SMS = 132                   # the H100 SXM's streaming multiprocessors
MAX_GRID_X = 2 ** 31 - 1
# Each kernel: *_THREADS threads per block, BATCH pieces held in
# registers at a time (the least of *_BATCHES that covers m), and
# ITEMS = 32 / BATCH positions per thread where the grid keeps
# *_MIN_BLOCKS_PER_SM blocks per SM (else 1). fp32 kernel:
F32_THREADS = 64
F32_BATCHES = (8, 16, 32)
F32_MIN_BLOCKS_PER_SM = 4
# int8 kernel (a position's q bytes and scales take twice the registers
# of its fp32 values):
Q_THREADS = 64
Q_BATCHES = (8, 16, 32)
Q_MIN_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures
    declared (pointers and the stream as c_void_p, never as int)."""
    from repro_torch.kernels import cuda_build
    lib, _ = cuda_build.load("ddal_wavg")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ddal_fused_wavg.argtypes = [p, p, p, p, p, p, i, i, ll, i, i, i,
                                    i, p]
    lib.ddal_fused_wavg.restype = i
    lib.ddal_wavg.argtypes = [p, p, p, i, i, ll, i, i, i, i, p]
    lib.ddal_wavg.restype = i
    lib.ddal_fused_wavg_q.argtypes = [p, p, p, p, p, p, p, p, i, i, ll, i,
                                      i, i, i, i, p]
    lib.ddal_fused_wavg_q.restype = i
    lib.ddal_error_string.argtypes = [i]
    lib.ddal_error_string.restype = ctypes.c_char_p
    return lib


def _check(G: torch.Tensor, meta: dict, dtype=torch.float32
           ) -> Tuple[int, int, int]:
    if G.dtype != dtype or G.ndim != 3 or not G.is_contiguous():
        raise ValueError(
            f"G must be a contiguous (n, m, P) {dtype} tensor, got "
            f"{tuple(G.shape)} {G.dtype} contiguous={G.is_contiguous()}")
    n, m, p = G.shape
    if not (1 <= n <= MAX_AGENTS and 1 <= m <= MAX_PIECES and p >= 1):
        raise ValueError(
            f"kernel takes 1 <= n <= {MAX_AGENTS}, 1 <= m <= "
            f"{MAX_PIECES}, P >= 1; got (n, m, P) = {(n, m, p)}")
    for name, (x, x_dtype) in meta.items():
        if (x.dtype != x_dtype or tuple(x.shape) != (n, m)
                or not x.is_contiguous() or x.device != G.device):
            raise ValueError(
                f"{name} must be a contiguous ({n}, {m}) {x_dtype} tensor "
                f"on {G.device}, got {tuple(x.shape)} {x.dtype} on "
                f"{x.device}")
    return n, m, p


class WavgGeometry(NamedTuple):
    """A share-step kernel's grid (blocks, n) of blocks of ``threads``:
    block b of an agent takes positions b·span .. b·span + span - 1
    (span = threads·items; the last block masks the ragged end), thread
    t of it positions t, t + threads, ...; ``batch`` pieces are held in
    registers at a time."""
    items: int
    batch: int
    blocks: int


def _geometry(n: int, m: int, P: int, threads: int, batches, min_blocks
              ) -> WavgGeometry:
    """batches[-1] / batch positions per thread where that grid still
    holds ``min_blocks`` blocks per SM (long planes), else one (the
    paper's P = 9155)."""
    batch = next(b for b in batches if b >= min(m, batches[-1]))
    items = batches[-1] // batch
    blocks = -(-P // (threads * items))
    if n * blocks < min_blocks * SMS:
        items, blocks = 1, -(-P // threads)
    if blocks > MAX_GRID_X:
        raise ValueError(f"P = {P} needs {blocks} blocks per agent, more "
                         f"than the grid's {MAX_GRID_X}")
    return WavgGeometry(items, batch, blocks)


def wavg_geometry(n: int, m: int, P: int) -> WavgGeometry:
    """The fp32 kernel's geometry (``fused_wavg`` and ``wavg``)."""
    return _geometry(n, m, P, F32_THREADS, F32_BATCHES,
                     F32_MIN_BLOCKS_PER_SM)


def wavg_q_geometry(n: int, m: int, P: int) -> WavgGeometry:
    """The int8 kernel's geometry (``fused_wavg_q``)."""
    return _geometry(n, m, P, Q_THREADS, Q_BATCHES, Q_MIN_BLOCKS_PER_SM)


def _raise_on(lib, status: int, what: str):
    if status != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.ddal_error_string(status).decode()}")


def fused_wavg(G: torch.Tensor, T: torch.Tensor, R: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused eq. 4 share step for every agent: G (n, m, P), T, R
    (n, m) fp32, valid (n, m) bool → (ḡ (n, P) fp32, Σw (n,) fp32)."""
    if not G.is_cuda:
        return ref.fused_wavg(G, T, R, valid)
    n, m, p = _check(G, {"T": (T, torch.float32), "R": (R, torch.float32),
                         "valid": (valid, torch.bool)})
    out = torch.empty((n, p), dtype=torch.float32, device=G.device)
    wsum = torch.empty((n,), dtype=torch.float32, device=G.device)
    geo = wavg_geometry(n, m, p)
    lib = _lib()
    status = lib.ddal_fused_wavg(
        G.data_ptr(), T.data_ptr(), R.data_ptr(), valid.data_ptr(),
        out.data_ptr(), wsum.data_ptr(), n, m, p, geo.items, geo.batch,
        geo.blocks, G.device.index,
        torch.cuda.current_stream(G.device).cuda_stream)
    _raise_on(lib, status, "ddal_fused_wavg")
    fused_wavg.launches += 1
    return out, wsum


def fused_wavg_q(Q: torch.Tensor, scale: torch.Tensor, T: torch.Tensor,
                 R: torch.Tensor, valid: torch.Tensor, blocks: BlockLayout
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused eq. 4 share step over int8 stores: Q (n, m, P) int8,
    scale (n, m, blocks.n_blocks) fp32, T, R (n, m) fp32, valid (n, m)
    bool → (ḡ (n, P) fp32, Σw (n,) fp32), dequantised as q·s in the
    loop; ``blocks`` says which scale column each position reads."""
    if not Q.is_cuda:
        return ref.fused_wavg_q(Q, scale, T, R, valid, blocks)
    n, m, p = _check(Q, {"T": (T, torch.float32), "R": (R, torch.float32),
                         "valid": (valid, torch.bool)}, dtype=torch.int8)
    nb = blocks.n_blocks
    if p != blocks.size:
        raise ValueError(f"rows have {p} elements, the block layout "
                         f"{blocks.size}")
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (n, m, nb)
            or not scale.is_contiguous() or scale.device != Q.device):
        raise ValueError(
            f"scale must be a contiguous ({n}, {m}, {nb}) float32 tensor "
            f"on {Q.device}, got {tuple(scale.shape)} {scale.dtype} on "
            f"{scale.device}")
    geo = wavg_q_geometry(n, m, p)
    cols = blocks.on(Q.device)[0]
    out = torch.empty((n, p), dtype=torch.float32, device=Q.device)
    wsum = torch.empty((n,), dtype=torch.float32, device=Q.device)
    lib = _lib()
    status = lib.ddal_fused_wavg_q(
        Q.data_ptr(), scale.data_ptr(), cols.data_ptr(), T.data_ptr(),
        R.data_ptr(), valid.data_ptr(), out.data_ptr(), wsum.data_ptr(),
        n, m, p, nb, geo.items, geo.batch, geo.blocks, Q.device.index,
        torch.cuda.current_stream(Q.device).cuda_stream)
    _raise_on(lib, status, "ddal_fused_wavg_q")
    fused_wavg_q.launches += 1
    return out, wsum


def wavg(G: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_j w_j·G[j] for every agent: G (n, m, P), w (n, m) fp32 →
    (n, P) fp32."""
    if not G.is_cuda:
        return ref.wavg(G, w)
    n, m, p = _check(G, {"w": (w, torch.float32)})
    out = torch.empty((n, p), dtype=torch.float32, device=G.device)
    geo = wavg_geometry(n, m, p)
    lib = _lib()
    status = lib.ddal_wavg(
        G.data_ptr(), w.data_ptr(), out.data_ptr(), n, m, p, geo.items,
        geo.batch, geo.blocks, G.device.index,
        torch.cuda.current_stream(G.device).cuda_stream)
    _raise_on(lib, status, "ddal_wavg")
    wavg.launches += 1
    return out


fused_wavg.launches = 0
fused_wavg_q.launches = 0
wavg.launches = 0


def quantize_tree(tree, q_block: int, lead: int = 1):
    """Every leaf's trailing (parameter) axes into int8 blocks of
    ``q_block``, its ``lead`` leading axes kept. Returns (qtree, stree):
    int8 leaves of the input's shapes, and fp32 scale leaves (*lead,
    ⌈p / q_block⌉)."""
    pairs = tree_map(lambda x: ref.quantize_rows(
        x.reshape(x.shape[:lead] + (-1,)), q_block), tree)
    qtree = tree_map(lambda x, pr: pr[0].reshape(x.shape), tree, pairs)
    stree = tree_map(lambda pr: pr[1], pairs)
    return qtree, stree


def dequantize_tree(qtree, stree, q_block: int):
    """The inverse of :func:`quantize_tree` → an fp32 tree of qtree's
    shapes (the lead axes recovered from each scale leaf's rank)."""
    def leaf(q, s):
        lead = s.ndim - 1
        flat = q.reshape(q.shape[:lead] + (-1,))
        return ref.dequantize_rows(flat, s, q_block).reshape(q.shape)
    return tree_map(leaf, qtree, stree)
