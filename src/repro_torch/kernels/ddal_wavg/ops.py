"""Dispatch for the eq. 4 share-step kernels.

``fused_wavg`` (the default ``store`` combiner's share step),
``fused_wavg_q`` (its int8 twin, for stores built with
``knowledge_quant_block > 0``) and ``wavg`` (the legacy path, weights
given) take the whole group's stores at once: G (n, m, P). Each runs
its CUDA kernel on CUDA tensors and its plain version (``ref``) on CPU
tensors, and nothing else: the tensors' device is the only switch.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a
run can show that its share steps went through the kernel. The int8
kernel's launch geometry is computed here (``wavg_q_geometry``), where
the CPU tests can hold it.

Unlike the reference's ``tree_fused_wavg`` / ``tree_fused_wavg_q``,
there is no small-leaf branch: an agent's parameters are one flat row
(9155 elements for the paper's A2C), and one launch covers every
agent's store. The int8 blocks still restart at every leaf of that row
(``repro_torch.common.pytree.BlockLayout``), as the reference's
per-leaf quantization has them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.common.pytree import BlockLayout
from repro_torch.kernels.ddal_wavg import ref

MAX_PIECES = 4096           # the kernels stage up to 2·m floats in smem
MAX_AGENTS = 65535          # grid y
SMS = 132                   # the H100 SXM's streaming multiprocessors
MAX_GRID_X = 2 ** 31 - 1
# int8 kernel: Q_THREADS threads per block, BATCH pieces held in
# registers at a time (the least of Q_BATCHES that covers m), and
# ITEMS = 32 / BATCH positions per thread where the grid keeps
# Q_MIN_BLOCKS_PER_SM blocks per SM (else 1)
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
    lib.ddal_fused_wavg.argtypes = [p, p, p, p, p, p, i, i, ll, i, p]
    lib.ddal_fused_wavg.restype = i
    lib.ddal_wavg.argtypes = [p, p, p, i, i, ll, i, p]
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


class WavgQGeometry(NamedTuple):
    """The int8 kernel's grid (blocks, n) of ``Q_THREADS``-thread
    blocks: block b of an agent takes positions b·span .. b·span + span
    - 1 (span = Q_THREADS·items; the last block masks the ragged end),
    thread t of it positions t, t + Q_THREADS, ...; ``batch`` pieces are
    held in registers at a time."""
    items: int
    batch: int
    blocks: int


def wavg_q_geometry(n: int, m: int, P: int) -> WavgQGeometry:
    """32 / batch positions per thread where that grid still holds
    ``Q_MIN_BLOCKS_PER_SM`` blocks per SM (long planes), else one
    (the paper's P = 9155)."""
    batch = next(b for b in Q_BATCHES if b >= min(m, Q_BATCHES[-1]))
    items = Q_BATCHES[-1] // batch
    blocks = -(-P // (Q_THREADS * items))
    if n * blocks < Q_MIN_BLOCKS_PER_SM * SMS:
        items, blocks = 1, -(-P // Q_THREADS)
    if blocks > MAX_GRID_X:
        raise ValueError(f"P = {P} needs {blocks} blocks per agent, more "
                         f"than the grid's {MAX_GRID_X}")
    return WavgQGeometry(items, batch, blocks)


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
    lib = _lib()
    status = lib.ddal_fused_wavg(
        G.data_ptr(), T.data_ptr(), R.data_ptr(), valid.data_ptr(),
        out.data_ptr(), wsum.data_ptr(), n, m, p, G.device.index,
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
    lib = _lib()
    status = lib.ddal_wavg(
        G.data_ptr(), w.data_ptr(), out.data_ptr(), n, m, p,
        G.device.index, torch.cuda.current_stream(G.device).cuda_stream)
    _raise_on(lib, status, "ddal_wavg")
    wavg.launches += 1
    return out


fused_wavg.launches = 0
fused_wavg_q.launches = 0
wavg.launches = 0
