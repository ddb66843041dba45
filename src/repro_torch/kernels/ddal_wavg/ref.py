"""Plain PyTorch versions of the eq. 4 share-step kernels, and the
int8 knowledge-plane wire format (port of
``repro.kernels.ddal_wavg.ref``).

The share steps perform the CUDA kernels' float ops in the kernels'
order — the eq. 4 weights with left-to-right sums (``eq4_weights``),
then acc ← acc + w_j·G[j] (int8: acc ← acc + w_j·(q_j·s_j)) for
j = 0..m-1 in fp32, each a separately rounded multiply and add — so on
the card a kernel and its plain version agree to the bit, and on the
CPU the port's wrappers run these. They repeat the kernel's arithmetic
and are no yardstick of speed.

``quantize_flat`` / ``dequantize_flat`` are the wire format itself,
plain PyTorch on both devices, as the reference computes it outside
any kernel: ``q_block`` consecutive elements of a leaf share one fp32
scale ``max|x| / 127``, and values quantize by ``rint(x / scale)``
(a true division, rounding half to even) clipped to ±127. The scale is
taken as ``max|x| · f32(1/127)``: the reference's source divides by
the constant 127.0, and XLA, which compiles the trainer's step,
rewrites that division into this multiply, so these are the scales the
reference's trainer ships (an op-by-op, uncompiled ``quantize_tree``
divides, and differs by one ulp on a few per cent of blocks). A flat row
holds many leaves, and the blocks restart at each
(``repro_torch.common.pytree.BlockLayout``): the row is gathered into
the zero-padded grid of whole blocks, quantized there with the
reference's ops, and gathered back, so ``q`` and ``scale`` are bitwise
the reference's ``quantize_tree``. ``quantize_rows`` /
``dequantize_rows`` are the same wire format over rows that hold one
leaf each (the streaming trainer's stacked leaves): the reference's
``quantize_flat`` / ``dequantize_flat`` op for op, with the scale taken
as above.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.pytree import BlockLayout, column_chunks
from repro_torch.core.weighting import eq4_weights, sequential_sum


def wavg(G: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_j w_j·G[j] per agent: G (n, m, P), w (n, m) → (n, P) fp32."""
    acc = torch.zeros(G.shape[:-2] + G.shape[-1:], dtype=torch.float32,
                      device=G.device)
    for j in range(G.shape[-2]):
        acc = acc + w[..., j, None].to(torch.float32) * G[..., j, :]
    return acc


def fused_wavg(G: torch.Tensor, T: torch.Tensor, R: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ḡ (n, P), Σw (n,)) from the raw metadata T, R, valid (n, m)."""
    w = eq4_weights(T, R, valid)
    return wavg(G, w), sequential_sum(w)


#: columns the int8 step dequantises at a time: its fp32 temporaries are
#: (n, Q_CHUNK) whatever P, so it never holds a dequantised plane (the
#: reference's streaming-dequant bound, ``bench_wavg_kernel``'s gate 3)
Q_CHUNK = 1 << 18


def fused_wavg_q(Q: torch.Tensor, scale: torch.Tensor, T: torch.Tensor,
                 R: torch.Tensor, valid: torch.Tensor, blocks: BlockLayout
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ḡ (n, P), Σw (n,)) over int8 pieces Q (n, m, P) with scales
    (n, m, nb) laid out by ``blocks``, ``Q_CHUNK`` columns at a time
    (each element's ops are the same whatever the chunk)."""
    cols = blocks.on(Q.device)[0]
    w = eq4_weights(T, R, valid)
    out = torch.zeros(Q.shape[:-2] + Q.shape[-1:], dtype=torch.float32,
                      device=Q.device)
    for sl in column_chunks(Q.shape[-1], Q_CHUNK):
        for j in range(Q.shape[-2]):
            x = Q[..., j, sl].to(torch.float32) * scale[
                ..., j, :].index_select(-1, cols[sl])
            out[..., sl].add_(w[..., j, None] * x)
    return out, sequential_sum(w)


def quantize_flat(G: torch.Tensor, blocks: BlockLayout
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows G (..., P) → (q (..., P) int8, scale (..., nb) fp32)."""
    _, padded, unpadded = blocks.on(G.device)
    lead = G.shape[:-1]
    Gf = G.to(torch.float32)
    # one zero column: the pad slots of each leaf's last block read it
    ext = torch.cat([Gf, torch.zeros(lead + (1,), dtype=torch.float32,
                                     device=G.device)], dim=-1)
    Gb = ext.index_select(-1, padded).reshape(
        lead + (blocks.n_blocks, blocks.q_block))
    # f32(1/127): the Python float rounds to the same fp32 value as
    # XLA's folded constant, on both devices
    scale = torch.amax(torch.abs(Gb), dim=-1) * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(Gb / safe[..., None]), -127, 127)
    q = q.to(torch.int8).reshape(lead + (-1,)).index_select(-1, unpadded)
    return q, scale


def dequantize_flat(q: torch.Tensor, scale: torch.Tensor,
                    blocks: BlockLayout) -> torch.Tensor:
    """The inverse wire transform: q · scale of each element's block →
    fp32 rows of q's shape."""
    cols = blocks.on(q.device)[0]
    return q.to(torch.float32) * scale.index_select(-1, cols)


def quantize_rows(G: torch.Tensor, q_block: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows of one leaf G (..., p) → (q (..., p) int8, scale (...,
    ⌈p / q_block⌉) fp32). A short last block is zero-padded for its
    scale's max only; ``q`` keeps G's shape."""
    p = G.shape[-1]
    nb = -(-p // q_block)
    pad = nb * q_block - p
    lead = G.shape[:-1]
    Gf = G.to(torch.float32)
    if pad:
        Gf = torch.nn.functional.pad(Gf, (0, pad))
    Gb = Gf.reshape(lead + (nb, q_block))
    scale = torch.amax(torch.abs(Gb), dim=-1) * (1.0 / 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(Gb / safe[..., None]), -127, 127)
    q = q.to(torch.int8).reshape(lead + (nb * q_block,))
    return (q[..., :p] if pad else q), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    q_block: int) -> torch.Tensor:
    """The inverse of ``quantize_rows``: q · scale of each element's
    block → fp32 of q's shape."""
    p = q.shape[-1]
    nb = scale.shape[-1]
    pad = nb * q_block - p
    lead = q.shape[:-1]
    qp = torch.nn.functional.pad(q, (0, pad)) if pad else q
    x = (qp.reshape(lead + (nb, q_block)).to(torch.float32)
         * scale[..., None]).reshape(lead + (nb * q_block,))
    return x[..., :p] if pad else x
