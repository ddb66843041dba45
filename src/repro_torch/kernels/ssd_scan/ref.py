"""Plain PyTorch version of the SSD intra-chunk kernel — the port of
``repro.kernels.ssd_scan.ref``, the einsum dual form of
``repro.models.ssd`` (arXiv:2405.21060 §6).

Within a chunk of l steps, head h:

    y[i] = Σ_{j ≤ i} (C_i · B_j) · exp(cs_i − cs_j) · dt_j · x_j

with cs the inclusive cumsum of dt·A over the chunk. Inputs are read
as fp32 whatever their dtype; the result is fp32. This is also the
form a training pass differentiates (``repro_torch.models.ssd``), so
the decay mask is applied before its exp (see ``ssd_intra_chunk``):
the reference's order gives NaN gradients at a full chunk.
"""
from __future__ import annotations

import torch


def heads_of(t: torch.Tensor, h: int) -> torch.Tensor:
    """(…, g, n) per-group projections → (…, h, n) per head, head
    ``k`` reading group ``k // (h // g)`` (``jnp.repeat`` on the group
    axis). A tensor that already has ``h`` heads is returned as is."""
    g = t.shape[-2]
    if g == h:
        return t
    if h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    return torch.repeat_interleave(t, h // g, dim=-2)


def ssd_intra_chunk(xc: torch.Tensor, dtc: torch.Tensor, cs: torch.Tensor,
                    Bc: torch.Tensor, Cc: torch.Tensor) -> torch.Tensor:
    """Intra-chunk ("diagonal block") output of the SSD dual form.

    xc: (b, nc, l, h, p); dtc, cs: (b, nc, l, h) fp32; Bc, Cc:
    (b, nc, l, g, n) with g dividing h (g = h is the reference's
    layout). Returns y_diag (b, nc, l, h, p) fp32.
    """
    f32 = torch.float32
    h = xc.shape[3]
    l = cs.shape[2]
    cs_h = torch.movedim(cs, 3, 2)                          # (b,nc,h,l)
    diff = cs_h[..., :, None] - cs_h[..., None, :]          # (b,nc,h,l,l)
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=cs.device))
    # the mask goes in before the exp: the same values as the
    # reference's where(causal, exp(diff), 0), but no exp of the
    # positive diff above the diagonal, which overflows at a full
    # chunk (cs_i − cs_j reaches hundreds) and turns that branch's zero
    # cotangent into 0 · inf = NaN in a backward pass
    L = torch.exp(torch.where(causal, diff, torch.full(
        (), -torch.inf, dtype=f32, device=cs.device)))
    scores = torch.einsum("bcihn,bcjhn->bchij",
                          heads_of(Cc, h).to(f32), heads_of(Bc, h).to(f32))
    scores = scores * L * torch.movedim(dtc, 3, 2)[..., None, :]
    return torch.einsum("bchij,bcjhp->bcihp", scores, xc.to(f32))
