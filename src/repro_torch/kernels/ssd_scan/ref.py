"""Plain PyTorch version of the SSD intra-chunk kernel — the port of
``repro.kernels.ssd_scan.ref``, the einsum dual form of
``repro.models.ssd`` (arXiv:2405.21060 §6).

Within a chunk of l steps, head h:

    y[i] = Σ_{j ≤ i} (C_i · B_j) · exp(cs_i − cs_j) · dt_j · x_j

with cs the inclusive cumsum of dt·A over the chunk. Inputs are read
as fp32 whatever their dtype; the result is fp32.
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
    L = torch.where(causal, torch.exp(diff), torch.zeros((), dtype=f32,
                                                         device=cs.device))
    scores = torch.einsum("bcihn,bcjhn->bchij",
                          heads_of(Cc, h).to(f32), heads_of(Bc, h).to(f32))
    scores = scores * L * torch.movedim(dtc, 3, 2)[..., None, :]
    return torch.einsum("bchij,bcjhp->bcihp", scores, xc.to(f32))
