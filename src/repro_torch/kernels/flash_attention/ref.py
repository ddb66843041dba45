"""Plain PyTorch version of the flash-attention kernel — the port of
``repro.kernels.flash_attention.ref::attention``: materialised fp32
scores, the causal and sliding-window mask by index, GQA by repeating
k and v onto the query heads.

    o[b, i, h] = Σ_{j ≤ i, i − j < W} softmax_j(q_i · k_j · scale) v_j

with kv head ``h // (H / K)`` and W the window (none: S). Inputs are read as fp32 whatever their
dtype; the result is in q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, K, D) with H % K == 0.
    Returns (B, S, H, D) in q.dtype. Softmax in fp32."""
    B, S, H, D = q.shape
    K = k.shape[2]
    rep = H // K
    kk = torch.repeat_interleave(k, rep, dim=2)
    vv = torch.repeat_interleave(v, rep, dim=2)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    f32 = torch.float32
    scores = torch.einsum("bihd,bjhd->bhij", q.to(f32), kk.to(f32)) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= (i - j) < window
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhij,bjhd->bihd", p, vv.to(f32))
    return out.to(q.dtype)
