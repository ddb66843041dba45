"""Shared layer primitives — the port of the parts of
``repro.models.common`` the SSM and dense families use: RMSNorm, the
parameter initialisers, the position-mask bias, the materialised
softmax attention and the token-mean cross-entropy.

The initialisers draw from a ``torch.Generator``, so they give the
reference's distributions (a truncated normal of fan-in scale, a
normal of std 0.02), not its bits: tests that need both sides on the
same weights carry them across with ``repro_torch.interop``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def per_row(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (C,) weight as it is, or a (B, C) weight — one row per batch
    row, the group engine's per-slot weights — shaped to broadcast
    against ``like`` (B, ..., C)."""
    if w.ndim == 1:
        return w
    return w.reshape(w.shape[0], *[1] * (like.ndim - 2), w.shape[-1])


def embed_rows(cfg, params: dict, tokens: torch.Tensor,
               agents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The embedding rows the tokens pick, cast to the compute dtype
    (the reference casts the whole table first, which gives the same
    values); with ``agents`` (B,), row b's from agent ``agents[b]``'s
    table of stacked planes (A, V, E)."""
    table = params["embed"]
    rows = (table[tokens.long()] if agents is None
            else table[agents[:, None], tokens.long()])
    return rows.to(cfg.dtype("compute"))


def head_weight(cfg, params: dict,
                agents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The LM head (E, V) — the embedding's transpose when tied — or,
    with ``agents`` (B,), each row's agent's (B, E, V) from stacked
    planes; not yet cast."""
    if agents is None:
        return params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if cfg.tie_embeddings:
        return params["embed"][agents].transpose(-1, -2)
    return params["lm_head"][agents]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, cast back to ``x``'s dtype;
    ``weight`` is (C,) or per batch row (B, C) (:func:`per_row`)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * per_row(weight, x).to(torch.float32)).to(x.dtype)


def truncated_normal(gen: torch.Generator, shape: Sequence[int],
                     lower: float = -2.0, upper: float = 2.0,
                     device=None) -> torch.Tensor:
    """Standard normal truncated to [lower, upper], fp32, by inverting
    the CDF of a uniform draw (as ``jax.random.truncated_normal``
    does)."""
    device = device if device is not None else gen.device
    sqrt2 = math.sqrt(2.0)
    a, b = math.erf(lower / sqrt2), math.erf(upper / sqrt2)
    u = torch.rand(tuple(shape), generator=gen, device=device,
                   dtype=torch.float32)
    z = sqrt2 * torch.erfinv(a + (b - a) * u)
    return z.clamp_(lower, upper)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): std 1/√shape[0]
    unless ``scale`` is given, truncated at ±2 std."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (truncated_normal(gen, shape, device=device) * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, device=None) -> torch.Tensor:
    device = device if device is not None else gen.device
    return (torch.randn(tuple(shape), generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


def causal_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: Optional[int] = None,
                     k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive attention bias from position comparisons.

    q_pos: (B, Sq) absolute positions of the queries; k_pos: (B, Sk) of
    the keys; window: sliding-window width (None = full causal);
    k_valid: optional (B, Sk) bool marking live cache slots. Returns a
    (B, 1, Sq, Sk) fp32 bias of 0 / −1e30 (broadcast over heads)."""
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        ok &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)[:, None, :, :]


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, scale: float,
                      scores_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Materialised attention. q: (B, Sq, H, Dk), k: (B, Sk, K, Dk), v:
    (B, Sk, K, Dv) with H = G·K (GQA: k and v gathered onto the H query
    heads, head h reading kv head h // G); bias: (B, 1, Sq, Sk).

    The scores and the softmax are in ``scores_dtype`` (the reference's
    ``attention_scores_dtype``); the probabilities times v accumulate
    in fp32, and the result is cast to q's dtype."""
    H, K = q.shape[2], k.shape[2]
    if H != K:
        idx = torch.arange(H, device=k.device) // (H // K)
        k = k.index_select(2, idx)
        v = v.index_select(2, idx)
    sdt = scores_dtype
    scores = torch.einsum("bqhd,bshd->bhqs", q.to(sdt), k.to(sdt))
    scores = scores * torch.tensor(scale, dtype=sdt) + bias.to(sdt)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(torch.float32),
                       v.to(sdt).to(torch.float32))
    return out.to(q.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -100) -> torch.Tensor:
    """Token-mean cross-entropy with an ignore mask; logits (..., V) of
    any float dtype, fp32 math."""
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    safe = torch.clamp(labels.long(), min=0)
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    mask = (labels != ignore).to(torch.float32)
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)
