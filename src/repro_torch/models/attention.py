"""GQA self-attention — the port of the self-attention half of
``repro.models.attention`` (RoPE ``"standard"`` / ``"none"``, optional
sliding window, optional QKV bias). Cross-attention and MLA are not
ported.

Decode-time KV caches are functional values, as in the reference:
:func:`self_attention` returns a new layer cache and leaves the one it
was given as it was. Cache slots carry their absolute position
(``pos``, −1 = empty), which expresses both full caches and
sliding-window ring buffers.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import DTYPES
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import (causal_mask_bias, dense_init,
                                       per_row, softmax_attention)


def init_self_attention(cfg, gen: torch.Generator, device=None) -> dict:
    E, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype("param")
    p = {
        "wq": dense_init(gen, (E, H * D), dt, device=device),
        "wk": dense_init(gen, (E, K * D), dt, device=device),
        "wv": dense_init(gen, (E, K * D), dt, device=device),
        "wo": dense_init(gen, (H * D, E), dt, device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * D), ("bk", K * D), ("bv", K * D)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    return p


def make_kv_cache(cfg, batch: int, max_len: int, n_layers: int,
                  dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """Stacked-over-layers KV cache on ``device`` (``None``: the card).
    For sliding-window configs the cache is a ring buffer of ``window``
    slots."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype("compute")
    slots = (min(max_len, cfg.sliding_window) if cfg.sliding_window
             else max_len)
    K, D = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((n_layers, batch, slots, K, D), dtype=dt,
                         device=dev),
        "v": torch.zeros((n_layers, batch, slots, K, D), dtype=dt,
                         device=dev),
        "pos": torch.full((n_layers, batch, slots), -1, dtype=torch.int32,
                          device=dev),
    }


def _write_slots(buf: torch.Tensor, new: torch.Tensor,
                 slot_idx: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` (B, Smax, ...) with the per-batch rows ``new``
    (B, T, ...) scattered into slots ``slot_idx`` (B, T). Slots must lie
    in [0, Smax): the reference drops writes beyond the cache silently,
    torch indexing does not, so callers check first
    (``transformer_forward``)."""
    B, T = slot_idx.shape
    bidx = torch.arange(B, device=buf.device)[:, None].expand(B, T)
    out = buf.clone()
    out[bidx, slot_idx.long()] = new.to(buf.dtype)
    return out


def _slots_for(cfg, positions: torch.Tensor) -> torch.Tensor:
    """Map absolute positions → cache slots (ring for sliding window)."""
    if cfg.sliding_window:
        return positions % cfg.sliding_window
    return positions


def self_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                   layer_cache: Optional[dict] = None):
    """GQA self-attention.

    x: (B, S, E); positions: (B, S); layer_cache: this layer's slice of
    the KV cache (prefill / decode) or None (a full-sequence pass).
    Returns (out, new_layer_cache). Every weight in ``p`` may carry a
    leading batch axis, one row's weights each (the group engine's
    per-slot weights: (B, E, F) products and (B, F) biases).

    Without a cache it calls the flash attention, as the reference's
    ``_maybe_pallas`` does: causal by index, ``window =
    cfg.sliding_window``, scale 1/√D; so, as there, it ignores
    ``positions`` for the mask and assumes each row's are 0..S−1. The
    tensors' device chooses the CUDA kernel or its plain version;
    ``cfg.attention_impl`` chooses nothing. With a cache it writes the
    new keys and values into their slots, then attends over the slots
    with ``causal_mask_bias`` by position and ``softmax_attention``.
    """
    B, S, _ = x.shape
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.dtype("compute")
    xq = x @ p["wq"].to(cdt)
    xk = x @ p["wk"].to(cdt)
    xv = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        xq = xq + per_row(p["bq"], xq).to(cdt)
        xk = xk + per_row(p["bk"], xk).to(cdt)
        xv = xv + per_row(p["bv"], xv).to(cdt)
    q = rope_lib.apply_rope(cfg, xq.reshape(B, S, H, D), positions)
    k = rope_lib.apply_rope(cfg, xk.reshape(B, S, K, D), positions)
    v = xv.reshape(B, S, K, D)

    scale = 1.0 / (D ** 0.5)
    new_cache = layer_cache
    if layer_cache is None:
        out = fa_ops.flash_attention(q, k, v, causal=True,
                                     window=cfg.sliding_window, scale=scale)
    else:
        slots = _slots_for(cfg, positions)
        kc = _write_slots(layer_cache["k"], k, slots)
        vc = _write_slots(layer_cache["v"], v, slots)
        pc = _write_slots(layer_cache["pos"], positions, slots)
        new_cache = {"k": kc, "v": vc, "pos": pc}
        bias = causal_mask_bias(positions, pc, cfg.sliding_window, pc >= 0)
        out = softmax_attention(q, kc, vc, bias, scale,
                                DTYPES[cfg.attention_scores_dtype])
    return out.reshape(B, S, H * D) @ p["wo"].to(cdt), new_cache
