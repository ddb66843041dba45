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
                                       per_row, recorded, refuse_pallas,
                                       softmax_attention)


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
                 slot_idx: torch.Tensor,
                 drop_past: bool = False) -> torch.Tensor:
    """A copy of ``buf`` (B, Smax, ...) with the per-batch rows ``new``
    (B, T, ...) scattered into slots ``slot_idx`` (B, T). Slots must lie
    in [0, Smax): the reference drops writes beyond the cache silently,
    torch indexing does not, so callers check first
    (``transformer_forward``). With ``drop_past`` the writes at slots
    past the cache are dropped, as the reference's are: they go to one
    spare row past the copy, which is cut off."""
    B, T = slot_idx.shape
    if not drop_past:
        bidx = torch.arange(B, device=buf.device)[:, None].expand(B, T)
        out = buf.clone()
        out[bidx, slot_idx.long()] = new.to(buf.dtype)
        return out
    smax, rest = buf.shape[1], tuple(buf.shape[2:])
    flat = buf.new_empty((B * smax + 1,) + rest)
    flat[:-1] = buf.reshape((B * smax,) + rest)
    s = slot_idx.long()
    rows = torch.arange(B, device=buf.device)[:, None] * smax + s
    flat[torch.where(s < smax, rows, B * smax)] = new.to(buf.dtype)
    return flat[:-1].view(buf.shape)


def _slots_for(cfg, positions: torch.Tensor) -> torch.Tensor:
    """Map absolute positions → cache slots (ring for sliding window)."""
    if cfg.sliding_window:
        return positions % cfg.sliding_window
    return positions


def self_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                   layer_cache: Optional[dict] = None,
                   drop_past: bool = False):
    """GQA self-attention.

    x: (B, S, E); positions: (B, S); layer_cache: this layer's slice of
    the KV cache (prefill / decode) or None (a full-sequence pass).
    Returns (out, new_layer_cache). Every weight in ``p`` may carry a
    leading batch axis, one row's weights each (the group engine's
    per-slot weights: (B, E, F) products and (B, F) biases).

    Without a cache it calls the flash attention, as the reference's
    ``_maybe_pallas`` does: causal by index, ``window =
    cfg.sliding_window``, scale 1/√D, so it assumes each row's positions
    are 0..S−1; the tensors' device chooses the CUDA kernel or its plain
    version. A pass that autograd records (a training loss) goes
    through ``flash_attention_with_vjp``, whose backward is the plain
    version's, and refuses an ``attention_impl`` other than ``"xla"``
    with ``NotPortedError`` (the reference's Pallas kernel has no VJP).
    With a cache it writes the new keys and values into their slots,
    then attends over the slots with ``causal_mask_bias`` by position
    and ``softmax_attention``; ``drop_past`` drops the writes at slots
    past the cache instead of requiring that none be made (the hybrid's
    right-padded prefill, whose pads past ``max_len`` still run on).
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
        if recorded(q, k, v):
            refuse_pallas("attention_impl", cfg.attention_impl)
        out = fa_ops.flash_attention_with_vjp(
            q, k, v, window=cfg.sliding_window, scale=scale)
    else:
        slots = _slots_for(cfg, positions)
        kc = _write_slots(layer_cache["k"], k, slots, drop_past)
        vc = _write_slots(layer_cache["v"], v, slots, drop_past)
        pc = _write_slots(layer_cache["pos"], positions, slots, drop_past)
        new_cache = {"k": kc, "v": vc, "pos": pc}
        bias = causal_mask_bias(positions, pc, cfg.sliding_window, pc >= 0)
        out = softmax_attention(q, kc, vc, bias, scale,
                                DTYPES[cfg.attention_scores_dtype])
    return out.reshape(B, S, H * D) @ p["wo"].to(cdt), new_cache
