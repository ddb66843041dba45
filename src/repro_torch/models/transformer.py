"""Decoder-only transformer — the port of ``repro.models.transformer``
for the dense family (RMSNorm, GQA self-attention with RoPE, SwiGLU).

Parameters keep the reference's pytree: ``{"embed", "final_norm",
["lm_head",] "layers": {"ln1", "ln2", "attn": {...}, "mlp": {...}}}``
with every per-layer leaf stacked on axis 0, and so does the KV cache
(``{"layers": {"kv": {"k", "v", "pos"}}}``, each leaf (n_layers, batch,
...)). The reference scans over the stacked layers; here a Python loop
takes layer ``i``'s views. MoE, MLA, cross-attention and the VLM and
audio families are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import init_stacked, layer, stack_layers
from repro_torch.models import attention as attn
from repro_torch.models.common import (cross_entropy, dense_init, embed_init,
                                       rms_norm)
from repro_torch.models.mlp import init_swiglu, swiglu


def _init_layer(cfg, gen: torch.Generator, device) -> dict:
    dt = cfg.dtype("param")
    return {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device),
            "ln2": torch.ones((cfg.d_model,), dtype=dt, device=device),
            "attn": attn.init_self_attention(cfg, gen, device),
            "mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, dt, device)}


def init_transformer(cfg, gen: torch.Generator, device=None) -> dict:
    """The stacked-layer parameters on ``device`` (``None``: the card);
    ``gen`` must live on that device. Each layer is drawn and copied
    into its slot at once (12.85 GB of fp32 weights at llama3.2-3b)."""
    dev = resolve_device(device)
    dt = cfg.dtype("param")
    V, E = cfg.vocab_size, cfg.d_model
    params = {"embed": embed_init(gen, (V, E), dt, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (E, V), dt, device=dev)
    params["final_norm"] = torch.ones((E,), dtype=dt, device=dev)
    params["layers"] = init_stacked(cfg.n_layers,
                                    lambda: _init_layer(cfg, gen, dev))
    return params


def _layer_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                 layer_cache: Optional[dict]):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn.self_attention(
        cfg, p["attn"], h, positions,
        None if layer_cache is None else layer_cache["kv"])
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + swiglu(p["mlp"], h2, cfg.dtype("compute"))
    return x, None if layer_cache is None else {"kv": new_cache}


def _embed(cfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # the rows a token picks, cast: the reference casts the whole table
    # first, which gives the same values
    return params["embed"][tokens.long()].to(cfg.dtype("compute"))


def _lm_head(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    w = (params["embed"].T if cfg.tie_embeddings
         else params["lm_head"]).to(cfg.dtype("compute"))
    return x @ w


def _check_fits(cfg, positions: torch.Tensor, cache: dict):
    """The reference drops KV writes beyond the cache silently; here a
    position past the last slot raises (ring buffers of a sliding
    window wrap and always fit)."""
    if cfg.sliding_window:
        return
    slots = cache["layers"]["kv"]["pos"].shape[-1]
    last = int(positions.max())
    if last >= slots:
        raise ValueError(
            f"position {last} does not fit a KV cache of max_len={slots}; "
            f"raise max_len to at least {last + 1}")


def transformer_forward(cfg, params: dict, batch: dict,
                        cache: Optional[dict] = None):
    """Full-sequence pass (scoring / prefill). batch: tokens (B, S),
    positions (B, S) [, labels]. Returns (logits, aux = 0, new_cache);
    the cache is None unless one is given to continue from."""
    positions = batch["positions"]
    if cache is not None:
        _check_fits(cfg, positions, cache)
    x = _embed(cfg, params, batch["tokens"])
    new_caches = []
    for i in range(cfg.n_layers):
        x, lc = _layer_apply(
            cfg, layer(params["layers"], i), x, positions,
            None if cache is None else layer(cache["layers"], i))
        new_caches.append(lc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_cache = (None if cache is None
                 else {"layers": stack_layers(new_caches)})
    return (_lm_head(cfg, params, x), torch.zeros((), dtype=torch.float32),
            new_cache)


def transformer_decode(cfg, params: dict, batch: dict, cache: dict):
    """One-token decode. batch: tokens (B, 1), positions (B, 1)."""
    logits, _, new_cache = transformer_forward(cfg, params, batch,
                                               cache=cache)
    return logits, new_cache


def transformer_loss(cfg, params: dict, batch: dict) -> torch.Tensor:
    """Token-mean cross-entropy of a cache-free pass over ``labels``
    (−100 ignored)."""
    logits, aux, _ = transformer_forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"]) + aux


def make_transformer_cache(cfg, batch: int, max_len: int,
                           device=None) -> dict:
    return {"layers": {"kv": attn.make_kv_cache(cfg, batch, max_len,
                                                cfg.n_layers,
                                                device=device)}}
