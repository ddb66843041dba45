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
from repro_torch.common.pytree import (init_stacked, layer, slot_layer,
                                       stack_layers)
from repro_torch.models import attention as attn
from repro_torch.models.common import (cross_entropy, dense_init, embed_init,
                                       embed_rows, head_weight, rms_norm)
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


def _lm_head(cfg, params: dict, x: torch.Tensor,
             agents: Optional[torch.Tensor] = None) -> torch.Tensor:
    return x @ head_weight(cfg, params, agents).to(cfg.dtype("compute"))


def check_fits(cfg, last: int, max_len: int) -> None:
    """Raise unless absolute position ``last`` (a host int) fits a KV
    cache of ``max_len`` slots. The reference drops KV writes beyond
    the cache silently; here a position past the last slot raises (ring
    buffers of a sliding window wrap and always fit). Callers pass
    positions they know on the host, so the check reads nothing back
    from the card."""
    if cfg.sliding_window or last < max_len:
        return
    raise ValueError(
        f"position {last} does not fit a KV cache of max_len={max_len}; "
        f"raise max_len to at least {last + 1}")


def _run_layers(cfg, params: dict, batch: dict, cache: Optional[dict],
                agents: Optional[torch.Tensor] = None):
    """(final hidden states, new cache or None) of the layer stack;
    with ``agents``, ``params`` are stacked planes and each layer's
    weights are gathered for the batch rows just before it runs."""
    positions = batch["positions"]
    x = embed_rows(cfg, params, batch["tokens"], agents)
    new_caches = []
    for i in range(cfg.n_layers):
        lp = (layer(params["layers"], i) if agents is None
              else slot_layer(params["layers"], agents, i))
        x, lc = _layer_apply(
            cfg, lp, x, positions,
            None if cache is None else layer(cache["layers"], i))
        new_caches.append(lc)
    final_norm = (params["final_norm"] if agents is None
                  else params["final_norm"][agents])
    x = rms_norm(x, final_norm, cfg.norm_eps)
    new_cache = (None if cache is None
                 else {"layers": stack_layers(new_caches)})
    return x, new_cache


def transformer_forward(cfg, params: dict, batch: dict,
                        cache: Optional[dict] = None):
    """Full-sequence pass (scoring / prefill). batch: tokens (B, S),
    positions (B, S) [, labels]. Returns (logits, aux = 0, new_cache);
    the cache is None unless one is given to continue from. With a
    cache, the S positions must fit its slots: a prefill from position
    0 writes up to S − 1, checked from the shape on the host (a caller
    that continues from a later position checks that itself)."""
    if cache is not None:
        check_fits(cfg, batch["positions"].shape[-1] - 1,
                   cache["layers"]["kv"]["pos"].shape[-1])
    x, new_cache = _run_layers(cfg, params, batch, cache)
    return (_lm_head(cfg, params, x), torch.zeros((), dtype=torch.float32),
            new_cache)


def transformer_decode(cfg, params: dict, batch: dict, cache: dict,
                       agents: Optional[torch.Tensor] = None):
    """One-token decode. batch: tokens (B, 1), positions (B, 1), which
    the caller has checked against the cache (``check_fits``): nothing
    here reads a value back from the card. With ``agents`` (B,) (long,
    on the planes' device), ``params`` are stacked planes (leaves (A,
    ...)) and row b runs under agent ``agents[b]``'s weights, gathered
    one layer at a time (the transient is B copies of one layer)."""
    x, new_cache = _run_layers(cfg, params, batch, cache, agents)
    return _lm_head(cfg, params, x, agents), new_cache


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
