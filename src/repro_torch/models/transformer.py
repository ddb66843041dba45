"""Decoder-only transformer — the port of ``repro.models.transformer``
for the dense and MoE families (RMSNorm, GQA self-attention with RoPE or
Multi-head Latent Attention, a SwiGLU or a routed MoE feed-forward, and
DeepSeek's leading dense layer).

Parameters keep the reference's pytree: ``{"embed", "final_norm",
["lm_head",] "layers": {"ln1", "ln2", "attn": {...}, "mlp" | "moe":
{...}}, ["layer0": {"ln1", "ln2", "attn", "mlp"}]}`` with every stacked
leaf on axis 0 (``n_layers − first_k_dense`` layers) and ``layer0``
unstacked, and so does the cache (``{"layers": {"kv": {"k", "v", "pos"}
| {"ckv", "k_rope", "pos"}}, ["layer0": {"kv": ...}]}``, each leaf
(n_layers, batch, ...), ``layer0``'s (1, batch, ...)). The reference
scans over the stacked layers after running ``layer0``; here a Python
loop takes layer ``i``'s views. Cross-attention and the VLM and audio
families are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (init_stacked, layer, slot_layer,
                                       stack_layers, unstack_layers)
from repro_torch.models import attention as attn
from repro_torch.models.common import (cross_entropy, dense_init, embed_init,
                                       embed_rows, head_weight, rms_norm)
from repro_torch.models.mlp import init_swiglu, swiglu
from repro_torch.models.moe import init_moe, moe_apply


def _init_layer(cfg, gen: torch.Generator, device,
                dense_ff: Optional[int]) -> dict:
    """One decoder layer: MLA or GQA attention, and a dense SwiGLU of
    ``dense_ff`` or, when it is None, the routed experts."""
    dt = cfg.dtype("param")
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device),
         "ln2": torch.ones((cfg.d_model,), dtype=dt, device=device),
         "attn": (attn.init_mla(cfg, gen, device) if cfg.mla is not None
                  else attn.init_self_attention(cfg, gen, device))}
    if dense_ff is not None:
        p["mlp"] = init_swiglu(gen, cfg.d_model, dense_ff, dt, device)
    else:
        p["moe"] = init_moe(cfg, gen, device)
    return p


def init_transformer(cfg, gen: torch.Generator, device=None) -> dict:
    """The stacked-layer parameters on ``device`` (``None``: the card);
    ``gen`` must live on that device. Each layer is drawn and copied
    into its slot at once (12.85 GB of fp32 weights at llama3.2-3b),
    then the leading dense layer, if any."""
    dev = resolve_device(device)
    dt = cfg.dtype("param")
    V, E = cfg.vocab_size, cfg.d_model
    params = {"embed": embed_init(gen, (V, E), dt, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (E, V), dt, device=dev)
    params["final_norm"] = torch.ones((E,), dtype=dt, device=dev)
    dense_ff = cfg.d_ff if cfg.moe is None else None
    params["layers"] = init_stacked(
        cfg.n_layers - cfg.first_k_dense,
        lambda: _init_layer(cfg, gen, dev, dense_ff))
    if cfg.first_k_dense:
        params["layer0"] = _init_layer(cfg, gen, dev, cfg.dense_ff)
    return params


def _layer_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                 layer_cache: Optional[dict], drop_past: bool = False):
    """One layer → (x, aux, new layer cache or None); aux is the MoE's
    auxiliary loss, 0 for a dense feed-forward."""
    cdt = cfg.dtype("compute")
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    kv = None if layer_cache is None else layer_cache["kv"]
    if cfg.mla is not None:
        a, new_cache = attn.mla_attention(cfg, p["attn"], h, positions, kv,
                                          drop_past)
    else:
        a, new_cache = attn.self_attention(cfg, p["attn"], h, positions, kv,
                                           drop_past)
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, aux = moe_apply(cfg, p["moe"], h2)
    else:
        f, aux = swiglu(p["mlp"], h2, cdt), None
    return x + f, aux, None if layer_cache is None else {"kv": new_cache}


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
                agents: Optional[torch.Tensor] = None,
                drop_past: bool = False):
    """(final hidden states, aux summed over the stacked layers, new
    cache or None): ``layer0`` first, then the stack. With ``agents``,
    ``params`` are stacked planes and each layer's weights are gathered
    for the batch rows just before it runs (``layer0``'s planes are
    (A, ...), with no depth axis)."""
    positions = batch["positions"]
    x = embed_rows(cfg, params, batch["tokens"], agents)
    new_cache = None if cache is None else {}
    if cfg.first_k_dense:
        lp = (params["layer0"] if agents is None
              else slot_layer(params["layer0"], agents))
        x, _, lc = _layer_apply(
            cfg, lp, x, positions,
            None if cache is None else layer(cache["layer0"], 0), drop_past)
        if cache is not None:
            new_cache["layer0"] = stack_layers([lc])
    n_scan = cfg.n_layers - cfg.first_k_dense
    new_caches = []
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    views = (unstack_layers(params["layers"], n_scan)
             if agents is None else None)
    for i in range(n_scan):
        lp = (views[i] if agents is None
              else slot_layer(params["layers"], agents, i))
        x, aux, lc = _layer_apply(
            cfg, lp, x, positions,
            None if cache is None else layer(cache["layers"], i), drop_past)
        if aux is not None:
            aux_sum = aux_sum + aux
        new_caches.append(lc)
    final_norm = (params["final_norm"] if agents is None
                  else params["final_norm"][agents])
    x = rms_norm(x, final_norm, cfg.norm_eps)
    if cache is not None:
        new_cache["layers"] = stack_layers(new_caches)
    return x, aux_sum, new_cache


def transformer_forward(cfg, params: dict, batch: dict,
                        cache: Optional[dict] = None):
    """Full-sequence pass (scoring / prefill). batch: tokens (B, S),
    positions (B, S) [, labels]. Returns (logits, aux, new_cache): aux
    is the MoE layers' auxiliary loss summed over the stacked layers (0
    for a dense model; ``layer0`` is dense), and the cache is None
    unless one is given to continue from. With a cache, a dense model's
    S positions must fit its slots: a prefill from position 0 writes up
    to S − 1, checked from the shape on the host (a caller that
    continues from a later position checks that itself). A MoE model
    runs its whole right-padded width instead and drops the cache
    writes past the cache, as the reference does: its experts'
    capacity depends on that width, so cutting it would route
    differently. Its caller checks that the real tokens fit
    (``api.prefill``)."""
    drop_past = cfg.moe is not None
    if cache is not None and not drop_past:
        check_fits(cfg, batch["positions"].shape[-1] - 1,
                   cache["layers"]["kv"]["pos"].shape[-1])
    x, aux, new_cache = _run_layers(cfg, params, batch, cache,
                                    drop_past=drop_past)
    return _lm_head(cfg, params, x), aux, new_cache


def transformer_decode(cfg, params: dict, batch: dict, cache: dict,
                       agents: Optional[torch.Tensor] = None):
    """One-token decode. batch: tokens (B, 1), positions (B, 1), which
    the caller has checked against the cache (``check_fits``): nothing
    here reads a value back from the card. With ``agents`` (B,) (long,
    on the planes' device), ``params`` are stacked planes (leaves (A,
    ...)) and row b runs under agent ``agents[b]``'s weights, gathered
    one layer at a time (the transient is B copies of one layer)."""
    x, _, new_cache = _run_layers(cfg, params, batch, cache, agents)
    return _lm_head(cfg, params, x, agents), new_cache


def transformer_loss(cfg, params: dict, batch: dict) -> torch.Tensor:
    """Token-mean cross-entropy of a cache-free pass over ``labels``
    (−100 ignored) plus the MoE auxiliary loss."""
    logits, aux, _ = transformer_forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"]) + aux


def make_transformer_cache(cfg, batch: int, max_len: int,
                           device=None) -> dict:
    """The stacked layers' KV (or MLA latent) cache and, with a leading
    dense layer, ``layer0``'s of depth 1."""
    make = attn.make_mla_cache if cfg.mla is not None else attn.make_kv_cache
    cache = {"layers": {"kv": make(cfg, batch, max_len,
                                   cfg.n_layers - cfg.first_k_dense,
                                   device=device)}}
    if cfg.first_k_dense:
        cache["layer0"] = {"kv": make(cfg, batch, max_len, 1,
                                      device=device)}
    return cache
