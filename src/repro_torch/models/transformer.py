"""Decoder-only transformer — the port of ``repro.models.transformer``
for the dense, MoE, VLM and audio families (RMSNorm, GQA self-attention
with RoPE or M-RoPE or Multi-head Latent Attention, MusicGen's
cross-attention, a SwiGLU, GELU or routed MoE feed-forward, and
DeepSeek's leading dense layer).

Parameters keep the reference's pytree: ``{"embed", "final_norm",
["lm_head",] "layers": {"ln1", "ln2", "attn": {...}, ["ln_x", "xattn":
{...},] "mlp" | "moe": {...}}, ["layer0": {"ln1", "ln2", "attn",
"mlp"}]}`` with every stacked leaf on axis 0 (``n_layers −
first_k_dense`` layers) and ``layer0`` unstacked, and so does the cache
(``{"layers": {"kv": {"k", "v", "pos"} | {"ckv", "k_rope", "pos"},
["xkv": {"ck", "cv"}]}, ["layer0": {"kv": ...}]}``, each leaf
(n_layers, batch, ...), ``layer0``'s (1, batch, ...)). The audio
family's ``embed`` is (n_codebooks, V, E) and its ``lm_head``
(n_codebooks, E, V). The reference scans over the stacked layers after
running ``layer0``; here a Python loop takes layer ``i``'s views.

The modality front ends are stubbed, as in the reference: a VLM batch
carries ``vision`` (B, vision_prefix, E), pre-projected patch
embeddings put ahead of the text's, and positions (B, 3, S) over the
whole sequence; an audio batch carries tokens (B, n_codebooks, S),
positions (B, S) and ``cond`` (B, cond_len, E).

On a model axis every family splits the same way: attention by heads
(M-RoPE's sections lie along ``head_dim``, so it rotates the rank's
heads as it would all of them), the cross-attention by heads, the
SwiGLU and GELU feed-forwards by columns then rows, the experts over
the axis, the embedding and the head by the vocabulary (the audio
family's C codebook tables and heads each by its own; its logits
(B, C, S, V/m) before they are gathered). The VLM's vision rows enter
replicated, and its −100 labels over them pass through the
vocab-parallel loss as ignored tokens.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.sharding import mesh_axis
from repro_torch.common.pytree import (init_stacked, layer, pick_rows,
                                       sliced, slot_layer, stack_layers,
                                       unstack_layers)
from repro_torch.models import attention as attn
from repro_torch.models.common import (copy_to_model, cross_entropy,
                                       dense_init, embed_init, embed_rows,
                                       gather_from_model, head_weight,
                                       rms_norm,
                                       sinusoidal_positions, split_axis,
                                       vocab_split)
from repro_torch.models.mlp import gelu_mlp, init_gelu_mlp, init_swiglu, swiglu
from repro_torch.models.moe import init_moe, moe_apply


def _init_layer(cfg, gen: torch.Generator, device,
                dense_ff: Optional[int]) -> dict:
    """One decoder layer: MLA or GQA attention, cross-attention with
    its norm where the config asks for it, and a dense feed-forward of
    ``dense_ff`` (GELU for the audio family, else SwiGLU) or, when it is
    None, the routed experts."""
    dt = cfg.dtype("param")
    p = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device),
         "ln2": torch.ones((cfg.d_model,), dtype=dt, device=device),
         "attn": (attn.init_mla(cfg, gen, device) if cfg.mla is not None
                  else attn.init_self_attention(cfg, gen, device))}
    if cfg.cross_attention:
        p["ln_x"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
        p["xattn"] = attn.init_cross_attention(cfg, gen, device)
    if dense_ff is not None:
        init_ff = init_gelu_mlp if cfg.family == "audio" else init_swiglu
        p["mlp"] = init_ff(gen, cfg.d_model, dense_ff, dt, device)
    else:
        p["moe"] = init_moe(cfg, gen, device)
    return p


def init_transformer(cfg, gen: torch.Generator, device=None) -> dict:
    """The stacked-layer parameters on ``device`` (``None``: the card);
    ``gen`` must live on that device. Each layer is drawn and copied
    into its slot at once (12.85 GB of fp32 weights at llama3.2-3b),
    then the leading dense layer, if any. Under ``common.pytree.
    slicing`` each drawn tree is cut to the rank's slice at once."""
    dev = resolve_device(device)
    dt = cfg.dtype("param")
    V, E = cfg.vocab_size, cfg.d_model
    if cfg.family == "audio":
        C = cfg.n_codebooks
        params = {"embed": sliced(("embed",),
                                  embed_init(gen, (C, V, E), dt, dev)),
                  "lm_head": sliced(("lm_head",), dense_init(
                      gen, (C, E, V), dt, device=dev))}
    else:
        params = {"embed": sliced(("embed",),
                                  embed_init(gen, (V, E), dt, dev))}
        if not cfg.tie_embeddings:
            params["lm_head"] = sliced(("lm_head",), dense_init(
                gen, (E, V), dt, device=dev))
    params["final_norm"] = sliced(("final_norm",), torch.ones(
        (E,), dtype=dt, device=dev))
    dense_ff = cfg.d_ff if cfg.moe is None else None
    params["layers"] = init_stacked(
        cfg.n_layers - cfg.first_k_dense,
        lambda: _init_layer(cfg, gen, dev, dense_ff), ("layers",))
    if cfg.first_k_dense:
        params["layer0"] = sliced(("layer0",), _init_layer(
            cfg, gen, dev, cfg.dense_ff))
    return params


def _layer_apply(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cond: Optional[torch.Tensor], layer_cache: Optional[dict],
                 drop_past: bool = False):
    """One layer → (x, aux, new layer cache or None); aux is the MoE's
    auxiliary loss, None for a dense feed-forward."""
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
    out_cache = None if layer_cache is None else {"kv": new_cache}
    if cfg.cross_attention:
        hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
        cx, xkv = attn.cross_attention(
            cfg, p["xattn"], hx, cond,
            None if layer_cache is None else layer_cache["xkv"])
        x = x + cx
        if out_cache is not None:
            out_cache["xkv"] = xkv
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        f, aux = moe_apply(cfg, p["moe"], h2)
    elif cfg.family == "audio":
        f, aux = gelu_mlp(p["mlp"], h2, cdt,
                          split_axis(cfg, "ff", cfg.d_ff)), None
    else:
        width = cfg.d_ff if cfg.moe is None else cfg.dense_ff
        f, aux = swiglu(p["mlp"], h2, cdt, split_axis(cfg, "ff", width)), None
    return x + f, aux, out_cache


def _embed(cfg, params: dict, batch: dict,
           agents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The input rows in the compute dtype: the token embeddings; the
    audio family's summed codebook rows plus sinusoidal positions of
    ``positions`` (B, S); the VLM's ``vision`` rows ahead of the text's
    where the batch has them (a prefill or scoring pass, not a decode
    step)."""
    cdt = cfg.dtype("compute")
    x = embed_rows(cfg, params, batch["tokens"], agents,
                   vocab_split(cfg) if agents is None else None)
    if cfg.family == "audio":
        return x + sinusoidal_positions(batch["positions"],
                                        cfg.d_model).to(cdt)
    if cfg.family == "vlm" and batch.get("vision") is not None:
        x = torch.cat([batch["vision"].to(cdt), x], dim=1)
    return x


def _lm_head(cfg, params: dict, x: torch.Tensor,
             agents: Optional[torch.Tensor] = None,
             vocab=None) -> torch.Tensor:
    """Logits (B, S, V), or the audio family's (B, C, S, V); ``vocab``
    (the model axis): the rank's V/m columns, (B, S, V/m) or (B, C, S,
    V/m) (a tied head reads the embedding's rows of the rank's
    vocabulary)."""
    w = head_weight(cfg, params, agents).to(cfg.dtype("compute"))
    if vocab is not None:
        x = copy_to_model(x, vocab)
    if cfg.family == "audio":
        return torch.einsum("bsd,kdv->bksv" if agents is None
                            else "bsd,bkdv->bksv", x, w)
    return x @ w


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
    (A, ...), with no depth axis). ``cond``, where the batch has it,
    goes to every layer's cross-attention in the compute dtype."""
    positions = batch["positions"]
    cond = batch.get("cond")
    if cond is not None:
        cond = cond.to(cfg.dtype("compute"))
    x = _embed(cfg, params, batch, agents)
    new_cache = None if cache is None else {}
    if cfg.first_k_dense:
        lp = (params["layer0"] if agents is None
              else slot_layer(params["layer0"], agents))
        x, _, lc = _layer_apply(
            cfg, lp, x, positions, cond,
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
            cfg, lp, x, positions, cond,
            None if cache is None else layer(cache["layers"], i), drop_past)
        if aux is not None:
            aux_sum = aux_sum + aux
        new_caches.append(lc)
    final_norm = (params["final_norm"] if agents is None
                  else pick_rows(params["final_norm"], agents))
    x = rms_norm(x, final_norm, cfg.norm_eps)
    if cache is not None:
        new_cache["layers"] = stack_layers(new_caches)
    return x, aux_sum, new_cache


def transformer_forward(cfg, params: dict, batch: dict,
                        cache: Optional[dict] = None):
    """Full-sequence pass (scoring / prefill). batch: tokens (B, S),
    positions (B, S) [, labels] (VLM: tokens (B, S − vision_prefix),
    ``vision``, positions (B, 3, S); audio: tokens (B, C, S), ``cond``).
    Returns (logits, aux, new_cache): aux
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
    (``api.prefill``).

    On a model axis the logits are the full rows on every rank: each
    rank's vocabulary columns all-gathered (``gather_from_model``). A
    cache there is the rank's slice (``make_transformer_cache``), and the
    fit is checked against its slots times the slot axis's size."""
    logits, aux, new_cache, vocab = _forward(cfg, params, batch, cache)
    return _full_logits(logits, vocab), aux, new_cache


def _full_logits(logits: torch.Tensor, vocab) -> torch.Tensor:
    """The full rows of logits the rank holds the ``vocab`` columns of
    (``None``: as they are)."""
    if vocab is None:
        return logits
    return gather_from_model(logits, vocab, "logits")


def _forward(cfg, params: dict, batch: dict, cache: Optional[dict]):
    """``transformer_forward`` with the logits as the rank holds them:
    (logits, aux, new cache, the vocab's model axis or None)."""
    drop_past = cfg.moe is not None
    if cache is not None and not drop_past:
        sw = mesh_axis("kv_slots")
        check_fits(cfg, batch["positions"].shape[-1] - 1,
                   cache["layers"]["kv"]["pos"].shape[-1]
                   * (1 if sw is None else sw.size))
    x, aux, new_cache = _run_layers(cfg, params, batch, cache,
                                    drop_past=drop_past)
    vocab = vocab_split(cfg)
    return _lm_head(cfg, params, x, vocab=vocab), aux, new_cache, vocab


def transformer_decode(cfg, params: dict, batch: dict, cache: dict,
                       agents: Optional[torch.Tensor] = None):
    """One-token decode. batch: tokens (B, 1) (audio: (B, C, 1)),
    positions (B, 1) (VLM: (B, 3, 1)), which the caller has checked against the cache (``check_fits``): nothing
    here reads a value back from the card. With ``agents`` (B,) (long,
    on the planes' device), ``params`` are stacked planes (leaves (A,
    ...)) and row b runs under agent ``agents[b]``'s weights, gathered
    one layer at a time (the transient is B copies of one layer). On a
    model axis the logits are the full rows, as
    :func:`transformer_forward`'s."""
    x, _, new_cache = _run_layers(cfg, params, batch, cache, agents)
    vocab = vocab_split(cfg) if agents is None else None
    return (_full_logits(_lm_head(cfg, params, x, agents, vocab), vocab),
            new_cache)


def transformer_loss(cfg, params: dict, batch: dict) -> torch.Tensor:
    """Token-mean cross-entropy of a cache-free pass over ``labels``
    (−100 ignored) plus the MoE auxiliary loss. A VLM's labels cover
    the whole (vision + text) sequence, the vision rows −100; an audio
    batch's are (B, C, S), one row per codebook."""
    logits, aux, _, vocab = _forward(cfg, params, batch, None)
    return cross_entropy(logits, batch["labels"], vocab=vocab) + aux


def make_transformer_cache(cfg, batch: int, max_len: int,
                           device=None) -> dict:
    """The stacked layers' KV (or MLA latent) cache, with the
    cross-attention's zero keys and values where the config has
    cross-attention, and, with a leading dense layer, ``layer0``'s of
    depth 1.

    Under installed rules and a mesh (``serve_rules``) it is the calling
    rank's slice of the cache of a global ``batch``: each leaf at the
    shape ``repro_torch.launch.shardings.cache_partition_specs`` places
    on the rank (its batch rows over the data axis where they divide,
    its slots over ``"kv_slots"`` where they divide, every kv head), so
    no rank allocates a layer's whole slot dim that splits
    (``model.cache_specs`` gives the global shapes)."""
    from repro_torch.launch.shardings import local_cache
    local = local_cache(cfg, batch, max_len, device)
    if local is not None:
        return local
    make = attn.make_mla_cache if cfg.mla is not None else attn.make_kv_cache

    def one(n):
        entry = {"kv": make(cfg, batch, max_len, n, device=device)}
        if cfg.cross_attention:
            entry["xkv"] = attn.make_cross_cache(cfg, batch, n, device)
        return entry
    cache = {"layers": one(cfg.n_layers - cfg.first_k_dense)}
    if cfg.first_k_dense:
        cache["layer0"] = one(1)
    return cache
