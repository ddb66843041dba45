"""Mamba2 language model (attention-free SSM stack) — the port of
``repro.models.ssm_model``.

Parameters keep the reference's pytree: ``{"embed", "final_norm",
"lm_head", "layers": {"ln", "mamba": {...}}}`` with every per-layer
leaf stacked on axis 0, and so does the decode cache (each leaf
(n_layers, batch, ...)). The reference scans over the stacked layers;
here a Python loop takes layer ``i``'s views.

On a model axis each Mamba2 layer runs its rank's SSD heads
(``repro_torch.models.mamba2``), the embedding and the head are
vocab-parallel where the vocabulary divides (tied or not: mamba2-780m's
50,280 ids do not divide 16 and stay whole there), the loss is the
vocab-parallel ``cross_entropy`` and scoring or serving passes return
the full logits (``gather_from_model``). A cache under installed rules
is the rank's slice of the global batch's (``shardings.local_cache``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (init_stacked, layer, pick_rows,
                                       sliced, slot_layer, stack_layers,
                                       unstack_layers)
from repro_torch.models.common import (copy_to_model, cross_entropy,
                                       dense_init, embed_init, embed_rows,
                                       gather_from_model, head_weight,
                                       rms_norm, vocab_split)
from repro_torch.models.mamba2 import (init_mamba2, make_mamba_state,
                                       mamba2_decode, mamba2_forward)


def init_ssm_model(cfg, gen: torch.Generator, device=None) -> dict:
    """The stacked-layer parameters on ``device`` (``None``: the card);
    ``gen`` must live on that device. Under ``common.pytree.slicing``
    each drawn tree is cut to the rank's slice at once."""
    dev = resolve_device(device)
    dt = cfg.dtype("param")
    params = {
        "embed": sliced(("embed",), embed_init(
            gen, (cfg.vocab_size, cfg.d_model), dt, dev)),
        "final_norm": sliced(("final_norm",), torch.ones(
            (cfg.d_model,), dtype=dt, device=dev)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = sliced(("lm_head",), dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dt, device=dev))

    def one():
        return {"ln": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                "mamba": init_mamba2(cfg, gen, dev)}

    params["layers"] = init_stacked(cfg.n_layers, one, ("layers",))
    return params


def _head(cfg, params: dict, x: torch.Tensor,
          agents: Optional[torch.Tensor] = None, vocab=None) -> torch.Tensor:
    """Logits (B, S, V); ``vocab`` (the model axis): the rank's V/m
    columns."""
    norm = (params["final_norm"] if agents is None
            else pick_rows(params["final_norm"], agents))
    x = rms_norm(x, norm, cfg.norm_eps)
    if vocab is not None:
        x = copy_to_model(x, vocab)
    return x @ head_weight(cfg, params, agents).to(cfg.dtype("compute"))


def _full(logits: torch.Tensor, vocab) -> torch.Tensor:
    return logits if vocab is None else gather_from_model(logits, vocab,
                                                          "logits")


def _forward(cfg, params: dict, batch: dict, cache: Optional[dict]):
    """(the logits as the rank holds them, the new cache or None, the
    vocab's model axis or None)."""
    vocab = vocab_split(cfg)
    x = embed_rows(cfg, params, batch["tokens"], vocab=vocab)
    states = []
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        o, new_state = mamba2_forward(
            cfg, lp["mamba"], h, None if cache is None else layer(cache, i))
        x = x + o
        states.append(new_state)
    new_cache = None if cache is None else stack_layers(states)
    return _head(cfg, params, x, vocab=vocab), new_cache, vocab


def ssm_forward(cfg, params: dict, batch: dict,
                cache: Optional[dict] = None):
    """Full-sequence pass; returns (logits, aux = 0, decode_state). The
    state is None unless a cache to continue from is given. On a model
    axis the logits are the full rows on every rank."""
    logits, new_cache, vocab = _forward(cfg, params, batch, cache)
    return (_full(logits, vocab), torch.zeros((), dtype=torch.float32),
            new_cache)


def ssm_decode(cfg, params: dict, batch: dict, cache: dict,
               agents: Optional[torch.Tensor] = None):
    """One-token decode; nothing here reads a value back from the card.
    With ``agents`` (B,) (long, on the planes' device), ``params`` are
    stacked planes (leaves (A, ...)) and row b runs under agent
    ``agents[b]``'s weights, gathered one layer at a time (the
    transient is B copies of one layer). On a model axis the logits are
    the full rows."""
    vocab = vocab_split(cfg) if agents is None else None
    x = embed_rows(cfg, params, batch["tokens"], agents, vocab)
    states = []
    for i in range(cfg.n_layers):
        lp = (layer(params["layers"], i) if agents is None
              else slot_layer(params["layers"], agents, i))
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        o, new_state = mamba2_decode(cfg, lp["mamba"], h, layer(cache, i))
        x = x + o
        states.append(new_state)
    return (_full(_head(cfg, params, x, agents, vocab), vocab),
            stack_layers(states))


def ssm_loss(cfg, params: dict, batch: dict) -> torch.Tensor:
    """Token-mean cross-entropy of a cache-free pass over ``labels``
    (−100 ignored) plus the aux term (0 for Mamba2), as the reference's
    ``ssm_loss`` (vocab-parallel on a model axis). Differentiated, the
    pass runs the SSD kernel and takes its gradient from the einsum
    form (``repro_torch.models.ssd``)."""
    logits, _, vocab = _forward(cfg, params, batch, None)
    return cross_entropy(logits, batch["labels"], vocab=vocab)


def make_ssm_cache(cfg, batch: int, max_len: int = 0, device=None) -> dict:
    """The stacked layers' decode state; under installed rules and a
    mesh the rank's slice of a global ``batch``'s (its rows, its
    ``conv_x`` channels and ``ssm`` heads)."""
    from repro_torch.launch.shardings import local_cache
    local = local_cache(cfg, batch, max_len, device)
    if local is not None:
        return local
    return make_mamba_state(cfg, batch, cfg.n_layers, device=device)
