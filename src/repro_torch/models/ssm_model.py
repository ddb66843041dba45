"""Mamba2 language model (attention-free SSM stack) — the port of
``repro.models.ssm_model``.

Parameters keep the reference's pytree: ``{"embed", "final_norm",
"lm_head", "layers": {"ln", "mamba": {...}}}`` with every per-layer
leaf stacked on axis 0, and so does the decode cache (each leaf
(n_layers, batch, ...)). The reference scans over the stacked layers;
here a Python loop takes layer ``i``'s views.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (init_stacked, layer, slot_layer,
                                       stack_layers)
from repro_torch.models.common import (dense_init, embed_init, embed_rows,
                                       head_weight, rms_norm)
from repro_torch.models.mamba2 import (init_mamba2, make_mamba_state,
                                       mamba2_decode, mamba2_forward)


def init_ssm_model(cfg, gen: torch.Generator, device=None) -> dict:
    """The stacked-layer parameters on ``device`` (``None``: the card);
    ``gen`` must live on that device."""
    dev = resolve_device(device)
    dt = cfg.dtype("param")
    params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt, dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dt, device=dev)

    def one():
        return {"ln": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                "mamba": init_mamba2(cfg, gen, dev)}

    params["layers"] = init_stacked(cfg.n_layers, one)
    return params


def _head(cfg, params: dict, x: torch.Tensor,
          agents: Optional[torch.Tensor] = None) -> torch.Tensor:
    norm = (params["final_norm"] if agents is None
            else params["final_norm"][agents])
    x = rms_norm(x, norm, cfg.norm_eps)
    return x @ head_weight(cfg, params, agents).to(cfg.dtype("compute"))


def ssm_forward(cfg, params: dict, batch: dict,
                cache: Optional[dict] = None):
    """Full-sequence pass; returns (logits, aux = 0, decode_state). The
    state is None unless a cache to continue from is given."""
    x = embed_rows(cfg, params, batch["tokens"])
    states = []
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        o, new_state = mamba2_forward(
            cfg, lp["mamba"], h, None if cache is None else layer(cache, i))
        x = x + o
        states.append(new_state)
    new_cache = None if cache is None else stack_layers(states)
    return (_head(cfg, params, x), torch.zeros((), dtype=torch.float32),
            new_cache)


def ssm_decode(cfg, params: dict, batch: dict, cache: dict,
               agents: Optional[torch.Tensor] = None):
    """One-token decode; nothing here reads a value back from the card.
    With ``agents`` (B,) (long, on the planes' device), ``params`` are
    stacked planes (leaves (A, ...)) and row b runs under agent
    ``agents[b]``'s weights, gathered one layer at a time (the
    transient is B copies of one layer)."""
    x = embed_rows(cfg, params, batch["tokens"], agents)
    states = []
    for i in range(cfg.n_layers):
        lp = (layer(params["layers"], i) if agents is None
              else slot_layer(params["layers"], agents, i))
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        o, new_state = mamba2_decode(cfg, lp["mamba"], h, layer(cache, i))
        x = x + o
        states.append(new_state)
    return _head(cfg, params, x, agents), stack_layers(states)


def make_ssm_cache(cfg, batch: int, max_len: int = 0, device=None) -> dict:
    return make_mamba_state(cfg, batch, cfg.n_layers, device=device)
