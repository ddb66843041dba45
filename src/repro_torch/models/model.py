"""Public model API — the port of ``repro.models.model`` for every
family of the zoo (SSM, dense, MoE, hybrid, VLM and audio; the dense,
MoE, VLM and audio families share one transformer):

    model = get_model(cfg)
    params = model.init(cfg, generator, device)
    loss = model.loss(cfg, params, batch)                      # scoring
    logits, cache = model.forward(cfg, params, batch, cache)   # prefill
    logits, cache = model.decode(cfg, params, batch, cache)
    logits, cache = model.decode(cfg, planes, batch, cache, agents)

Every family has its loss, a cache-free pass that the streaming
trainer differentiates: every such pass runs the CUDA kernels (flash
attention, the SSD intra-chunk form), and one that autograd records
takes each kernel's gradient from its plain version
(``repro_torch.kernels.plain_vjp``; ``ArchConfig`` docstring).
``kv_pos`` is None for a model without a KV cache (the SSM family),
else the cache → its slots' positions (…, B, slots): the serving
engines check a fit against those slots.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.configs.base import TRANSFORMER_FAMILIES, ArchConfig
from repro_torch.models import hybrid as hy
from repro_torch.models import ssm_model as ssm
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class Model:
    init: Callable               # (cfg, generator, device)
    loss: Callable
    forward: Callable            # full-seq: (cfg, params, batch, cache)
    decode: Callable             # (cfg, params, batch, cache[, agents])
    make_cache: Callable         # (cfg, batch_size, max_len, device)
    kv_pos: Optional[Callable] = None    # cache -> (..., B, slots)


def _tf_prefill(cfg, params, batch, cache):
    logits, _, new_cache = tf.transformer_forward(cfg, params, batch,
                                                  cache=cache)
    return logits, new_cache


def _ssm_prefill(cfg, params, batch, cache):
    logits, _, new_cache = ssm.ssm_forward(cfg, params, batch, cache=cache)
    return logits, new_cache


def _hy_prefill(cfg, params, batch, cache):
    logits, _, new_cache = hy.hybrid_forward(cfg, params, batch, cache=cache)
    return logits, new_cache


_FAMILIES: Dict[str, Model] = {
    "transformer": Model(
        init=tf.init_transformer,
        loss=tf.transformer_loss,
        forward=_tf_prefill,
        decode=tf.transformer_decode,
        make_cache=tf.make_transformer_cache,
        kv_pos=lambda cache: cache["layers"]["kv"]["pos"],
    ),
    "ssm": Model(
        init=ssm.init_ssm_model,
        loss=ssm.ssm_loss,
        forward=_ssm_prefill,
        decode=ssm.ssm_decode,
        make_cache=ssm.make_ssm_cache,
    ),
    "hybrid": Model(
        init=hy.init_hybrid,
        loss=hy.hybrid_loss,
        forward=_hy_prefill,
        decode=hy.hybrid_decode,
        make_cache=hy.make_hybrid_cache,
        kv_pos=hy.kv_pos,
    ),
}


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family in TRANSFORMER_FAMILIES:
        return _FAMILIES["transformer"]
    return _FAMILIES[cfg.family]
