"""Public model API — the port of ``repro.models.model`` for the SSM
and dense families:

    model = get_model(cfg)
    params = model.init(cfg, generator, device)
    loss = model.loss(cfg, params, batch)                      # scoring
    logits, cache = model.forward(cfg, params, batch, cache)   # prefill
    logits, cache = model.decode(cfg, params, batch, cache)
    logits, cache = model.decode(cfg, planes, batch, cache, agents)

The dense family ("transformer") has its loss, a cache-free pass with
no gradient on the card (the flash kernel has no backward, as the
reference's has no VJP); the SSM family's ``loss`` raises
``NotPortedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.configs.base import ArchConfig, NotPortedError
from repro_torch.models import ssm_model as ssm
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class Model:
    init: Callable               # (cfg, generator, device)
    loss: Callable
    forward: Callable            # full-seq: (cfg, params, batch, cache)
    decode: Callable             # (cfg, params, batch, cache[, agents])
    make_cache: Callable         # (cfg, batch_size, max_len, device)


def _tf_prefill(cfg, params, batch, cache):
    logits, _, new_cache = tf.transformer_forward(cfg, params, batch,
                                                  cache=cache)
    return logits, new_cache


def _ssm_prefill(cfg, params, batch, cache):
    logits, _, new_cache = ssm.ssm_forward(cfg, params, batch, cache=cache)
    return logits, new_cache


def _unported_loss(cfg, params, batch):
    raise NotPortedError("the SSM family's loss is not ported to "
                         "repro_torch yet (only serving is)")


_FAMILIES: Dict[str, Model] = {
    "transformer": Model(
        init=tf.init_transformer,
        loss=tf.transformer_loss,
        forward=_tf_prefill,
        decode=tf.transformer_decode,
        make_cache=tf.make_transformer_cache,
    ),
    "ssm": Model(
        init=ssm.init_ssm_model,
        loss=_unported_loss,
        forward=_ssm_prefill,
        decode=ssm.ssm_decode,
        make_cache=ssm.make_ssm_cache,
    ),
}


def get_model(cfg: ArchConfig) -> Model:
    family = "transformer" if cfg.family == "dense" else cfg.family
    if family not in _FAMILIES:
        raise NotPortedError(f"model family {cfg.family!r} is not ported "
                             f"to repro_torch yet")
    return _FAMILIES[family]
