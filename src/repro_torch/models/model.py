"""Public model API — the port of ``repro.models.model`` for the SSM
family:

    model = get_model(cfg)
    params = model.init(cfg, generator, device)
    logits, cache = model.forward(cfg, params, batch, cache)   # prefill
    logits, cache = model.decode(cfg, params, batch, cache)

The training loss is not ported (``loss`` raises ``NotPortedError``):
this slice serves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.configs.base import ArchConfig, NotPortedError
from repro_torch.models import ssm_model as ssm


@dataclasses.dataclass(frozen=True)
class Model:
    init: Callable               # (cfg, generator, device)
    loss: Callable
    forward: Callable            # full-seq: (cfg, params, batch, cache)
    decode: Callable             # (cfg, params, batch, cache)
    make_cache: Callable         # (cfg, batch_size, max_len, device)


def _ssm_prefill(cfg, params, batch, cache):
    logits, _, new_cache = ssm.ssm_forward(cfg, params, batch, cache=cache)
    return logits, new_cache


def _unported_loss(cfg, params, batch):
    raise NotPortedError("the model zoo's training loss is not ported to "
                         "repro_torch yet (only serving is)")


_FAMILIES: Dict[str, Model] = {
    "ssm": Model(
        init=ssm.init_ssm_model,
        loss=_unported_loss,
        forward=_ssm_prefill,
        decode=ssm.ssm_decode,
        make_cache=ssm.make_ssm_cache,
    ),
}


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotPortedError(f"model family {cfg.family!r} is not ported "
                             f"to repro_torch yet")
    return _FAMILIES[cfg.family]
