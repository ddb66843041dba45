"""Optimisers as pure (init, update) pairs over flat agent rows — the
port of ``repro.optim.optimizers``.

Parameters, gradients and moments are (n, P) fp32 tensors, one row per
agent (``repro_torch.common.pytree.PlaneLayout``); the step counter is
(n,) int32. Every row is updated on its own, as the reference's
vmapped update does, so clipping is per agent. ``torch.optim`` is not
used: its defaults and state layout differ from the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.common.pytree import global_norm_clip


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., tuple]
    # update(grads, opt_state, params, step) -> (new_params, new_state)


def _lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    """The learning rate per agent row, shaped to broadcast over P."""
    if callable(lr):
        return lr(step).to(torch.float32).unsqueeze(-1)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def sgd(lr, clip: Optional[float] = None) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params, step):
        if clip is not None:
            grads, _ = global_norm_clip(grads, clip)
        lr_t = _lr_at(lr, step)
        return params - lr_t * grads, state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, clip: Optional[float] = None
             ) -> Optimizer:
    def init(params):
        return {"m": torch.zeros_like(params)}

    def update(grads, state, params, step):
        if clip is not None:
            grads, _ = global_norm_clip(grads, clip)
        m = beta * state["m"] + grads
        lr_t = _lr_at(lr, step)
        return params - lr_t * m, {"m": m}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip: Optional[float] = 1.0
          ) -> Optimizer:
    """AdamW with fp32 moments and the reference's defaults."""
    def init(params):
        n = params.shape[0]
        return {"m": torch.zeros_like(params, dtype=torch.float32),
                "v": torch.zeros_like(params, dtype=torch.float32),
                "count": torch.zeros((n,), dtype=torch.int32,
                                     device=params.device)}

    def update(grads, state, params, step):
        if clip is not None:
            grads, _ = global_norm_clip(grads, clip)
        count = state["count"] + 1
        cf = count.to(torch.float32).unsqueeze(-1)
        m = b1 * state["m"] + (1 - b1) * grads
        v = b2 * state["v"] + (1 - b2) * torch.square(grads)
        bc1 = 1.0 - b1 ** cf
        bc2 = 1.0 - b2 ** cf
        lr_t = _lr_at(lr, step)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * params
        return params - lr_t * delta, {"m": m, "v": v, "count": count}

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
