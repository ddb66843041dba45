"""Optimisers as (init, update) pairs — the port of
``repro.optim.optimizers``.

``init`` / ``update``: parameters, gradients and moments are (n, P)
fp32 tensors, one row per agent (``repro_torch.common.pytree.
PlaneLayout``); the step counter is (n,) int32 — the buffer trainer's
form. ``tree_init`` / ``tree_update_`` (AdamW only, what the streaming
launcher and example use): the streaming trainer's form, trees of
stacked (n, *param) leaves as the reference's vmapped ``opt.update``
sees them. ``tree_update_`` writes the new parameters
and moments into the given tensors, a column chunk at a time
(``common.pytree.column_chunks``), so an update of a 0.86 B-parameter
group makes no copy of a whole tree; with ``rows`` ((n,) bool) only
those agents' rows change, the elastic trainer's row select. Every row
is updated on its own, as the reference's vmapped update does, so
clipping is per agent (the squared norm summed leaf by leaf in
``jax.tree_util`` order; on a ``(data, model)`` mesh, ``shards=``, over
the rank's slices and then over the model axis). ``torch.optim`` is not used: its defaults and
state layout differ from the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.common.pytree import (column_chunks, global_norm_clip,
                                       tree_leaves_with_paths, tree_map)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., tuple]
    # update(grads, opt_state, params, step) -> (new_params, new_state)
    tree_init: Optional[Callable[[Any], Any]] = None
    tree_update_: Optional[Callable[..., None]] = None
    # tree_update_(grads, opt_state, params, step, rows=None): in place


def _rows(tree):
    """The (n, p) views of a tree's stacked leaves, in leaf order."""
    return [x.reshape(x.shape[0], -1) for _, x in tree_leaves_with_paths(tree)]


def _clip_scale(G, clip: float, shards=None) -> torch.Tensor:
    """(n,) per-agent global-norm clip factors min(1, clip / (‖g‖ +
    1e-6)) of the gradient rows ``G`` (a list of (n, p) views). With
    ``shards`` (a ``ModelShards``: the rows are the rank's slices) the
    squared norm is the partial sum over the leaves the rank owns,
    all-reduced over the model axis."""
    n = G[0].shape[0]
    sq = torch.zeros((n,), dtype=torch.float32, device=G[0].device)
    for i, g in enumerate(G):
        if shards is not None and not shards.owned[i]:
            continue
        for cols in column_chunks(g.shape[1]):
            gf = g[:, cols].to(torch.float32)
            sq = sq + torch.sum(gf * gf, dim=1)
    if shards is not None:
        shards.all_reduce(sq)
    norm = torch.sqrt(sq)
    limit = torch.as_tensor(clip, dtype=torch.float32, device=norm.device)
    return torch.clamp_max(limit / (norm + 1e-6), 1.0)


def _tree_lr(lr, step: int, device) -> torch.Tensor:
    if callable(lr):
        return lr(torch.tensor(int(step), dtype=torch.int32,
                               device=device)).to(torch.float32)
    return torch.tensor(lr, dtype=torch.float32, device=device)


def _write(dst: torch.Tensor, new: torch.Tensor, rows) -> None:
    """dst ← new, or only ``rows``' rows of it."""
    if rows is None:
        dst.copy_(new)
    else:
        dst.copy_(torch.where(rows[:, None], new.to(dst.dtype), dst))


def _zeros_f32(params):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)


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
    """AdamW with fp32 moments and the reference's defaults. The flat
    ``update`` and the tree's ``tree_update_`` run one body
    (``adam_step``), the second a column chunk at a time."""
    def adam_step(g, m, v, p, bc1, bc2, lr_t):
        """(new p, m, v) from the clipped fp32 gradient ``g``."""
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p
        return p - lr_t * delta, m, v

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
        new, m, v = adam_step(grads, state["m"], state["v"], params,
                              1.0 - b1 ** cf, 1.0 - b2 ** cf,
                              _lr_at(lr, step))
        return new, {"m": m, "v": v, "count": count}

    def tree_init(params):
        first = _rows(params)[0]
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "count": torch.zeros((first.shape[0],), dtype=torch.int32,
                                     device=first.device)}

    def tree_update_(grads, state, params, step, rows=None, shards=None):
        G, P = _rows(grads), _rows(params)
        M, V = _rows(state["m"]), _rows(state["v"])
        dev = G[0].device
        scale = (_clip_scale(G, clip, shards) if clip is not None
                 else None)
        count = state["count"] + 1
        cf = count.to(torch.float32)[:, None]
        bc1 = 1.0 - b1 ** cf
        bc2 = 1.0 - b2 ** cf
        lr_t = _tree_lr(lr, step, dev)
        for g2, p2, m2, v2 in zip(G, P, M, V):
            for cols in column_chunks(g2.shape[1]):
                g = g2[:, cols].to(torch.float32)
                if scale is not None:
                    g = g * scale[:, None]
                new, m, v = adam_step(g, m2[:, cols], v2[:, cols],
                                      p2[:, cols].to(torch.float32), bc1,
                                      bc2, lr_t)
                _write(p2[:, cols], new, rows)
                _write(m2[:, cols], m, rows)
                _write(v2[:, cols], v, rows)
        state["count"].copy_(count if rows is None
                             else torch.where(rows, count, state["count"]))

    return Optimizer(init, update, tree_init=tree_init,
                     tree_update_=tree_update_)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
