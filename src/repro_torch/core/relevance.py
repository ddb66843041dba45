"""Learned per-edge relevance R for DDAL's eq. 4 weighting — the port of
``repro.core.relevance`` for what the buffer trainer needs.

``grad_cosine`` is the instantaneous src→dst relevance from the cosine
of two agents' gradients; ``sketch_cosine`` is the same estimate on
(n, d) sign-JL sketches of the gradients, projected through the seeded
±1 matrix of ``repro_torch.kernels.grad_sketch``. Either is mapped to
[min_rel, 1] by ``to_relevance`` and smoothed by ``ema_update`` into
the dense (n, n) ``R[src, dst]`` that the estimators carry;
``gather_edges`` projects it onto an (n, k) edge table.

The buffer trainer's gradients are flat (n, P) rows, so the cosines
reduce over one row where the reference reduces per leaf and then over
leaves; the two agree to a few ulps, not to the bit. The streaming
trainer's are trees of stacked (n, *param) leaves, which
``grad_cosine`` reduces leaf by leaf in two passes as the reference
does (norms, then the Gram of the normalised rows), a column chunk at a
time so no leaf-sized copy is made. ``fold_seed`` is host integer
math (the epoch and the base seed are host values here) and is bitwise
the reference's, int32 reinterpretation included.

``obs_overlap`` and the observation-statistics estimator wait for a
later slice.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import column_chunks, tree_leaves_with_paths
from repro_torch.configs.base import RELEVANCE_MODES
from repro_torch.kernels.grad_sketch.ref import MASK32, MIX_CONSTANTS


def cosine_rows(g: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine of the rows of g (n, p): ones on the diagonal,
    an all-zero row has cosine 0 against every other row."""
    norm = torch.sqrt(torch.sum(g * g, dim=1))
    gn = g / torch.clamp_min(norm, eps)[:, None]
    c = torch.clamp(gn @ gn.T, -1.0, 1.0)
    n = c.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=g.device)
    return torch.where(eye, torch.ones_like(c), c)


def grad_cosine(grads, eps: float = 1e-8, gather=None,
                shards=None) -> torch.Tensor:
    """Exact pairwise cosine of the agents' gradients → symmetric (n, n)
    ``C[src, dst]`` in [-1, 1], unit diagonal. ``grads`` is (n, P) rows
    or a tree of stacked (n, *param) leaves. ``gather`` (a pod mesh:
    ``grads`` holds the rank's rows) collects each column chunk's rows
    from every rank, so every rank computes the group's C, the same
    arithmetic as on one device. ``shards`` (a ``(data, model)`` mesh: a
    ``ModelShards``, ``grads`` the rank's slices of each leaf) takes the
    norms and the Gram matrix as partial sums over the leaves the rank
    owns, each all-reduced over the model axis."""
    if isinstance(grads, torch.Tensor):
        return cosine_rows(grads.to(torch.float32), eps)
    rows = [x.reshape(x.shape[0], -1)
            for _, x in tree_leaves_with_paths(grads)]
    if shards is not None:
        rows = [g for g, own in zip(rows, shards.owned) if own]

    def chunk(g, cols):
        c = g[:, cols]
        return (c if gather is None else gather(c)).to(torch.float32)
    dev = rows[0].device if rows else None
    sq = None
    for g in rows:
        for cols in column_chunks(g.shape[1]):
            gf = chunk(g, cols)
            if sq is None:
                sq = torch.zeros((gf.shape[0],), dtype=torch.float32,
                                 device=dev)
            sq = sq + torch.sum(gf * gf, dim=1)
    if shards is not None:
        if sq is None:             # no leaf of its own on this rank
            first = next(x for _, x in tree_leaves_with_paths(grads))
            dev = first.device
            sq = torch.zeros((first.shape[0],), dtype=torch.float32,
                             device=dev)
        shards.all_reduce(sq)
    n = sq.shape[0]
    denom = torch.clamp_min(torch.sqrt(sq), eps)[:, None]
    C = torch.zeros((n, n), dtype=torch.float32, device=dev)
    for g in rows:
        for cols in column_chunks(g.shape[1]):
            gn = chunk(g, cols) / denom
            C = C + gn @ gn.T
    if shards is not None:
        shards.all_reduce(C)
    c = torch.clamp(C, -1.0, 1.0)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    return torch.where(eye, torch.ones_like(c), c)


def sketch_cosine(grads: torch.Tensor, dim: int, seed: int,
                  eps: float = 1e-8) -> torch.Tensor:
    """Cosines of the (n, dim) sketches of the gradient rows, projected
    at offset 0 by the sketch kernel (its plain version on the CPU);
    ``seed`` is the round's folded seed (``fold_seed``)."""
    from repro_torch.kernels.grad_sketch import ops as sketch_ops
    return cosine_rows(sketch_ops.sketch_flat(grads, seed, dim), eps)


def fold_seed(seed: int, rnd: int) -> int:
    """Mix a base seed with a round index into the seed of that round's
    projection, as the reference does in uint32 arithmetic, returned
    as the int32 the reference's final cast gives."""
    p1, p2, p3 = MIX_CONSTANTS
    x = ((int(seed) & MASK32) * p1 + (int(rnd) & MASK32) * p2) & MASK32
    x = ((x ^ (x >> 16)) * p3) & MASK32
    x = x ^ (x >> 13)
    return x - (1 << 32) if x >= 1 << 31 else x


def to_relevance(cos: torch.Tensor, min_rel: float = 1e-3) -> torch.Tensor:
    """Cosine [-1, 1] → relevance weight [min_rel, 1]:
    R = (1 + cos) / 2, floored so that no delivered piece is discarded
    outright."""
    return torch.clamp(0.5 * (1.0 + cos), min_rel, 1.0)


def ema_update(prev: torch.Tensor, obs: torch.Tensor, decay: float,
               enabled=True, alive=None) -> torch.Tensor:
    """``decay·prev + (1 − decay)·obs`` where ``enabled``, ``prev``
    otherwise (warm-up holds the estimate at its prior). ``enabled`` is
    a host bool or a device bool scalar. ``alive`` ((n,) bool on the
    device, elastic membership) holds every entry whose src or dst is
    dead at its last live value."""
    new = decay * prev + (1.0 - decay) * obs
    if alive is None and isinstance(enabled, bool):
        return new if enabled else prev
    upd = torch.as_tensor(enabled, device=prev.device)
    if alive is not None:
        upd = upd & alive[:, None] & alive[None, :]
    return torch.where(upd, new, prev)


def gather_edges(dense: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Project a dense (n, n) ``X[src, dst]`` onto an (n, k) edge table:
    ``out[i, j] = X[nbr[i, j], i]``."""
    n = dense.shape[0]
    dst = torch.arange(n, device=dense.device)[:, None]
    return dense[nbr, dst]


def obs_overlap(mean: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Relevance prior from observation statistics: each agent's stream
    as an isotropic Gaussian of ``mean`` (n, d) and std ``scale`` (n,),
    ``R[i, j] = exp(−|μ_i − μ_j|² / (2 (σ_i² + σ_j²)))`` — symmetric,
    unit diagonal."""
    mean = torch.as_tensor(mean, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32)
    d2 = torch.sum(torch.square(mean[:, None, :] - mean[None, :, :]),
                   dim=-1)
    var = torch.square(scale)
    denom = torch.clamp_min(2.0 * (var[:, None] + var[None, :]), eps)
    return torch.exp(-d2 / denom)


def init_relevance(n: int, device=None) -> torch.Tensor:
    """The uniform prior every estimator starts from."""
    return torch.ones((n, n), dtype=torch.float32, device=device)


def update_relevance(rel: torch.Tensor, grads: torch.Tensor, mode: str,
                     decay: float, enabled: bool = True, *,
                     sketch_dim: int = 0, seed: int = 0,
                     rnd: int = 0) -> torch.Tensor:
    """One online step of the (n, n) estimate by the legacy flags: a
    no-op for ``"uniform"``; for ``"grad_cos"`` an EMA toward the
    gradient-cosine relevance, exact when ``sketch_dim == 0`` and
    sketched (projection seeded by ``(seed, rnd)``) otherwise. The
    estimators (``repro_torch.core.exchange.estimators``) run the same
    ops; this is the reference they are held against."""
    if mode == "uniform":
        return rel
    if mode == "grad_cos":
        if sketch_dim > 0:
            cos = sketch_cosine(grads, sketch_dim, fold_seed(seed, rnd))
        else:
            cos = grad_cosine(grads)
        return ema_update(rel, to_relevance(cos), decay, enabled)
    raise ValueError(
        f"unknown relevance mode {mode!r}; expected one of "
        f"{RELEVANCE_MODES}")
