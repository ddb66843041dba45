"""DDAL weighting — paper eq. 4 (port of ``repro.core.weighting``).

    ḡ = ½ ( Σ_j T_j/ΣT · g_j  +  Σ_j R_j/ΣR · g_j )

so each piece's effective weight is w_j = ½(T_j/ΣT + R_j/ΣR).
"""
from __future__ import annotations

import torch


def sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis, added strictly left to right from 0 — the
    order the CUDA share-step kernel uses, so the plain version and the
    kernel round alike. m is the store size (tens), so the loop is
    short."""
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        s = s + x[..., j]
    return s


def eq4_weights(T, R, valid=None, eps: float = 1e-12) -> torch.Tensor:
    """Effective per-piece weights w_j = ½(T̂_j + R̂_j) over the last
    axis (leading axes are agents).

    The op order is the reference's: mask, sum, clamp, normalise,
    average. Invalid pieces get weight 0 and leave both sums, so the
    weights sum to 1 over the valid pieces, or to 0 if none is valid.
    """
    T = torch.as_tensor(T, dtype=torch.float32)
    R = torch.as_tensor(R, dtype=torch.float32)
    if valid is not None:
        v = torch.as_tensor(valid, device=T.device).to(torch.float32)
        T = T * v
        R = R * v
    t_hat = T / torch.clamp_min(sequential_sum(T), eps).unsqueeze(-1)
    r_hat = R / torch.clamp_min(sequential_sum(R), eps).unsqueeze(-1)
    return 0.5 * (t_hat + r_hat)


def training_experience(epoch: int, mode: str = "epochs") -> float:
    """T_j for a piece generated at ``epoch`` (paper: proportional to
    the number of training epochs so far). The epoch is a host integer
    in the port, so this is a host float."""
    e = float(epoch)
    if mode == "epochs":
        return max(e, 1.0)
    if mode == "sqrt":
        return float(torch.sqrt(torch.tensor(max(e, 1.0))))
    if mode == "uniform":
        return 1.0
    raise ValueError(f"unknown T mode {mode!r}")



def combine_relevance(prior: torch.Tensor, learned: torch.Tensor
                      ) -> torch.Tensor:
    """Effective relevance = static prior × learned online estimate,
    elementwise. The ``uniform`` estimator skips the product entirely
    (``ExchangeProtocol.apply_relevance`` leaves the topology as it
    is), so the static eq. 4 weights stay exactly as they were."""
    return prior * learned


def relevance_matrix(n: int, mode: str = "uniform", adjacency=None,
                     device=None) -> torch.Tensor:
    """R[j, i] = relevance of agent j's knowledge to agent i; a zero
    entry means j's knowledge never reaches i. ``"ring"`` keeps the
    entries within one step around the ring, ``"custom"`` takes an
    (n, n) ``adjacency``."""
    R = torch.ones((n, n), dtype=torch.float32, device=device)
    if mode == "uniform":
        pass
    elif mode == "ring":
        idx = torch.arange(n, device=device)
        ring = torch.minimum((idx[:, None] - idx[None, :]) % n,
                             (idx[None, :] - idx[:, None]) % n) <= 1
        R = R * ring.to(torch.float32)
    elif mode == "custom":
        if adjacency is None:
            raise ValueError("custom relevance needs an adjacency matrix")
        R = torch.as_tensor(adjacency, dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unknown relevance mode {mode!r}")
    return R
