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

