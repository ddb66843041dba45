"""Rotary position embeddings — the port of ``repro.models.rope`` for
the modes ``"standard"`` and ``"none"`` (M-RoPE is not ported; its
configs raise ``NotPortedError``)."""
from __future__ import annotations

import torch


def _angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions (..., S) → (..., S, dim/2) fp32 angles."""
    half = dim // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=positions.device) / half)
    return positions[..., None].to(torch.float32) * freq


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """x (..., D) with rotate-half pairing (x1, x2 = split halves); the
    products are taken in fp32 (x promotes against the fp32 angles) and
    cast back to x's dtype."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Standard RoPE. x: (B, S, H, D); positions: (B, S)."""
    ang = _angles(positions, x.shape[-1], theta)      # (B, S, D/2)
    return _apply_rotary(x, torch.cos(ang)[:, :, None, :],
                         torch.sin(ang)[:, :, None, :])


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Dispatch on ``cfg.rope_mode`` (``"standard"`` or ``"none"``)."""
    if cfg.rope_mode == "none":
        return x
    return rope(x, positions, cfg.rope_theta)
