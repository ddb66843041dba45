"""Rotary position embeddings — the port of ``repro.models.rope``:
standard RoPE and Qwen2-VL's M-RoPE.

M-RoPE (arXiv:2409.12191): the head_dim/2 rotary frequencies are split
into three contiguous sections (t, h, w); each section takes its angle
from the corresponding component of a (3,)-vector position. For pure
text all three components are equal and M-RoPE degenerates to RoPE.
"""
from __future__ import annotations

from typing import Sequence

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


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
          sections: Sequence[int]) -> torch.Tensor:
    """M-RoPE. x: (B, S, H, D); positions3: (B, 3, S); the sections sum
    to D/2 (``ValueError`` naming both otherwise). Section i's
    frequencies are θ^(−j / (D/2)) for j in [off_i, off_i + sec_i), in
    fp32, times row i of the positions."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope_sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {half} (head_dim "
                         f"{x.shape[-1]})")
    parts, off = [], 0
    for i, sec in enumerate(sections):
        freq = theta ** (-torch.arange(off, off + sec, dtype=torch.float32,
                                       device=x.device) / half)
        parts.append(positions3[:, i, :, None].to(torch.float32) * freq)
        off += sec
    ang = torch.cat(parts, dim=-1)                    # (B, S, D/2)
    return _apply_rotary(x, torch.cos(ang)[:, :, None, :],
                         torch.sin(ang)[:, :, None, :])


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Dispatch on ``cfg.rope_mode``; positions is (B, S), or (B, 3, S)
    for ``"mrope"``."""
    if cfg.rope_mode == "none":
        return x
    if cfg.rope_mode == "mrope":
        return mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return rope(x, positions, cfg.rope_theta)
