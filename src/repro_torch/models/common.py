"""Shared layer primitives — the port of the parts of
``repro.models.common`` the SSM family uses: RMSNorm and the
parameter initialisers.

The initialisers draw from a ``torch.Generator``, so they give the
reference's distributions (a truncated normal of fan-in scale, a
normal of std 0.02), not its bits: tests that need both sides on the
same weights carry them across with ``repro_torch.interop``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)).to(x.dtype)


def truncated_normal(gen: torch.Generator, shape: Sequence[int],
                     lower: float = -2.0, upper: float = 2.0,
                     device=None) -> torch.Tensor:
    """Standard normal truncated to [lower, upper], fp32, by inverting
    the CDF of a uniform draw (as ``jax.random.truncated_normal``
    does)."""
    device = device if device is not None else gen.device
    sqrt2 = math.sqrt(2.0)
    a, b = math.erf(lower / sqrt2), math.erf(upper / sqrt2)
    u = torch.rand(tuple(shape), generator=gen, device=device,
                   dtype=torch.float32)
    z = sqrt2 * torch.erfinv(a + (b - a) * u)
    return z.clamp_(lower, upper)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): std 1/√shape[0]
    unless ``scale`` is given, truncated at ±2 std."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (truncated_normal(gen, shape, device=device) * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, device=None) -> torch.Tensor:
    device = device if device is not None else gen.device
    return (torch.randn(tuple(shape), generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)
