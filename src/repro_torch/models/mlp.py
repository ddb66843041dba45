"""Feed-forward blocks — the port of the SwiGLU half of
``repro.models.mlp`` (the GELU MLP of the audio family is not
ported)."""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_init


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype, device=None) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device=device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device=device),
    }


def swiglu(p: dict, x: torch.Tensor, compute_dtype: torch.dtype
           ) -> torch.Tensor:
    """silu(x W_gate) · (x W_up) W_down, every weight cast to the
    compute dtype per call, as the reference does."""
    g = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    return (torch.nn.functional.silu(g) * u) @ p["w_down"].to(compute_dtype)
