"""Feed-forward blocks — the port of ``repro.models.mlp``: SwiGLU
(the llama family) and the GELU MLP (MusicGen), each a column / row
split over the model axis."""
from __future__ import annotations

import torch

from repro_torch.models.common import (copy_to_model, dense_init, per_row,
                                       reduce_from_model)


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype, device=None) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype, device=device),
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device=device),
    }


def swiglu(p: dict, x: torch.Tensor, compute_dtype: torch.dtype,
           tp=None) -> torch.Tensor:
    """silu(x W_gate) · (x W_up) W_down, every weight cast to the
    compute dtype per call, as the reference does. ``tp`` (the model
    axis): ``w_gate`` / ``w_up`` hold the rank's columns of the ff width
    and ``w_down`` its rows, and the partial product is all-reduced."""
    if tp is not None:
        x = copy_to_model(x, tp)
    g = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    y = (torch.nn.functional.silu(g) * u) @ p["w_down"].to(compute_dtype)
    return y if tp is None else reduce_from_model(y, tp, "mlp_out")


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype, device=None) -> dict:
    return {
        "w1": dense_init(gen, (d_model, d_ff), dtype, device=device),
        "b1": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w2": dense_init(gen, (d_ff, d_model), dtype, device=device),
        "b2": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(p: dict, x: torch.Tensor, compute_dtype: torch.dtype,
             tp=None) -> torch.Tensor:
    """gelu(x W1 + b1) W2 + b2 with GELU's tanh approximation, which is
    what the reference's ``jax.nn.gelu`` computes by default; weights
    cast to the compute dtype per call. Each weight may carry a leading
    batch axis (the group engine's per-slot weights). ``tp`` (the model
    axis): ``w1`` / ``b1`` hold the rank's columns of the ff width and
    ``w2`` its rows; the partial product is all-reduced and the
    replicated ``b2`` added once, after it."""
    if tp is not None:
        x = copy_to_model(x, tp)
    h = x @ p["w1"].to(compute_dtype)
    h = h + per_row(p["b1"], h).to(compute_dtype)
    h = torch.nn.functional.gelu(h, approximate="tanh")
    out = h @ p["w2"].to(compute_dtype)
    if tp is not None:
        out = reduce_from_model(out, tp, "mlp_out")
    return out + per_row(p["b2"], out).to(compute_dtype)
