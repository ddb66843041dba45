"""Mixture-of-Experts layer — the port of ``repro.models.moe`` with its
dense scatter dispatch (``_moe_dense``), the reference's path on one
device.

Top-k routing with normalised gates (Qwen3 / DeepSeek style), a
capacity of C = max(1, int(capacity_factor · S · k / Ne)) tokens an
expert with token dropping, always-on shared experts, the load-balance
auxiliary loss and the router z-loss. Every expert runs on its C slots
(the reference's dense form), and the dispatch has static shapes: no
``nonzero``, no boolean-mask indexing, nothing read back from the
device, so a decode step runs without a synchronisation.

Every weight may carry a leading batch axis, one row's weights each
(the group engine's per-slot weights: router (B, E, Ne), experts (B,
Ne, E, F), the shared SwiGLU (B, E, F)).

The expert-parallel path (``_dispatch_indices``,
``_moe_expert_parallel``) runs under a device mesh and waits for Slice
E; with no mesh the reference dispatches dense whatever
``moe_dispatch`` says, and so does the port.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_swiglu, swiglu


def init_moe(cfg, gen: torch.Generator, device=None) -> dict:
    """The router (E, Ne), the experts' (Ne, E, F) / (Ne, F, E) SwiGLU
    weights and, with shared experts, one SwiGLU of width F · n_shared.
    ``dense_init`` takes its fan-in from the first axis, which is Ne for
    the expert tensors, as in the reference."""
    moe = cfg.moe
    E, F, Ne = cfg.d_model, moe.expert_ff, moe.n_experts
    dt = cfg.dtype("param")
    p = {
        "router": dense_init(gen, (E, Ne), dt, device=device),
        "experts": {
            "w_gate": dense_init(gen, (Ne, E, F), dt, device=device),
            "w_up": dense_init(gen, (Ne, E, F), dt, device=device),
            "w_down": dense_init(gen, (Ne, F, E), dt, device=device),
        },
    }
    if moe.n_shared:
        p["shared"] = init_swiglu(gen, E, F * moe.n_shared, dt, device)
    return p


def _expert_swiglu(experts: dict, buf: torch.Tensor,
                   cdt: torch.dtype) -> torch.Tensor:
    """buf: (B, Ne, C, E) → (B, Ne, C, E) through each expert's SwiGLU;
    the weights (Ne, ...) or per row (B, Ne, ...), cast to the compute
    dtype per call, as the reference does."""
    wg = experts["w_gate"].to(cdt)
    wu = experts["w_up"].to(cdt)
    wd = experts["w_down"].to(cdt)
    w = "bx" if wg.ndim == 4 else "x"
    g = torch.einsum(f"bxcd,{w}df->bxcf", buf, wg)
    u = torch.einsum(f"bxcd,{w}df->bxcf", buf, wu)
    h = torch.nn.functional.silu(g) * u
    return torch.einsum(f"bxcf,{w}fd->bxcd", h, wd)


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot`` by comparison with 0 .. n − 1: no range check
    that reads a value back (``torch.nn.functional.one_hot`` checks on
    the host for a CPU tensor)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and
    their indices, ties broken to the lower index (a stable descending
    sort; ``torch.topk`` breaks them otherwise). At bf16 compute the
    router's logits tie often (a few per cent of tokens at the published
    widths), so the order matters."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_dense(cfg, p: dict, x: torch.Tensor, gate_flat: torch.Tensor,
               e_flat: torch.Tensor) -> torch.Tensor:
    """The reference's dense scatter dispatch. Each (token, choice) in
    flat (s, k) order takes the next slot of its expert; past the
    capacity C it goes to the overflow slot C, which is cut off before
    the experts run, and its gate weight is 0. The combine sums the k
    choices in the compute dtype."""
    moe = cfg.moe
    B, S, E = x.shape
    Ne, k = moe.n_experts, moe.top_k
    cdt = cfg.dtype("compute")
    C = max(1, int(moe.capacity_factor * S * k / Ne))
    # each choice's rank within its expert, in flat (s, k) order: the
    # reference's cumsum of the one-hot over the S·k axis, laid out
    # (B, Ne, S·k) so that the scan runs along the contiguous axis (along
    # an outer axis CUDA's scan gives each of the B·Ne columns one
    # thread: 13 ms a layer at qwen3-moe's scoring shape)
    experts = torch.arange(Ne, device=x.device)[None, :, None]
    onehot = (e_flat[:, None, :] == experts).to(torch.int32)
    pos_all = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    pos = torch.gather(pos_all, 1, e_flat[:, None, :])[:, 0, :].long()
    keep = pos < C
    slot = torch.where(keep, pos, C)                     # overflow slot C

    x_rep = x.repeat_interleave(k, dim=1)                # (B, S·k, E)
    bidx = torch.arange(B, device=x.device)[:, None].expand_as(e_flat)
    buf = x.new_zeros((B, Ne, C + 1, E), dtype=cdt)
    buf = buf.index_put((bidx, e_flat, slot), x_rep.to(cdt))
    y_buf = _expert_swiglu(p["experts"], buf[:, :, :C], cdt)
    y_buf = torch.nn.functional.pad(y_buf, (0, 0, 0, 1))
    out_rep = y_buf[bidx, e_flat, slot]                  # (B, S·k, E)
    w = (gate_flat * keep).to(cdt)
    return torch.sum((out_rep * w[..., None]).reshape(B, S, k, E), dim=2)


def moe_apply(cfg, p: dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, E) → (out, aux), aux the load-balance loss plus the
    router z-loss (fp32 scalar), both over every row and position, pads
    included, as in the reference. The router's product runs in the
    compute dtype and its logits in fp32."""
    moe = cfg.moe
    B, S, _ = x.shape
    Ne, k = moe.n_experts, moe.top_k
    cdt = cfg.dtype("compute")

    logits = (x @ p["router"].to(torch.float32).to(cdt)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, gate_idx = top_k(probs, k)                     # (B, S, k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)  # normalised

    out = _moe_dense(cfg, p, x, gate.reshape(B, S * k),
                     gate_idx.reshape(B, S * k))
    if moe.n_shared:
        out = out + swiglu(p["shared"], x, cdt)

    # load balance: Ne · Σ_e (fraction dispatched) · (mean router prob)
    frac = torch.mean(one_hot(gate_idx, Ne, torch.float32),
                      dim=(0, 1, 2)) * k
    pmean = torch.mean(probs, dim=(0, 1))
    aux = moe.aux_loss * Ne * torch.sum(frac * pmean)
    zloss = moe.router_zloss * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    return out, aux + zloss
