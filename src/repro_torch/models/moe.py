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

On a model axis (``repro_torch.models.common.split_axis``) whose size
divides Ne the experts hold the rank's Ne/m (the expert axis is split),
and ``moe_apply`` chooses as the reference does: ``moe_dispatch ==
"dense"`` keeps the dense scatter (each rank runs its experts' slots of
the (B, Ne, C + 1, E) buffer, the k choices are summed where they lie,
and one all-reduce adds the ranks' parts); otherwise the expert-parallel
path ``_moe_expert_parallel``: the sort-based capacity slots
(``_dispatch_indices``), a local gather of the tokens the rank's
experts own (x is replicated over the axis), their SwiGLU, an fp32
scatter-add into (B, S, E) and ONE all-reduce over the axis. With no
model axis, or Ne not dividing it, the dispatch is dense whatever
``moe_dispatch`` says, as the reference's is. The router stays
replicated; its aux losses sum over the data axis when there is one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.common.sharding import mesh_axis
from repro_torch.models.common import (copy_to_model, dense_init,
                                       reduce_from_model, split_axis)
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
               e_flat: torch.Tensor, tp=None) -> torch.Tensor:
    """The reference's dense scatter dispatch. Each (token, choice) in
    flat (s, k) order takes the next slot of its expert; past the
    capacity C it goes to the overflow slot C, which is cut off before
    the experts run, and its gate weight is 0. The combine sums the k
    choices in the compute dtype.

    ``tp`` (the model axis; ``p["experts"]`` holds the rank's Ne/m
    experts): the buffer of every expert is built on each rank (x and the
    gates enter through ``copy_to_model``), the rank runs its experts,
    the others' slots stay zero, and one all-reduce adds the ranks'
    parts."""
    moe = cfg.moe
    B, S, E = x.shape
    Ne, k = moe.n_experts, moe.top_k
    cdt = cfg.dtype("compute")
    C = max(1, int(moe.capacity_factor * S * k / Ne))
    nloc, e0 = Ne, 0
    if tp is not None:
        nloc = Ne // tp.size
        e0 = tp.rank * nloc
        x = copy_to_model(x, tp)
        gate_flat = copy_to_model(gate_flat, tp)
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
    y_buf = _expert_swiglu(p["experts"], buf[:, e0:e0 + nloc, :C], cdt)
    y_buf = torch.nn.functional.pad(y_buf, (0, 0, 0, 1, e0,
                                            Ne - e0 - nloc))
    out_rep = y_buf[bidx, e_flat, slot]                  # (B, S·k, E)
    w = (gate_flat * keep).to(cdt)
    out = torch.sum((out_rep * w[..., None]).reshape(B, S, k, E), dim=2)
    return out if tp is None else reduce_from_model(out, tp, "moe_combine")


def _dispatch_indices(e_flat: torch.Tensor, gate_flat: torch.Tensor,
                      Ne: int, C: int, k: int):
    """Sort-based capacity dispatch, per batch row (the reference's).

    e_flat: (B, T = S·k) expert ids; gate_flat: (B, T) gate weights.
    Returns token_idx (B, Ne, C) — the flat-token index in each (expert,
    capacity slot) — w (B, Ne, C), the gate weights (0 where a slot is
    empty), src (B, Ne, C) = token_idx // k (source positions) and valid
    (B, Ne, C). A slot's order is the token's rank within its expert in
    flat order, so the drops past C are the dense dispatch's."""
    B, T = e_flat.shape
    e_flat = e_flat.long()
    order = torch.argsort(e_flat, dim=1, stable=True)
    sorted_e = torch.gather(e_flat, 1, order).contiguous()
    ids = torch.arange(Ne, device=e_flat.device).expand(B, Ne).contiguous()
    start = torch.searchsorted(sorted_e, ids, side="left")
    end = torch.searchsorted(sorted_e, ids, side="right")
    pos = start[:, :, None] + torch.arange(C, device=e_flat.device)
    valid = pos < end[:, :, None]
    token_idx = torch.gather(order, 1, torch.clamp_max(pos, T - 1).reshape(
        B, Ne * C)).reshape(B, Ne, C)
    w = torch.gather(gate_flat, 1, token_idx.reshape(B, Ne * C)).reshape(
        B, Ne, C) * valid
    return token_idx, w.to(gate_flat.dtype), token_idx // k, valid


def _moe_expert_parallel(cfg, p: dict, x: torch.Tensor,
                         gate_flat: torch.Tensor, e_flat: torch.Tensor,
                         tp) -> torch.Tensor:
    """Expert-parallel MoE over the model axis ``tp`` (``p["experts"]``
    holds the rank's Ne/m experts). The dispatch is a LOCAL gather: x is
    replicated over the axis, so each rank pulls the tokens its experts
    own with no collective; the combine is a local fp32 scatter-add into
    a (B, S, E) partial and ONE all-reduce over the axis. fp32 across
    the boundary, as the reference keeps it (x and the gate weights
    enter through ``copy_to_model``, whose backward all-reduces their
    gradients)."""
    moe = cfg.moe
    B, S, E = x.shape
    Ne, k = moe.n_experts, moe.top_k
    C = max(1, int(moe.capacity_factor * S * k / Ne))
    cdt = cfg.dtype("compute")
    token_idx, w, src, _ = _dispatch_indices(e_flat, gate_flat, Ne, C, k)
    nloc = Ne // tp.size
    e0 = tp.rank * nloc
    xf = copy_to_model(x.to(torch.float32), tp)
    w_l = copy_to_model(w.to(torch.float32), tp)[:, e0:e0 + nloc]
    src_l = src[:, e0:e0 + nloc]
    bidx = torch.arange(B, device=x.device)[:, None, None]
    buf = xf[bidx, src_l].to(cdt)                          # (B, nloc, C, E)
    buf = buf * (w_l[..., None] != 0).to(cdt)
    y = _expert_swiglu(p["experts"], buf, cdt)
    contrib = y.to(torch.float32) * w_l[..., None]
    out_l = xf.new_zeros((B, S, E)).index_put(
        (bidx.expand_as(src_l), src_l), contrib, accumulate=True)
    return reduce_from_model(out_l, tp, "moe_combine").to(cdt)


def _data_mean(x: torch.Tensor, dims, data) -> torch.Tensor:
    """The mean of ``x`` over ``dims``, over the global batch when there
    is a data axis (its sum all-reduced, each rank's gradient its own
    rows' part)."""
    if data is None:
        return torch.mean(x, dim=dims)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return reduce_from_model(torch.sum(x, dim=dims), data,
                             "aux_sum") / (n * data.size)


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

    gate_flat, e_flat = gate.reshape(B, S * k), gate_idx.reshape(B, S * k)
    tp = split_axis(cfg, "experts", Ne)
    if tp is None or cfg.moe_dispatch == "dense":
        out = _moe_dense(cfg, p, x, gate_flat, e_flat, tp)
    else:
        out = _moe_expert_parallel(cfg, p, x, gate_flat, e_flat, tp)
    if moe.n_shared:
        out = out + swiglu(p["shared"], x, cdt, split_axis(
            cfg, "ff", moe.expert_ff * moe.n_shared))

    # load balance: Ne · Σ_e (fraction dispatched) · (mean router prob)
    data = mesh_axis("batch")
    frac = _data_mean(one_hot(gate_idx, Ne, torch.float32), (0, 1, 2),
                      data) * k
    pmean = _data_mean(probs, (0, 1), data)
    aux = moe.aux_loss * Ne * torch.sum(frac * pmean)
    zloss = moe.router_zloss * _data_mean(
        torch.square(torch.logsumexp(logits, dim=-1)), (0, 1), data)
    return out, aux + zloss
