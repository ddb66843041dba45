"""Mamba2 block (arXiv:2405.21060) — the port of
``repro.models.mamba2``: input projections → causal depthwise conv →
SSD sequence mixing → gated RMSNorm → out-proj.

As in the reference, (z, x, B, C, dt) have separate projections and
per-stream convs (the depthwise conv is per channel, so splitting the
streams equals the fused form). The decode state (per-stream conv tails
and the SSM state) gives O(1) work per token.

On the model axis (``ssm_inner`` under the installed rules), where the
SSD heads H = d_inner / head_dim divide over it, a rank runs its H/m
heads, as the reference's ``shard(z / xs, …, "ssm_inner")`` annotations
place them: ``w_z`` / ``w_x`` are column slices (``x`` enters through
``copy_to_model``), ``conv_x`` runs on the rank's channels and the SSD
on its heads (``ssd_chunked(head0=)``). ``w_B``, ``w_C``, ``w_dt``,
``conv_B``, ``conv_C``, ``dt_bias``, ``A_log`` and ``D`` stay
replicated: B, C, dt and A are computed whole on every rank, each rank
taking its heads' part, and those leaves enter through
``copy_to_model``, so their gradients, of which each rank's heads give
a part, are the full ones on every rank. (With ``x`` entering once, as
every leaf of a one-rank axis does, the axis of one rank gives the
one-device bits.) The gated RMSNorm takes its mean over
the whole d_inner (an all-reduce of the fp32 sums of squares, counted
as ``ssm_norm``), and ``out_proj`` is a row slice whose partial product
is all-reduced (``ssm_out``). Decode runs the same way on the state's
slices (the rank's ``conv_x`` channels and ``ssm`` heads, ``conv_B`` /
``conv_C`` whole). Where the heads do not divide, every leaf stays whole
(``repro_torch.launch.shardings.placement_spec``) and the block runs
its one-device form.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.models.common import (copy_to_model, dense_init, per_row,
                                       reduce_from_model, split_axis)
from repro_torch.models.ssd import ssd_chunked, ssd_decode_step


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_bc = s.n_groups * s.d_state
    return d_inner, n_heads, d_bc


def _split(cfg):
    """The model axis the block's SSD heads split over, or ``None``."""
    return split_axis(cfg, "ssm_inner", _dims(cfg)[1])


def _heads(cfg, tp):
    """(first global head, heads) the rank runs: all H without ``tp``."""
    H = _dims(cfg)[1]
    if tp is None:
        return 0, H
    n = H // tp.size
    return tp.rank * n, n


def _mine(t: torch.Tensor, cfg, tp) -> torch.Tensor:
    """A per-head value (…, H) computed whole: the rank's heads of it
    under ``tp``."""
    if tp is None:
        return t
    h0, n = _heads(cfg, tp)
    return t[..., h0:h0 + n]


def _shared(p: dict, tp) -> dict:
    """The block's leaves as its split work reads them: under ``tp`` each
    replicated leaf (``w_B``, ``w_C``, ``w_dt``, ``conv_B``, ``conv_C``,
    ``dt_bias``, ``A_log``, ``D``) enters through ``copy_to_model``, so
    its gradient, of which each rank's heads give a part, is the sum
    over the model axis on every rank."""
    if tp is None:
        return p
    out = dict(p)
    for name in ("w_B", "w_C", "w_dt", "dt_bias", "A_log", "D"):
        out[name] = copy_to_model(p[name], tp)
    for name in ("conv_B", "conv_C"):
        out[name] = {k: copy_to_model(v, tp) for k, v in p[name].items()}
    return out


def init_mamba2(cfg, gen: torch.Generator, device=None) -> dict:
    """One block's parameters, with the reference's shapes, dtypes and
    distributions (``gen`` draws them, so not its bits), on ``device``
    (``None``: the card)."""
    s = cfg.ssm
    d_inner, H, d_bc = _dims(cfg)
    dt = cfg.dtype("param")
    dev = resolve_device(device)

    def dense(shape, scale=None):
        return dense_init(gen, shape, dt, scale=scale, device=dev)

    u = torch.rand((H,), generator=gen, device=dev, dtype=torch.float32)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt_init = torch.exp(lo + (hi - lo) * u)
    return {
        "w_z": dense((cfg.d_model, d_inner)),
        "w_x": dense((cfg.d_model, d_inner)),
        "w_B": dense((cfg.d_model, d_bc)),
        "w_C": dense((cfg.d_model, d_bc)),
        "w_dt": dense((cfg.d_model, H)),
        "conv_x": {"w": dense((s.d_conv, d_inner), scale=0.3),
                   "b": torch.zeros((d_inner,), dtype=dt, device=dev)},
        "conv_B": {"w": dense((s.d_conv, d_bc), scale=0.3),
                   "b": torch.zeros((d_bc,), dtype=dt, device=dev)},
        "conv_C": {"w": dense((s.d_conv, d_bc), scale=0.3),
                   "b": torch.zeros((d_bc,), dtype=dt, device=dev)},
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(dt),
        "D": torch.ones((H,), dtype=dt, device=dev),
        "dt_bias": torch.log(torch.expm1(dt_init)).to(dt),
        "norm_w": torch.ones((d_inner,), dtype=dt, device=dev),
        "out_proj": dense((d_inner, cfg.d_model)),
    }


def _causal_conv(x: torch.Tensor, conv: dict,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B, S, C); ``tail`` is the (B,
    d_conv - 1, C) history for streaming continuation. Returns (out,
    new_tail)."""
    w = conv["w"].to(x.dtype)
    b = conv["b"].to(x.dtype)
    d_conv = w.shape[0]
    if tail is not None:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    else:
        xp = F.pad(x, (0, 0, d_conv - 1, 0))
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(d_conv))
    new_tail = xp[:, xp.shape[1] - (d_conv - 1):, :]
    return F.silu(out + b), new_tail


def _conv_step(window: torch.Tensor, conv: dict) -> torch.Tensor:
    """Single-token depthwise conv. window: (B, d_conv, C); the conv's
    weight (d_conv, C) or per row (B, d_conv, C), its bias (C,) or
    (B, C)."""
    w = conv["w"].to(window.dtype)
    eq = "bkc,kc->bc" if w.ndim == 2 else "bkc,bkc->bc"
    out = torch.einsum(eq, window, w) + conv["b"].to(window.dtype)
    return F.silu(out)


def _proj_streams(cfg, p: dict, x: torch.Tensor, tp=None):
    """(z, xs) — the rank's columns under ``tp`` — and the whole (Bs, Cs,
    dt_raw); ``x`` enters the split work through ``copy_to_model``."""
    cdt = cfg.dtype("compute")
    if tp is not None:
        x = copy_to_model(x, tp)
    z = x @ p["w_z"].to(cdt)
    xs = x @ p["w_x"].to(cdt)
    Bs = x @ p["w_B"].to(cdt)
    Cs = x @ p["w_C"].to(cdt)
    dt_raw = x @ p["w_dt"].to(cdt)
    return z, xs, Bs, Cs, dt_raw


def _gated_norm(cfg, y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                tp) -> torch.Tensor:
    """RMSNorm of y·silu(z) over the whole d_inner, in fp32: the sum of
    squares over d_inner — under ``tp`` the ranks' sums all-reduced
    (and, backward, their gradient, which each rank's channels give a
    part of) — divided by d_inner, as ``rms_norm``'s mean. One formula
    with and without the axis, so an axis of one rank gives the
    one-device bits on any device."""
    g = y * F.silu(z)
    gf = g.to(torch.float32)
    ss = torch.sum(torch.square(gf), dim=-1, keepdim=True)
    if tp is not None:
        ss = copy_to_model(reduce_from_model(ss, tp, "ssm_norm"), tp)
    out = gf * torch.rsqrt(ss / _dims(cfg)[0] + cfg.norm_eps)
    return (out * per_row(w, g).to(torch.float32)).to(g.dtype)


def _finalize(cfg, p: dict, y_heads: torch.Tensor, xh: torch.Tensor,
              z: torch.Tensor, lead_shape, tp=None) -> torch.Tensor:
    cdt = cfg.dtype("compute")
    H = y_heads.shape[-2]
    D = p["D"].to(torch.float32)
    # (H,), or per row (B, H) with y_heads (B, H, P) at decode
    D = (_mine(D, cfg, tp).reshape((1,) * (y_heads.ndim - 2) + (H, 1))
         if D.ndim == 1 else D[:, :, None])
    y = y_heads + D * xh.to(torch.float32)
    y = y.reshape(*lead_shape, -1).to(cdt)
    y = _gated_norm(cfg, y, z, p["norm_w"], tp)
    w = p["out_proj"].to(cdt)
    if w.ndim == 3:             # per-row weights, y (B, d_inner)
        return (y[:, None, :] @ w)[:, 0]
    if tp is None:
        return y @ w
    return reduce_from_model(y @ w, tp, "ssm_out")


def _dt_and_A(cfg, p: dict, dt_raw: torch.Tensor, tp=None):
    """dt = softplus(dt_raw + dt_bias) and A = −exp(A_log), computed
    whole; the rank's heads of each under ``tp``."""
    dt = F.softplus(dt_raw.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    return _mine(dt, cfg, tp), _mine(A, cfg, tp)


def mamba2_forward(cfg, p: dict, x: torch.Tensor,
                   state: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence pass. x: (B, S, E). Returns (out, decode_state);
    the state is None unless one was given to continue from. On the
    model axis ``p`` and ``state`` hold the rank's slices (module
    docstring)."""
    s = cfg.ssm
    Bsz, S, _ = x.shape
    tp = _split(cfg)
    h0, _ = _heads(cfg, tp)
    p = _shared(p, tp)
    z, xs, Bs, Cs, dt_raw = _proj_streams(cfg, p, x, tp)
    tails = {} if state is None else state
    xc, tail_x = _causal_conv(xs, p["conv_x"], tails.get("conv_x"))
    Bc, tail_B = _causal_conv(Bs, p["conv_B"], tails.get("conv_B"))
    Cc, tail_C = _causal_conv(Cs, p["conv_C"], tails.get("conv_C"))

    dt, A = _dt_and_A(cfg, p, dt_raw, tp)
    xh = xc.reshape(Bsz, S, -1, s.head_dim)
    Bm = Bc.reshape(Bsz, S, s.n_groups, s.d_state)
    Cm = Cc.reshape(Bsz, S, s.n_groups, s.d_state)
    init_state = None if state is None else state["ssm"]
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk,
                                 initial_state=init_state,
                                 impl=cfg.ssd_impl, head0=h0,
                                 total_heads=_dims(cfg)[1])
    out = _finalize(cfg, p, y.to(torch.float32), xh, z, (Bsz, S), tp)
    new_state = None
    if state is not None:
        new_state = {"conv_x": tail_x, "conv_B": tail_B,
                     "conv_C": tail_C, "ssm": final_state}
    return out, new_state


def mamba2_decode(cfg, p: dict, x: torch.Tensor, state: dict
                  ) -> Tuple[torch.Tensor, dict]:
    """Single-token step. x: (B, 1, E). Every leaf of ``p`` may carry a
    leading batch axis, one row's weights each (the group engine's
    per-slot weights). On the model axis ``p`` and ``state`` hold the
    rank's slices."""
    s = cfg.ssm
    Bsz = x.shape[0]
    tp = _split(cfg)
    h0, _ = _heads(cfg, tp)
    p = _shared(p, tp)
    z, xs, Bs, Cs, dt_raw = (t[:, 0] for t in
                             _proj_streams(cfg, p, x[:, 0:1], tp))

    def step(name, val, conv):
        window = torch.cat([state[name].to(val.dtype), val[:, None, :]],
                           dim=1)
        return _conv_step(window, conv), window[:, 1:]

    xc, tail_x = step("conv_x", xs, p["conv_x"])
    Bc, tail_B = step("conv_B", Bs, p["conv_B"])
    Cc, tail_C = step("conv_C", Cs, p["conv_C"])

    dt, A = _dt_and_A(cfg, p, dt_raw, tp)
    xh = xc.reshape(Bsz, -1, s.head_dim)
    Bm = Bc.reshape(Bsz, s.n_groups, s.d_state)
    Cm = Cc.reshape(Bsz, s.n_groups, s.d_state)
    y, new_ssm = ssd_decode_step(state["ssm"], xh, dt, A, Bm, Cm, h0,
                                 _dims(cfg)[1])
    out = _finalize(cfg, p, y.to(torch.float32), xh, z, (Bsz,), tp)
    return out[:, None, :], {"conv_x": tail_x, "conv_B": tail_B,
                             "conv_C": tail_C, "ssm": new_ssm}


def make_mamba_state(cfg, batch: int, n_layers: int, dtype=None,
                     device=None) -> dict:
    """Zeroed decode state of ``n_layers`` stacked blocks: conv tails in
    the compute dtype, the SSM state in fp32, on ``device`` (``None``:
    the card), at the global shapes (a rank's slice on the model axis is
    built by the model's cache builder, ``shardings.local_cache``)."""
    s = cfg.ssm
    d_inner, H, d_bc = _dims(cfg)
    cdt = dtype or cfg.dtype("compute")
    device = resolve_device(device)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "conv_x": zeros((n_layers, batch, s.d_conv - 1, d_inner), cdt),
        "conv_B": zeros((n_layers, batch, s.d_conv - 1, d_bc), cdt),
        "conv_C": zeros((n_layers, batch, s.d_conv - 1, d_bc), cdt),
        "ssm": zeros((n_layers, batch, H, s.head_dim, s.d_state),
                     torch.float32),
    }
