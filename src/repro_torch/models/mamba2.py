"""Mamba2 block (arXiv:2405.21060) — the port of
``repro.models.mamba2``: input projections → causal depthwise conv →
SSD sequence mixing → gated RMSNorm → out-proj.

As in the reference, (z, x, B, C, dt) have separate projections and
per-stream convs (the depthwise conv is per channel, so splitting the
streams equals the fused form). The reference's ``shard(...)``
annotations are dropped: the port runs on one card. The decode state
(per-stream conv tails and the SSM state) gives O(1) work per token.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.ssd import ssd_chunked, ssd_decode_step


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_bc = s.n_groups * s.d_state
    return d_inner, n_heads, d_bc


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


def _proj_streams(cfg, p: dict, x: torch.Tensor):
    cdt = cfg.dtype("compute")
    z = x @ p["w_z"].to(cdt)
    xs = x @ p["w_x"].to(cdt)
    Bs = x @ p["w_B"].to(cdt)
    Cs = x @ p["w_C"].to(cdt)
    dt_raw = x @ p["w_dt"].to(cdt)
    return z, xs, Bs, Cs, dt_raw


def _finalize(cfg, p: dict, y_heads: torch.Tensor, xh: torch.Tensor,
              z: torch.Tensor, lead_shape) -> torch.Tensor:
    d_inner, H, _ = _dims(cfg)
    cdt = cfg.dtype("compute")
    D = p["D"].to(torch.float32)
    # (H,), or per row (B, H) with y_heads (B, H, P) at decode
    D = (D.reshape((1,) * (y_heads.ndim - 2) + (H, 1)) if D.ndim == 1
         else D[:, :, None])
    y = y_heads + D * xh.to(torch.float32)
    y = y.reshape(*lead_shape, d_inner).to(cdt)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    w = p["out_proj"].to(cdt)
    if w.ndim == 3:             # per-row weights, y (B, d_inner)
        return (y[:, None, :] @ w)[:, 0]
    return y @ w


def _dt_and_A(p: dict, dt_raw: torch.Tensor):
    dt = F.softplus(dt_raw.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    return dt, A


def mamba2_forward(cfg, p: dict, x: torch.Tensor,
                   state: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence pass. x: (B, S, E). Returns (out, decode_state);
    the state is None unless one was given to continue from."""
    s = cfg.ssm
    Bsz, S, _ = x.shape
    z, xs, Bs, Cs, dt_raw = _proj_streams(cfg, p, x)
    tails = {} if state is None else state
    xc, tail_x = _causal_conv(xs, p["conv_x"], tails.get("conv_x"))
    Bc, tail_B = _causal_conv(Bs, p["conv_B"], tails.get("conv_B"))
    Cc, tail_C = _causal_conv(Cs, p["conv_C"], tails.get("conv_C"))

    dt, A = _dt_and_A(p, dt_raw)
    xh = xc.reshape(Bsz, S, -1, s.head_dim)
    Bm = Bc.reshape(Bsz, S, s.n_groups, s.d_state)
    Cm = Cc.reshape(Bsz, S, s.n_groups, s.d_state)
    init_state = None if state is None else state["ssm"]
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk,
                                 initial_state=init_state,
                                 impl=cfg.ssd_impl)
    out = _finalize(cfg, p, y.to(torch.float32), xh, z, (Bsz, S))
    new_state = None
    if state is not None:
        new_state = {"conv_x": tail_x, "conv_B": tail_B,
                     "conv_C": tail_C, "ssm": final_state}
    return out, new_state


def mamba2_decode(cfg, p: dict, x: torch.Tensor, state: dict
                  ) -> Tuple[torch.Tensor, dict]:
    """Single-token step. x: (B, 1, E). Every leaf of ``p`` may carry a
    leading batch axis, one row's weights each (the group engine's
    per-slot weights)."""
    s = cfg.ssm
    Bsz = x.shape[0]
    z, xs, Bs, Cs, dt_raw = (t[:, 0] for t in
                             _proj_streams(cfg, p, x[:, 0:1]))

    def step(name, val, conv):
        window = torch.cat([state[name].to(val.dtype), val[:, None, :]],
                           dim=1)
        return _conv_step(window, conv), window[:, 1:]

    xc, tail_x = step("conv_x", xs, p["conv_x"])
    Bc, tail_B = step("conv_B", Bs, p["conv_B"])
    Cc, tail_C = step("conv_C", Cs, p["conv_C"])

    dt, A = _dt_and_A(p, dt_raw)
    xh = xc.reshape(Bsz, -1, s.head_dim)
    Bm = Bc.reshape(Bsz, s.n_groups, s.d_state)
    Cm = Cc.reshape(Bsz, s.n_groups, s.d_state)
    y, new_ssm = ssd_decode_step(state["ssm"], xh, dt, A, Bm, Cm)
    out = _finalize(cfg, p, y.to(torch.float32), xh, z, (Bsz,))
    return out[:, None, :], {"conv_x": tail_x, "conv_B": tail_B,
                             "conv_C": tail_C, "ssm": new_ssm}


def make_mamba_state(cfg, batch: int, n_layers: int, dtype=None,
                     device=None) -> dict:
    """Zeroed decode state of ``n_layers`` stacked blocks: conv tails in
    the compute dtype, the SSM state in fp32, on ``device`` (``None``:
    the card)."""
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
