"""Mamba2 SSD (state-space duality) sequence mixing — the port of
``repro.models.ssd``.

Chunked algorithm of arXiv:2405.21060 §6: within a chunk the SSM is
computed in its quadratic dual form (``repro_torch.kernels.ssd_scan``:
the CUDA kernel on the card, its plain version on the CPU; a pass that
autograd records differentiates it through the plain version, the
reference's einsum form of ``repro.models.ssd:79-86``); across chunks a
first-order recurrence on the (h, p, n) states carries each chunk's
state into the next. The reference evaluates that recurrence
with ``lax.associative_scan``; here it is a sequential loop over the
chunks, the same products and sums in another fp32 order (the tests
state the tolerance). All decay factors are exp of non-positive
numbers (A < 0, dt ≥ 0).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import heads_of
from repro_torch.models.common import recorded, refuse_pallas


def rank_groups(t: torch.Tensor, head0: int, h: int,
                total_heads: Optional[int]) -> torch.Tensor:
    """(…, g, n) per-group projections of a layer of ``total_heads``
    heads → the groups that its heads ``head0`` .. ``head0 + h − 1``
    read, as (…, g', n) with local head k reading group k // (h / g'),
    the layout ``ssd_chunked`` and the kernel expect: the rank's whole
    groups where its heads cover them, its one group where they lie in
    one, else a group per head. ``total_heads`` None: all the heads."""
    if total_heads is None or (head0 == 0 and h == total_heads):
        return t
    per = total_heads // t.shape[-2]          # heads a group
    first = head0 // per
    if h % per == 0:
        return t[..., first:first + h // per, :]
    if (head0 + h - 1) // per == first:
        return t[..., first:first + 1, :]
    idx = torch.tensor([(head0 + k) // per for k in range(h)],
                       device=t.device)
    return t.index_select(-2, idx)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                impl: str = "xla", head0: int = 0,
                total_heads: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD.

    x: (b, s, h, p) per-head inputs; dt: (b, s, h) positive step sizes
    (already softplus'd); A: (h,) negative decay rates; B, C:
    (b, s, g, n) projections, g groups broadcast onto the heads.
    Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n)
    fp32). ``impl`` is ``ArchConfig.ssd_impl``: it matters only to a
    pass that autograd records, which needs ``"xla"``. ``head0`` /
    ``total_heads``: the h heads are global heads head0 .. head0 + h − 1
    of ``total_heads`` (a rank's block on the model axis), B and C the
    layer's g groups (:func:`rank_groups`).
    """
    b, s, h, p = x.shape
    B = rank_groups(B, head0, h, total_heads)
    C = rank_groups(C, head0, h, total_heads)
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        # pad to a chunk multiple with dt = 0 steps: exp(0·A) = 1 and
        # the state update dt·x·B = 0, so the padding is an exact no-op
        # on the recurrence (outputs at padded positions are dropped)
        pad = chunk - s % chunk
        y, fs = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                            F.pad(dt, (0, 0, 0, pad)), A,
                            F.pad(B, (0, 0, 0, 0, 0, pad)),
                            F.pad(C, (0, 0, 0, 0, 0, pad)), chunk,
                            initial_state=initial_state, impl=impl)
        return y[:, :s], fs
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).contiguous()
    dtc = dt.reshape(b, nc, chunk, h).to(f32).contiguous()
    Bg = B.reshape(b, nc, chunk, g, n).contiguous()
    Cg = C.reshape(b, nc, chunk, g, n).contiguous()

    dA = dtc * A.to(f32)                                # (b,nc,l,h) ≤ 0
    cs = torch.cumsum(dA, dim=2)                        # inclusive

    # ---- intra-chunk (dual quadratic form) ------------------------------
    # the kernel (B and C by group: it maps each head onto its group);
    # a recorded pass takes its gradient from the plain einsum form
    if recorded(xc, dtc, cs, Bg, Cg):
        refuse_pallas("ssd_impl", impl)
    y_diag = ssd_ops.ssd_intra_chunk_with_vjp(xc, dtc, cs, Bg, Cg)

    # ---- chunk states ------------------------------------------------
    Bc = heads_of(Bg, h).to(f32)                        # (b,nc,l,h,n)
    Cc = heads_of(Cg, h).to(f32)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)     # (b,nc,l,h)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bc,
                          decay_to_end * dtc, xc.to(f32))   # (b,nc,h,p,n)
    chunk_decay = torch.exp(cs[:, :, -1, :])            # (b,nc,h)

    # ---- inter-chunk recurrence (sequential over the chunks) -----------
    # S_k = S_{k-1} · decay_k + states_k; the state entering chunk k is
    # S_{k-1}, the initial state (or zeros) for the first chunk
    run = (initial_state.to(f32) if initial_state is not None
           else torch.zeros((b, h, p, n), dtype=f32, device=x.device))
    entering = []
    for k in range(nc):
        entering.append(run)
        run = run * chunk_decay[:, k, :, None, None] + states[:, k]
    states_in = torch.stack(entering, dim=1)            # (b,nc,h,p,n)
    final_state = run

    # ---- inter-chunk output contribution -------------------------------
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc, states_in,
                         torch.exp(cs))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), final_state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    head0: int = 0, total_heads: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update.

    state: (b, h, p, n); x: (b, h, p); dt: (b, h); B, C: (b, g, n).
    Returns (y (b, h, p) in x's dtype, new_state). ``head0`` /
    ``total_heads``: as :func:`ssd_chunked`'s."""
    f32 = torch.float32
    h = x.shape[1]
    B = rank_groups(B, head0, h, total_heads)
    C = rank_groups(C, head0, h, total_heads)
    Bh = heads_of(B, h).to(f32)                         # (b,h,n)
    Ch = heads_of(C, h).to(f32)
    dtf = dt.to(f32)
    dA = torch.exp(dtf * A.to(f32))                     # (b,h)
    upd = (dtf[..., None] * x.to(f32))[..., None] * Bh[:, :, None, :]
    new_state = state * dA[..., None, None] + upd       # (b,h,p,n)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state
