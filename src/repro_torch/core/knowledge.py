"""Knowledge stores (K_i ∪ K_-i) and delay lines for DDAL over flat
gradient planes — the port of the fp32 part of
``repro.core.knowledge``.

A ``KnowledgeStore`` holds every agent's ring buffer of the last ``m``
gradient pieces with their (T, R) weighting metadata: planes (n, m, P),
one flat fp32 row per piece. A ``SparseInFlight`` is the
neighbor-indexed delay line: for destination i and edge slot j (< k)
it carries pieces from ``topo.nbr[i, j]``; planes (n, k, D+2, P), that
is D+1 delivery slots plus one trailing scratch plane that absorbs
disabled writes.

The epoch and the sharing gate are host values in the port, and the
topology is a host table, so which edge writes which delay plane is
worked out on the host and the device sees one indexed write with
unique indices (no write order to depend on). The delay line is
updated in place, since it is the largest buffer of the loop; the
stores are returned as new tensors.

The int8 planes (``scale``), the transport checksums (``chk``) and the
send epochs (``born``) of the reference wait for later slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topology import Topology


class KnowledgeStore(NamedTuple):
    grads: torch.Tensor      # (n, m, P) fp32 pieces
    T: torch.Tensor          # (n, m) training-experience weights
    R: torch.Tensor          # (n, m) relevance weights
    valid: torch.Tensor      # (n, m) bool
    ptr: torch.Tensor        # (n,) int32 — next write slot


class SparseInFlight(NamedTuple):
    grads: torch.Tensor      # (n, k, D+2, P) fp32
    T: torch.Tensor          # (n, k, D+2)
    R: torch.Tensor
    valid: torch.Tensor      # bool


def make_store(n: int, m: int, p: int, device) -> KnowledgeStore:
    """n empty rings of m pieces of P elements."""
    return KnowledgeStore(
        grads=torch.zeros((n, m, p), dtype=torch.float32, device=device),
        T=torch.zeros((n, m), dtype=torch.float32, device=device),
        R=torch.zeros((n, m), dtype=torch.float32, device=device),
        valid=torch.zeros((n, m), dtype=torch.bool, device=device),
        ptr=torch.zeros((n,), dtype=torch.int32, device=device))


def append(store: KnowledgeStore, piece, T, R, enabled=True
           ) -> KnowledgeStore:
    """Every agent appends one piece (overwriting its oldest when full).
    piece: (n, P); T, R: (n,); enabled: bool or (n,) bool — a disabled
    agent's ring is unchanged."""
    n, m = store.T.shape
    dev = store.T.device
    en = torch.as_tensor(enabled, device=dev).expand(n)
    slot = torch.where(en, store.ptr % m, m)                # m ⇒ no write
    hit = torch.arange(m, device=dev)[None, :] == slot[:, None]   # (n, m)

    def write(buf, x):
        mask = hit.reshape(hit.shape + (1,) * (buf.ndim - 2))
        x = torch.as_tensor(x, dtype=buf.dtype, device=dev)
        return torch.where(mask, x.reshape((n, 1) + buf.shape[2:]), buf)

    return KnowledgeStore(
        grads=write(store.grads, piece),
        T=write(store.T, torch.as_tensor(T).expand(n)),
        R=write(store.R, torch.as_tensor(R).expand(n)),
        valid=write(store.valid, torch.ones((n,), dtype=torch.bool)),
        ptr=store.ptr + en.to(torch.int32))


def append_many(store: KnowledgeStore, pieces, T, R, deliver
                ) -> KnowledgeStore:
    """Every agent appends up to c pieces at once. Ring semantics are
    exactly those of c sequential ``append`` calls: delivered pieces
    take consecutive slots from ``ptr`` and, when more pieces than
    slots arrive, the later piece wins. pieces: (n, c, P); T, R,
    deliver: (n, c).

    The winner of each slot is chosen as the reference chooses it (the
    largest piece index landing there), and the write is a gather by
    that index, never a scatter with repeated indices, whose winner
    CUDA leaves undefined."""
    n, m = store.T.shape
    c = T.shape[-1]
    dev = store.T.device
    v = deliver.to(torch.int32)
    rank = torch.cumsum(v, dim=-1, dtype=torch.int32) - v       # exclusive
    slot = torch.where(deliver, (store.ptr[:, None] + rank) % m, m)  # (n, c)
    hit = slot[:, None, :] == torch.arange(m, device=dev)[None, :, None]
    idx = torch.arange(c, device=dev).expand(n, m, c)
    sel = torch.amax(torch.where(hit, idx, -1), dim=-1)          # (n, m)
    has = sel >= 0
    sel_c = torch.clamp_min(sel, 0).to(torch.int64)

    def write(buf, xs):
        rows = sel_c.reshape(sel_c.shape + (1,) * (buf.ndim - 2))
        got = torch.gather(xs.to(buf.dtype), 1,
                           rows.expand((n, m) + buf.shape[2:]))
        mask = has.reshape(has.shape + (1,) * (buf.ndim - 2))
        return torch.where(mask, got, buf)

    return KnowledgeStore(
        grads=write(store.grads, pieces),
        T=write(store.T, T),
        R=write(store.R, R),
        valid=torch.where(has, True, store.valid),
        ptr=store.ptr + torch.sum(v, dim=-1, dtype=torch.int32))


def weighted_average(store: KnowledgeStore, use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eq. 4 over every agent's valid pieces → (ḡ (n, P), Σw (n,)).

    The default is the fused share step: one launch of the CUDA kernel
    over the whole (n, m, P) stack, weights rebuilt from (T, R, valid)
    inside it. ``use_kernel=True`` is the reference's legacy path:
    eq. 4 weights computed outside, then the plain contraction
    kernel."""
    from repro_torch.kernels.ddal_wavg import ops as wavg_ops
    if use_kernel:
        from repro_torch.core.weighting import eq4_weights
        w = eq4_weights(store.T, store.R, store.valid)
        return wavg_ops.wavg(store.grads, w), torch.sum(w, dim=-1)
    return wavg_ops.fused_wavg(store.grads, store.T, store.R, store.valid)


def make_sparse_inflight(n: int, k: int, max_delay: int, p: int,
                         device) -> SparseInFlight:
    planes = max_delay + 2            # D+1 delivery slots + scratch
    z = torch.zeros((n, k, planes), dtype=torch.float32, device=device)
    return SparseInFlight(
        grads=torch.zeros((n, k, planes, p), dtype=torch.float32,
                          device=device),
        T=z, R=z.clone(), valid=torch.zeros_like(z, dtype=torch.bool))


def _send_plan(topo: Topology, planes: int, epoch: int, enabled: bool):
    """Host plan of one send: the (dst, edge, plane) of every write.

    It reproduces which planes each of the reference's three send
    paths touches, scratch-plane writes included, so the whole delay
    line (not only its live planes) matches: the uniform-delay,
    unpadded path writes every edge to one plane (the scratch plane
    when disabled); the uniform-delay padded path writes only gated
    edges; the heterogeneous path writes every edge, gated ones to
    their arrival plane and the rest to the scratch plane."""
    D1 = planes - 1
    delay = np.asarray(topo.delay)
    mask = np.asarray(topo.mask)
    gate = bool(enabled) & mask
    uniform = bool(delay.size) and bool((delay == delay.flat[0]).all())
    if uniform:
        base = (epoch + int(delay.flat[0])) % D1
        if mask.all():
            plane = np.full(mask.shape, base if enabled else D1)
            write = np.ones(mask.shape, bool)
        else:
            plane = np.full(mask.shape, base)
            write = gate
    else:
        plane = np.where(gate, (epoch + delay) % D1, D1)
        write = np.ones(mask.shape, bool)
    ii, jj = np.nonzero(write)
    return ii, jj, plane[ii, jj]


def sparse_send(flight: SparseInFlight, topo: Topology, pieces, T,
                epoch: int, enabled: bool) -> SparseInFlight:
    """Every agent publishes its piece; each destination gathers it
    from its in-neighbors only, into the edge's arrival plane
    (epoch + delay) % (D+1). pieces: (n, P); T: (n,) training
    experience of the sources. Updates ``flight`` in place."""
    planes = flight.T.shape[2]
    ii, jj, pp = _send_plan(topo, planes, epoch, enabled)
    if ii.size == 0:
        return flight
    dev = flight.T.device
    src = torch.as_tensor(np.asarray(topo.nbr)[ii, jj], dtype=torch.int64,
                          device=dev)
    rel = torch.as_tensor(np.asarray(topo.relevance)[ii, jj], device=dev)
    i, j, p = (torch.as_tensor(a, dtype=torch.int64, device=dev)
               for a in (ii, jj, pp))
    flight.grads[i, j, p] = pieces[src].to(flight.grads.dtype)
    flight.T[i, j, p] = torch.as_tensor(T, device=dev)[src]
    flight.R[i, j, p] = rel
    flight.valid[i, j, p] = True
    return flight


def _regular_exchange(topo: Optional[Topology], m: int, k: int) -> bool:
    """True when every delivery is a full, aligned k-block: all edges
    real, one shared delay, and the ring capacity a multiple of k."""
    if topo is None or k > m or m % k != 0:
        return False
    d = np.asarray(topo.delay)
    return bool(np.asarray(topo.mask).all()) and bool((d == d.flat[0]).all())


def sparse_deliver(flight: SparseInFlight, stores: KnowledgeStore,
                   epoch: int, topo: Optional[Topology] = None
                   ) -> Tuple[SparseInFlight, KnowledgeStore]:
    """Pop the epoch's arrival plane for every destination and append
    its valid pieces (k per destination) into the stores.

    With a statically regular ``topo`` (``_regular_exchange``) every
    delivery is one aligned k-block written at ``ptr`` — also on
    warm-up epochs, whose invalid block leaves ``ptr`` where it was —
    as the reference's fast path does; otherwise the general
    ``append_many``. The popped plane's valid bits are cleared in
    place."""
    n, k, planes = flight.T.shape
    slot = epoch % (planes - 1)
    pieces = flight.grads[:, :, slot]
    Tm = flight.T[:, :, slot]
    Rm = flight.R[:, :, slot]
    Vm = flight.valid[:, :, slot]
    m = stores.T.shape[1]
    if _regular_exchange(topo, m, k):
        dev = stores.T.device
        # ptr stays k-aligned and m % k == 0, so the block never wraps
        cols = (stores.ptr[0].to(torch.int64) % m
                + torch.arange(k, device=dev))
        new_stores = KnowledgeStore(
            grads=stores.grads.index_copy(1, cols, pieces),
            T=stores.T.index_copy(1, cols, Tm),
            R=stores.R.index_copy(1, cols, Rm),
            valid=stores.valid.index_copy(1, cols, Vm),
            ptr=stores.ptr + k * Vm[0, 0].to(torch.int32))
    else:
        new_stores = append_many(stores, pieces, Tm, Rm, Vm)
    flight.valid[:, :, slot] = False
    return flight, new_stores
