"""Knowledge stores (K_i ∪ K_-i) and delay lines for DDAL over flat
gradient planes — the port of the fp32 and int8 parts of
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

**Int8 planes** (``blocks`` given, ``GroupSpec.knowledge_quant_block
> 0``): pieces travel and rest as int8 with fp32 per-block scales,
``scale`` (n, m, nb) in a store and (n, k, D+2, nb) in a delay line,
in the wire format of ``repro_torch.kernels.ddal_wavg.ref``. The
structure carries its ``BlockLayout`` (which scale column each
position of a row reads; blocks restart at every leaf, as the
reference's per-leaf quantization has them). ``sparse_send`` quantizes
each source's piece once, before the gather; the scales then move
with the planes through every write and delivery, exactly like T and
R, and ``weighted_average`` takes the int8 share step. A ``scale`` of
``None`` is an fp32 structure.

The relevance that rides with each piece is the topology's per-edge
R: a host table for a static prior, a device tensor when an estimator
learns it (gathered on the card with the send's edge indices, never
copied to the host).

The dense all-to-all ``InFlight`` (``make_inflight``, ``send``,
``deliver``) is the reference's equivalence oracle for the sparse
delay line at the ``full`` topology, kept for tests; DDAL never runs
it.

The transport checksums (``chk``), the send epochs (``born``) and
elastic membership (``alive``) of the reference wait for a later
slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import BlockLayout
from repro_torch.core.topology import Topology


class KnowledgeStore(NamedTuple):
    grads: torch.Tensor      # (n, m, P) fp32 pieces, or int8
    T: torch.Tensor          # (n, m) training-experience weights
    R: torch.Tensor          # (n, m) relevance weights
    valid: torch.Tensor      # (n, m) bool
    ptr: torch.Tensor        # (n,) int32 — next write slot
    scale: Optional[torch.Tensor] = None     # int8: (n, m, nb) fp32
    blocks: Optional[BlockLayout] = None     # int8: the row's blocks


class SparseInFlight(NamedTuple):
    grads: torch.Tensor      # (n, k, D+2, P) fp32, or int8
    T: torch.Tensor          # (n, k, D+2)
    R: torch.Tensor
    valid: torch.Tensor      # bool
    scale: Optional[torch.Tensor] = None     # int8: (n, k, D+2, nb) fp32
    blocks: Optional[BlockLayout] = None


def _planes(lead, p: int, blocks: Optional[BlockLayout], device):
    """Zeroed (grads, scale) planes: fp32 and no scale, or int8 and
    fp32 per-block scales."""
    if blocks is None:
        return torch.zeros(lead + (p,), dtype=torch.float32,
                           device=device), None
    if blocks.size != p:
        raise ValueError(f"rows have {p} elements, the block layout "
                         f"{blocks.size}")
    return (torch.zeros(lead + (p,), dtype=torch.int8, device=device),
            torch.zeros(lead + (blocks.n_blocks,), dtype=torch.float32,
                        device=device))


def make_store(n: int, m: int, p: int, device,
               blocks: Optional[BlockLayout] = None) -> KnowledgeStore:
    """n empty rings of m pieces of P elements; int8 pieces with
    per-block scales when ``blocks`` (the port's ``quant_block``: the
    int8 block layout of a row, ``PlaneLayout.blocks``) is given."""
    grads, scale = _planes((n, m), p, blocks, device)
    return KnowledgeStore(
        grads=grads,
        T=torch.zeros((n, m), dtype=torch.float32, device=device),
        R=torch.zeros((n, m), dtype=torch.float32, device=device),
        valid=torch.zeros((n, m), dtype=torch.bool, device=device),
        ptr=torch.zeros((n,), dtype=torch.int32, device=device),
        scale=scale, blocks=blocks)


def _need_scale(store, scale, what: str):
    if (store.scale is None) != (scale is None):
        raise ValueError(
            f"{what}: " + ("an int8 store needs the pieces' scales"
                           if scale is None else
                           "an fp32 store takes no scales"))


def append(store: KnowledgeStore, piece, T, R, enabled=True, scale=None
           ) -> KnowledgeStore:
    """Every agent appends one piece (overwriting its oldest when full).
    piece: (n, P); T, R: (n,); enabled: bool or (n,) bool — a disabled
    agent's ring is unchanged. An int8 store takes the pieces' scales
    (n, nb) alongside."""
    _need_scale(store, scale, "append")
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
        ptr=store.ptr + en.to(torch.int32),
        scale=None if scale is None else write(store.scale, scale),
        blocks=store.blocks)


def append_many(store: KnowledgeStore, pieces, T, R, deliver, scales=None
                ) -> KnowledgeStore:
    """Every agent appends up to c pieces at once. Ring semantics are
    exactly those of c sequential ``append`` calls: delivered pieces
    take consecutive slots from ``ptr`` and, when more pieces than
    slots arrive, the later piece wins. pieces: (n, c, P); T, R,
    deliver: (n, c); an int8 store takes the pieces' scales
    (n, c, nb) alongside.

    The winner of each slot is chosen as the reference chooses it (the
    largest piece index landing there), and the write is a gather by
    that index, never a scatter with repeated indices, whose winner
    CUDA leaves undefined."""
    _need_scale(store, scales, "append_many")
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
        ptr=store.ptr + torch.sum(v, dim=-1, dtype=torch.int32),
        scale=None if scales is None else write(store.scale, scales),
        blocks=store.blocks)


def weighted_average(store: KnowledgeStore, use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eq. 4 over every agent's valid pieces → (ḡ (n, P), Σw (n,)).

    The default is the fused share step: one launch of the CUDA kernel
    over the whole (n, m, P) stack, weights rebuilt from (T, R, valid)
    inside it. An int8 store (``store.scale`` set) always takes the
    int8 fused step, which dequantises in the loop. ``use_kernel=True``
    is the reference's legacy path for fp32 stores: eq. 4 weights
    computed outside, then the plain contraction kernel."""
    from repro_torch.kernels.ddal_wavg import ops as wavg_ops
    if store.scale is not None:
        return wavg_ops.fused_wavg_q(store.grads, store.scale, store.T,
                                     store.R, store.valid, store.blocks)
    if use_kernel:
        from repro_torch.core.weighting import eq4_weights
        w = eq4_weights(store.T, store.R, store.valid)
        return wavg_ops.wavg(store.grads, w), torch.sum(w, dim=-1)
    return wavg_ops.fused_wavg(store.grads, store.T, store.R, store.valid)


def make_sparse_inflight(n: int, k: int, max_delay: int, p: int,
                         device, blocks: Optional[BlockLayout] = None
                         ) -> SparseInFlight:
    """An empty delay line of n destinations × k edge slots × (D+2)
    planes; int8 planes with per-block scales when ``blocks`` is
    given."""
    planes = max_delay + 2            # D+1 delivery slots + scratch
    grads, scale = _planes((n, k, planes), p, blocks, device)
    z = torch.zeros((n, k, planes), dtype=torch.float32, device=device)
    return SparseInFlight(
        grads=grads, T=z, R=z.clone(),
        valid=torch.zeros_like(z, dtype=torch.bool), scale=scale,
        blocks=blocks)


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
    experience of the sources; ``topo.relevance`` a host table or a
    device tensor (learned R). On an int8 line each source's piece is
    quantized once, here, and its scales ride with it. Updates
    ``flight`` in place."""
    planes = flight.T.shape[2]
    ii, jj, pp = _send_plan(topo, planes, epoch, enabled)
    if ii.size == 0:
        return flight
    dev = flight.T.device
    src = torch.as_tensor(np.asarray(topo.nbr)[ii, jj], dtype=torch.int64,
                          device=dev)
    i, j, p = (torch.as_tensor(a, dtype=torch.int64, device=dev)
               for a in (ii, jj, pp))
    if isinstance(topo.relevance, torch.Tensor):
        rel = topo.relevance[i, j]
    else:
        rel = torch.as_tensor(np.asarray(topo.relevance)[ii, jj],
                              device=dev)
    if flight.scale is not None:
        from repro_torch.kernels.ddal_wavg.ref import quantize_flat
        pieces, scales = quantize_flat(pieces, flight.blocks)
        flight.scale[i, j, p] = scales[src]
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
    Sm = None if flight.scale is None else flight.scale[:, :, slot]
    m = stores.T.shape[1]
    if _regular_exchange(topo, m, k):
        dev = stores.T.device
        # ptr stays k-aligned and m % k == 0, so the block never wraps
        cols = (stores.ptr[0].to(torch.int64) % m
                + torch.arange(k, device=dev))
        _need_scale(stores, Sm, "sparse_deliver")
        new_stores = KnowledgeStore(
            grads=stores.grads.index_copy(1, cols, pieces),
            T=stores.T.index_copy(1, cols, Tm),
            R=stores.R.index_copy(1, cols, Rm),
            valid=stores.valid.index_copy(1, cols, Vm),
            ptr=stores.ptr + k * Vm[0, 0].to(torch.int32),
            scale=None if Sm is None else stores.scale.index_copy(
                1, cols, Sm),
            blocks=stores.blocks)
    else:
        new_stores = append_many(stores, pieces, Tm, Rm, Vm, scales=Sm)
    flight.valid[:, :, slot] = False
    return flight, new_stores


# ---------------------------------------------------------------------
# dense all-to-all delay line (reference / equivalence oracle)
# ---------------------------------------------------------------------
class InFlight(NamedTuple):
    """Delay line simulating asynchronous delivery. Slot layout
    (dst, delay_slot, src, P): a piece from src→dst sent at epoch t
    sits in slot (t + delay[src, dst]) % (D+1) until epoch
    t + delay[src, dst] pops it."""
    grads: torch.Tensor      # (n_dst, D+1, n_src, P) fp32
    T: torch.Tensor          # (n_dst, D+1, n_src)
    R: torch.Tensor
    valid: torch.Tensor      # bool


def make_inflight(n: int, max_delay: int, p: int, device) -> InFlight:
    D1 = max_delay + 1
    z = torch.zeros((n, D1, n), dtype=torch.float32, device=device)
    return InFlight(
        grads=torch.zeros((n, D1, n, p), dtype=torch.float32,
                          device=device),
        T=z, R=z.clone(), valid=torch.zeros_like(z, dtype=torch.bool))


def send(flight: InFlight, pieces, T, R, delay, epoch: int,
         enabled: bool) -> InFlight:
    """Every agent broadcasts its piece to every destination.

    pieces: (n_src, P); T: (n_src,); R: (n_src, n_dst) relevance of
    src's knowledge to dst; delay: (n_src, n_dst) int; ``enabled``
    (sharing started) a host bool, ``epoch`` a host int. Returns a new
    delay line; a disabled send returns ``flight`` unchanged."""
    if not enabled:
        return flight
    n, D1 = flight.T.shape[:2]
    dev = flight.T.device
    slot = (epoch + torch.as_tensor(delay, dtype=torch.int64,
                                    device=dev)) % D1       # (src, dst)
    src = torch.arange(n, device=dev)[:, None].expand(n, n)
    dst = torch.arange(n, device=dev)[None, :].expand(n, n)
    T = torch.as_tensor(T, dtype=torch.float32, device=dev)
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)

    def put(buf, x):
        out = buf.clone()
        out[dst, slot, src] = x.to(buf.dtype)
        return out

    return InFlight(
        grads=put(flight.grads, pieces[src]),
        T=put(flight.T, T[src]),
        R=put(flight.R, R),
        valid=put(flight.valid, torch.ones((n, n), dtype=torch.bool,
                                           device=dev)))


def deliver(flight: InFlight, stores: KnowledgeStore, epoch: int
            ) -> Tuple[InFlight, KnowledgeStore]:
    """Pop the epoch's arrival slot for every destination and append
    its valid pieces into the stores (fp32)."""
    slot = epoch % flight.T.shape[1]
    new_stores = append_many(stores, flight.grads[:, slot],
                             flight.T[:, slot], flight.R[:, slot],
                             flight.valid[:, slot])
    valid = flight.valid.clone()
    valid[:, slot] = False
    # stale slots are overwritten by the next send
    return flight._replace(valid=valid), new_stores
