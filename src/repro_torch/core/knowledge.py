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

**Elastic membership** (``alive``, a host (n,) bool for the send, its
device copy for the delivery): a dead source publishes nothing and a
dead destination's line stays empty — folded into the host send plan
— and a delivery to a dead destination is dropped. Dead rows stay in
the eq. 4 layout as invalid holes; nothing is compacted away.

**Faulty transport and staleness** (``repro_torch.core.transport``):
a transport line carries ``chk`` (n, k, D+2) fp32 payload checksums
stamped at send and a ``LeafTable`` to recompute them; a line or store
that tracks staleness carries ``born`` int32 send epochs beside T and
R. A send with this epoch's ``TransportFaults`` writes every edge: a
dropped edge to the scratch plane, a delayed one ``extra`` planes
later, a duplicated one also one plane after that, and a corrupted
one with its payload garbled after the checksum was taken; the
self-loop is exempt. Every delivery on a transport line is checked, a
mismatch quarantined (payload and scales zeroed, ``valid`` cleared),
and deliveries take the general path. Staleness-only lines (``born``
and no ``chk``) keep the aligned fast path.

The dense all-to-all ``InFlight`` (``make_inflight``, ``send``,
``deliver``) is the reference's equivalence oracle for the sparse
delay line at the ``full`` topology, kept for tests; DDAL never runs
it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import BlockLayout
from repro_torch.core.topology import Topology
from repro_torch.core import transport as TP


class KnowledgeStore(NamedTuple):
    grads: torch.Tensor      # (n, m, P) fp32 pieces, or int8
    T: torch.Tensor          # (n, m) training-experience weights
    R: torch.Tensor          # (n, m) relevance weights
    valid: torch.Tensor      # (n, m) bool
    ptr: torch.Tensor        # (n,) int32 — next write slot
    scale: Optional[torch.Tensor] = None     # int8: (n, m, nb) fp32
    blocks: Optional[BlockLayout] = None     # int8: the row's blocks
    born: Optional[torch.Tensor] = None      # staleness: (n, m) int32


class SparseInFlight(NamedTuple):
    grads: torch.Tensor      # (n, k, D+2, P) fp32, or int8
    T: torch.Tensor          # (n, k, D+2)
    R: torch.Tensor
    valid: torch.Tensor      # bool
    scale: Optional[torch.Tensor] = None     # int8: (n, k, D+2, nb) fp32
    blocks: Optional[BlockLayout] = None
    chk: Optional[torch.Tensor] = None       # transport: (n, k, D+2) fp32
    born: Optional[torch.Tensor] = None      # staleness: (n, k, D+2) int32
    leaves: Optional[TP.LeafTable] = None    # transport: checksum leaves


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
               blocks: Optional[BlockLayout] = None,
               track_born: bool = False) -> KnowledgeStore:
    """n empty rings of m pieces of P elements; int8 pieces with
    per-block scales when ``blocks`` (the port's ``quant_block``: the
    int8 block layout of a row, ``PlaneLayout.blocks``) is given;
    ``track_born`` adds the (n, m) int32 send-epoch plane."""
    grads, scale = _planes((n, m), p, blocks, device)
    return KnowledgeStore(
        grads=grads,
        T=torch.zeros((n, m), dtype=torch.float32, device=device),
        R=torch.zeros((n, m), dtype=torch.float32, device=device),
        valid=torch.zeros((n, m), dtype=torch.bool, device=device),
        ptr=torch.zeros((n,), dtype=torch.int32, device=device),
        scale=scale, blocks=blocks,
        born=(torch.zeros((n, m), dtype=torch.int32, device=device)
              if track_born else None))


def _need_scale(store, scale, what: str, born=None):
    if (store.scale is None) != (scale is None):
        raise ValueError(
            f"{what}: " + ("an int8 store needs the pieces' scales"
                           if scale is None else
                           "an fp32 store takes no scales"))
    if store.born is not None and born is None:
        raise ValueError(f"{what}: a staleness-tracked store needs the "
                         f"pieces' born epochs")


def append(store: KnowledgeStore, piece, T, R, enabled=True, scale=None,
           born=None) -> KnowledgeStore:
    """Every agent appends one piece (overwriting its oldest when full).
    piece: (n, P); T, R: (n,); enabled: bool or (n,) bool — a disabled
    agent's ring is unchanged. An int8 store takes the pieces' scales
    (n, nb) alongside, a staleness-tracked one their send epochs."""
    _need_scale(store, scale, "append", born)
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
        blocks=store.blocks,
        born=None if store.born is None else write(
            store.born, torch.as_tensor(born).expand(n)))


def append_many(store: KnowledgeStore, pieces, T, R, deliver, scales=None,
                borns=None) -> KnowledgeStore:
    """Every agent appends up to c pieces at once. Ring semantics are
    exactly those of c sequential ``append`` calls: delivered pieces
    take consecutive slots from ``ptr`` and, when more pieces than
    slots arrive, the later piece wins. pieces: (n, c, P); T, R,
    deliver: (n, c); an int8 store takes the pieces' scales
    (n, c, nb) alongside, a staleness-tracked one their send epochs
    (n, c).

    The winner of each slot is chosen as the reference chooses it (the
    largest piece index landing there), and the write is a gather by
    that index, never a scatter with repeated indices, whose winner
    CUDA leaves undefined."""
    _need_scale(store, scales, "append_many", borns)
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
        blocks=store.blocks,
        born=None if store.born is None else write(store.born, borns))


def select_rows(pred: torch.Tensor, a: KnowledgeStore, b: KnowledgeStore
                ) -> KnowledgeStore:
    """Agent-row-wise ``where(pred, a, b)`` over two stores of one
    layout; ``pred`` is (n,) bool on the device."""
    def sel(x, y):
        if not isinstance(x, torch.Tensor):
            return y
        return torch.where(pred.reshape((-1,) + (1,) * (x.ndim - 1)), x, y)
    return KnowledgeStore(*(sel(x, y) for x, y in zip(a, b)))


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
                         device, blocks: Optional[BlockLayout] = None,
                         leaves: Optional[TP.LeafTable] = None,
                         track_born: bool = False) -> SparseInFlight:
    """An empty delay line of n destinations × k edge slots × (D+2)
    planes; int8 planes with per-block scales when ``blocks`` is given;
    checksum planes when ``leaves`` (the rows' ``LeafTable``, a faulty
    transport) is given; send-epoch planes with ``track_born``."""
    planes = max_delay + 2            # D+1 delivery slots + scratch
    grads, scale = _planes((n, k, planes), p, blocks, device)
    z = torch.zeros((n, k, planes), dtype=torch.float32, device=device)
    return SparseInFlight(
        grads=grads, T=z, R=z.clone(),
        valid=torch.zeros_like(z, dtype=torch.bool), scale=scale,
        blocks=blocks, chk=None if leaves is None else z.clone(),
        born=(torch.zeros_like(z, dtype=torch.int32) if track_born
              else None),
        leaves=leaves)


def _gate(topo: Topology, enabled: bool, alive) -> np.ndarray:
    """(n, k) host bool: the edges that send — sharing, a real edge,
    and (elastic) source and destination both alive."""
    gate = bool(enabled) & np.asarray(topo.mask)
    if alive is not None:
        a = np.asarray(alive, bool)
        gate = gate & a[np.asarray(topo.nbr)] & a[:, None]
    return gate


def _send_plan(topo: Topology, planes: int, epoch: int, enabled: bool,
               alive=None, one_hot: bool = False):
    """Host plan of one send: the (dst, edge, plane) of every write.

    It reproduces which planes each of the reference's three send
    paths touches, scratch-plane writes included, so the whole delay
    line (not only its live planes) matches: the uniform-delay,
    unpadded path with no membership mask writes every edge to one
    plane (the scratch plane when disabled); the uniform-delay gated
    path (padded edges, or ``alive`` given) writes only gated edges;
    the heterogeneous (one-hot) path writes every edge, gated ones to
    their arrival plane and the rest to the scratch plane. The reference
    takes the one-hot path whenever the delays are traced, as a
    resampled table's are: ``one_hot=True``."""
    D1 = planes - 1
    delay = np.asarray(topo.delay)
    mask = np.asarray(topo.mask)
    gate = _gate(topo, enabled, alive)
    uniform = (not one_hot and bool(delay.size)
               and bool((delay == delay.flat[0]).all()))
    if uniform:
        base = (epoch + int(delay.flat[0])) % D1
        if alive is None and mask.all():
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


def _fault_plan(topo: Topology, planes: int, epoch: int, enabled: bool,
                alive, faults: TP.TransportFaults):
    """Host plan of a faulted send, the reference's one-hot path: every
    edge writes two planes, its arrival plane at ``delay + extra`` (the
    scratch plane when dropped or gated off) and, for a duplicated live
    edge, the plane one epoch later (else the scratch plane again).
    Returns (ii, jj, planes) of the distinct writes and the (n, k) edges
    whose payload is corrupted; the self-loop is exempt from every
    fault."""
    D1 = planes - 1
    nbr = np.asarray(topo.nbr)
    n = nbr.shape[0]
    self_edge = nbr == np.arange(n)[:, None]
    live = _gate(topo, enabled, alive) & (self_edge | ~faults.drop)
    delay = np.asarray(topo.delay) + np.where(self_edge, 0, faults.extra)
    slot = np.where(live, (epoch + delay) % D1, D1)
    dup = live & faults.dup & ~self_edge
    slot2 = np.where(dup, (epoch + delay + 1) % D1, D1)
    ii, jj = np.nonzero(np.ones(nbr.shape, bool))
    i2, j2 = np.nonzero(slot2 != slot)
    return (np.concatenate([ii, i2]), np.concatenate([jj, j2]),
            np.concatenate([slot[ii, jj], slot2[i2, j2]]),
            faults.corrupt & ~self_edge)


def sparse_send(flight: SparseInFlight, topo: Topology, pieces, T,
                epoch: int, enabled: bool, alive=None,
                faults: Optional[TP.TransportFaults] = None,
                one_hot: bool = False) -> SparseInFlight:
    """Every agent publishes its piece; each destination gathers it
    from its in-neighbors only, into the edge's arrival plane
    (epoch + delay) % (D+1). pieces: (n, P); T: (n,) training
    experience of the sources; ``topo.relevance`` a host table or a
    device tensor (learned R); ``alive`` a host (n,) bool (elastic
    membership). On an int8 line each source's piece is quantized once,
    here, and its scales ride with it. A transport line (``chk``
    planes) needs this epoch's ``faults`` and takes the faulted plan;
    ``born`` planes get the epoch. ``one_hot`` picks the reference's
    one-hot plan for a resampled table (see ``_send_plan``). Updates
    ``flight`` in place."""
    n, k, planes = flight.T.shape
    if (flight.chk is None) != (faults is None):
        raise ValueError(
            "a transport delay line (checksum planes) needs this "
            "epoch's TransportFaults, and only such a line takes them")
    corrupt = None
    if faults is None:
        ii, jj, pp = _send_plan(topo, planes, epoch, enabled, alive,
                                one_hot)
        if ii.size == 0:
            return flight
    else:
        ii, jj, pp, corrupt = _fault_plan(topo, planes, epoch, enabled,
                                          alive, faults)
    dev = flight.T.device
    nbr = np.asarray(topo.nbr)
    src = torch.as_tensor(nbr[ii, jj], dtype=torch.int64, device=dev)
    i, j, p = (torch.as_tensor(a, dtype=torch.int64, device=dev)
               for a in (ii, jj, pp))
    if isinstance(topo.relevance, torch.Tensor):
        rel = topo.relevance[i, j]
    else:
        rel = torch.as_tensor(np.asarray(topo.relevance)[ii, jj],
                              device=dev)
    scales = None
    if flight.scale is not None:
        from repro_torch.kernels.ddal_wavg.ref import quantize_flat
        pieces, scales = quantize_flat(pieces, flight.blocks)
    if faults is None:
        flight.grads[i, j, p] = pieces[src].to(flight.grads.dtype)
        if scales is not None:
            flight.scale[i, j, p] = scales[src]
    else:
        # every edge's gathered payload, checksummed clean, then garbled
        # where corrupted; the writes (duplicates included) index it
        every = torch.as_tensor(nbr.reshape(-1), dtype=torch.int64,
                                device=dev)
        rows = pieces[every].to(flight.grads.dtype)
        srows = None if scales is None else scales[every]
        chk = TP.plane_checksum(rows, srows, flight.leaves)
        if corrupt.any():
            rows = TP.corrupt_planes(rows, torch.as_tensor(
                corrupt.reshape(-1), device=dev))
        e = i * k + j
        flight.grads[i, j, p] = rows[e]
        if srows is not None:
            flight.scale[i, j, p] = srows[e]
        flight.chk[i, j, p] = chk[e]
    flight.T[i, j, p] = torch.as_tensor(T, device=dev)[src]
    flight.R[i, j, p] = rel
    flight.valid[i, j, p] = True
    if flight.born is not None:
        flight.born[i, j, p] = int(epoch)
    return flight


def _regular_exchange(topo: Optional[Topology], m: int, k: int) -> bool:
    """True when every delivery is a full, aligned k-block: all edges
    real, one shared delay, and the ring capacity a multiple of k."""
    if topo is None or k > m or m % k != 0:
        return False
    d = np.asarray(topo.delay)
    return bool(np.asarray(topo.mask).all()) and bool((d == d.flat[0]).all())


def sparse_deliver(flight: SparseInFlight, stores: KnowledgeStore,
                   epoch: int, topo: Optional[Topology] = None,
                   alive: Optional[torch.Tensor] = None
                   ) -> Tuple[SparseInFlight, KnowledgeStore]:
    """Pop the epoch's arrival plane for every destination and append
    its valid pieces (k per destination) into the stores.

    With a statically regular ``topo`` (``_regular_exchange``) and no
    checksum planes every delivery is one aligned k-block written at
    ``ptr`` — also on warm-up epochs, whose invalid block leaves
    ``ptr`` where it was — as the reference's fast path does;
    otherwise the general ``append_many``. ``alive`` ((n,) bool on the
    device) drops every arrival at a dead destination; on the aligned
    path a dead source's slot is then an invalid hole and the block
    advances when anything arrived. A transport line's arrivals are
    checked against their send checksums and quarantined on a
    mismatch. The popped plane's valid bits are cleared in place."""
    n, k, planes = flight.T.shape
    slot = epoch % (planes - 1)
    pieces = flight.grads[:, :, slot]
    Tm = flight.T[:, :, slot]
    Rm = flight.R[:, :, slot]
    Vm = flight.valid[:, :, slot]
    Sm = None if flight.scale is None else flight.scale[:, :, slot]
    Bm = None if flight.born is None else flight.born[:, :, slot]
    if alive is not None:
        Vm = Vm & alive[:, None]
    if flight.chk is not None:
        ok = TP.checksum_ok(flight.chk[:, :, slot],
                            TP.plane_checksum(pieces, Sm, flight.leaves))
        Vm = Vm & ok
        # quarantine: the corrupted payload (and its scales) is zeroed
        pieces = torch.where(ok[..., None], pieces, 0).to(pieces.dtype)
        if Sm is not None:
            Sm = torch.where(ok[..., None], Sm, 0.0)
    m = stores.T.shape[1]
    if _regular_exchange(topo, m, k) and flight.chk is None:
        dev = stores.T.device
        # ptr stays k-aligned and m % k == 0, so the block never wraps
        cols = (stores.ptr[0].to(torch.int64) % m
                + torch.arange(k, device=dev))
        _need_scale(stores, Sm, "sparse_deliver", Bm)
        delivered = Vm[0, 0] if alive is None else Vm.any()
        new_stores = KnowledgeStore(
            grads=stores.grads.index_copy(1, cols, pieces),
            T=stores.T.index_copy(1, cols, Tm),
            R=stores.R.index_copy(1, cols, Rm),
            valid=stores.valid.index_copy(1, cols, Vm),
            ptr=stores.ptr + k * delivered.to(torch.int32),
            scale=None if Sm is None else stores.scale.index_copy(
                1, cols, Sm),
            blocks=stores.blocks,
            born=None if Bm is None else stores.born.index_copy(
                1, cols, Bm))
    else:
        new_stores = append_many(stores, pieces, Tm, Rm, Vm, scales=Sm,
                                 borns=Bm)
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
