"""Combiners — *how gathered knowledge becomes one update*. The port
has the buffer trainer's ``store`` combiner of
``repro.core.exchange.combiners`` (the eq. 4 weighted average over
every agent's knowledge store), the streaming trainer's ``flat`` and
``pod`` combiners (below, after the store's notes) and the shared
per-edge relevance tail ``edge_effective``.

The reference vmaps the share step over the n stores; the port hands
the whole (n, m, P) plane stack to one launch of the fused CUDA kernel
(``repro_torch.kernels.ddal_wavg``), int8 stores to its int8 twin.

**Staleness-aware weighting** (``max_staleness`` set, or a faulty
transport with ``transport_decay < 1``): a piece's age is ``step −
born``; pieces older than ``max_staleness`` lose their ``valid`` bit
and T and R are discounted by ``decay**age`` before the kernel forms
the eq. 4 weights, on the device. ``torch.pow`` and XLA's ``power`` on
the CPU may round ``decay**age`` one ulp apart, so against the
reference the discounted weights agree to a few ulps, not to the bit;
the kernel and its plain version get the same T and R and stay
bitwise. When every piece ages out the weight sum is 0 and the trainer
takes its local update.

``flat`` (the reference's ``combiners.py:70-156``) combines the
streaming trainer's window (``repro_torch.core.sharded_ddal``): with no
schedule (``full``, nothing time-varying) the global-sum fast path when
nothing weights the edges, else the dense eq. 4 with the learned R
times the prior; with a schedule the neighbour-local sums over the
step's edge table, the learned R gathered onto the edges; a faulty
transport drops this round's lost and corrupted edges (the self-loop
always survives). ``knowledge_quant_block > 0`` pushes the window
through the int8 wire format and ``alive`` zeroes dead agents' rows on
the way in, a column chunk at a time. On a device mesh (``mesh=``) each
chunk of the window is gathered over the world and the rank keeps its
destination rows: bitwise the single-device result.

``pod`` (the reference's ``combiners.py:161-205``) is the two-level
dispatch of a static ``hierarchical`` topology
(``repro_torch.core.pod_dispatch``): the intra-pod sums, then the
leader-level ones, on one device or over a ``(pod_axis, "agent")`` mesh
where only the leaders' planes cross the pod axis. It refuses a faulty
transport and a resampling schedule as the reference does, reads the
layout ``hierarchical_layout(n_agents, degree)``, takes the window
through the int8 round trip (``quantize_knowledge_roundtrip``, applied
a column chunk at a time) and, with a learning estimator, the learned
R gathered onto the edges (``edge_effective``) as the relevance
override.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import knowledge as K
from repro_torch.core import relevance as REL
from repro_torch.core.exchange.registry import COMBINERS
from repro_torch.core.topology import Topology
from repro_torch.core.weighting import combine_relevance, relevance_matrix


def edge_effective(topo: Topology, rel: torch.Tensor, nbr: torch.Tensor,
                   mask: torch.Tensor, prior: torch.Tensor) -> Topology:
    """Per-edge effective relevance: static prior × the learned (n, n)
    estimate gathered onto the edge table, zero on masked edges. The
    result is a device tensor in ``topo.relevance``; ``nbr``, ``mask``
    and ``prior`` are ``topo``'s tables on ``rel``'s device."""
    eff = combine_relevance(prior, REL.gather_edges(rel, nbr))
    return topo._replace(
        relevance=torch.where(mask, eff, torch.zeros_like(eff)))


def age_gate(stores: K.KnowledgeStore, step: int, max_staleness=None,
             decay: float = 1.0) -> K.KnowledgeStore:
    """``valid & (age <= max_staleness)`` and T, R × ``decay**age`` with
    ``age = step − born``, on the device."""
    if stores.born is None:
        raise ValueError(
            "staleness-aware combine needs born-tracked stores "
            "(make_store(..., track_born=True)) — the trainer's "
            "init() was built against a different spec")
    age = int(step) - stores.born                           # (n, m) int32
    valid = stores.valid
    if max_staleness is not None:
        valid = valid & (age <= max_staleness)
    T, R = stores.T, stores.R
    if decay < 1.0:
        d = torch.pow(torch.tensor(decay, dtype=torch.float32,
                                   device=age.device),
                      torch.clamp_min(age, 0).to(torch.float32))
        T, R = T * d, R * d
    return stores._replace(T=T, R=R, valid=valid)


@COMBINERS.register(
    "store", params={"quant_block": ("knowledge_quant_block", int)})
def make_store_combiner(*, spec, transport=None,
                        use_wavg_kernel: bool = False):
    """``combine(stores, rel, step, alive=None, out=None) -> (ḡ (n, P),
    Σw (n,))``. Relevance already rode in on each piece's R at delivery,
    so ``rel`` is unused, as are ``alive`` and ``out``.
    ``use_wavg_kernel=True`` keeps the legacy path: weights computed
    outside, then the plain contraction kernel. Int8 stores
    (``knowledge_quant_block > 0``) always take the int8 fused step.
    With ``spec.max_staleness`` or a ``transport`` and
    ``spec.transport_decay < 1`` the stores pass the age gate first."""
    ms = spec.max_staleness
    decay = spec.transport_decay if transport is not None else 1.0
    stale_gate = ms is not None or decay < 1.0

    def combine(stores, rel, step, alive=None, out=None):
        # stores hold only live agents' pieces (the send path gates
        # them), and a dead destination's row is selected away upstream
        del rel, alive, out
        if stale_gate:
            stores = age_gate(stores, step, ms, decay)
        return K.weighted_average(stores, use_kernel=use_wavg_kernel)

    return combine


@COMBINERS.register(
    "flat", params={"r_weighting": ("r_weighting", str),
                    "quant_block": ("knowledge_quant_block", int)})
def make_flat_combiner(*, spec, schedule, estimator, dense_R=None,
                       transport=None, mesh=None):
    """``combine(window, rel, step, alive=None, out=None) -> ḡ``, a tree
    of (A, *param) fp32 leaves (written into ``out`` when given).
    ``schedule=None`` marks the topology-free ``full`` case; ``rel`` is
    the learned dense (A, A) R (``None`` when nothing is learned). On
    ``mesh`` the window and ḡ are the rank's rows."""
    from repro_torch.core import sharded_ddal as SD
    A = spec.n_agents
    learns = estimator.learns
    qb = spec.knowledge_quant_block
    shard = (None if mesh is None
             else SD.agent_shard(mesh, A, spec.pod_axis))

    if schedule is None:
        if transport is not None:
            raise ValueError(
                "the faulty transport drops per-round edges and needs "
                "an edge table — build_exchange keeps a schedule when "
                "transport is enabled, so a None schedule here is a "
                "construction bug")
        uniform = (dense_R is None and spec.r_weighting == "uniform"
                   and not learns)
        R0 = (relevance_matrix(A, "uniform") if dense_R is None
              else torch.as_tensor(dense_R, dtype=torch.float32))

        def combine(window, rel, step, alive=None, out=None):
            del step
            R = R0.to(window.tsum.device)
            if learns:
                R = combine_relevance(R, rel)
            return SD._combine(window, R, uniform, out, alive, qb, shard)
        return combine

    def combine(window, rel, step, alive=None, out=None):
        dev = window.tsum.device
        alive_h = (alive.cpu().numpy() if alive is not None
                   and schedule.resamples else None)
        topo = schedule.at_step(step, rel if learns else None, alive_h)
        if learns:
            topo = edge_effective(topo, rel, *SD.topo_tables(topo, dev))
        if transport is not None:
            topo = SD.drop_topology_edges(
                topo, transport.deliver_mask(step, np.asarray(topo.nbr)))
        return SD._combine_topo(window, topo, out, alive, qb, shard)
    return combine


@COMBINERS.register("pod", params={"pods": ("pods", int),
                                   "pod_axis": ("pod_axis", str)})
def make_pod_combiner(*, spec, schedule, estimator, dense_R=None,
                      transport=None, mesh=None):
    """``combine(window, rel, step, alive=None, out=None) -> ḡ`` through
    the two-level pod dispatch of a static hierarchical topology, on
    one device or on ``mesh`` (the rank's rows in and out)."""
    del dense_R
    if transport is not None:
        raise ValueError(
            "the 'pod' combiner lowers a static two-level collective "
            "and cannot drop per-round faulty edges — use the 'flat' "
            "combiner with transport faults, or zero the transport_* "
            "rates for pod dispatch")
    from repro_torch.core import sharded_ddal as SD
    from repro_torch.core.pod_dispatch import make_pod_dispatch
    from repro_torch.core.topology import hierarchical_layout
    if schedule is None or schedule.resamples:
        raise ValueError(
            "the 'pod' combiner needs a static hierarchical topology "
            f"(got schedule "
            f"{type(schedule).__name__ if schedule else None}) — "
            "resampling schedules cannot be pod-dispatched: a swapped "
            "edge could cross pods without touching a leader")
    topology = schedule.base
    layout = hierarchical_layout(spec.n_agents, spec.degree)
    dispatch = make_pod_dispatch(topology, layout, mesh=mesh,
                                 pod_axis=spec.pod_axis)
    qb = spec.knowledge_quant_block
    if estimator.learns:
        def combine(window, rel, step, alive=None, out=None):
            del step
            topo = edge_effective(topology, rel, *SD.topo_tables(
                topology, rel.device))
            return dispatch(window, topo.relevance, alive=alive, out=out,
                            q_block=qb)
        return combine

    def combine(window, rel, step, alive=None, out=None):
        del rel, step
        return dispatch(window, alive=alive, out=out, q_block=qb)
    return combine
