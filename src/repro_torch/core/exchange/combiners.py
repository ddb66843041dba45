"""Combiners — *how gathered knowledge becomes one update*. The port
has the buffer trainer's ``store`` combiner of
``repro.core.exchange.combiners``: the eq. 4 weighted average over
every agent's knowledge store, and the shared per-edge relevance tail
``edge_effective``.

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
"""
from __future__ import annotations

import torch

from repro_torch.core import knowledge as K
from repro_torch.core import relevance as REL
from repro_torch.core.exchange.registry import COMBINERS
from repro_torch.core.topology import Topology
from repro_torch.core.weighting import combine_relevance


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


@COMBINERS.register("store")
def make_store_combiner(*, spec, transport=None,
                        use_wavg_kernel: bool = False):
    """``combine(stores, rel, step) -> (ḡ (n, P), Σw (n,))``. Relevance
    already rode in on each piece's R at delivery, so ``rel`` is unused.
    ``use_wavg_kernel=True`` keeps the legacy path: weights computed
    outside, then the plain contraction kernel. Int8 stores
    (``knowledge_quant_block > 0``) always take the int8 fused step.
    With ``spec.max_staleness`` or a ``transport`` and
    ``spec.transport_decay < 1`` the stores pass the age gate first."""
    ms = spec.max_staleness
    decay = spec.transport_decay if transport is not None else 1.0
    stale_gate = ms is not None or decay < 1.0

    def combine(stores, rel, step):
        del rel
        if stale_gate:
            stores = age_gate(stores, step, ms, decay)
        return K.weighted_average(stores, use_kernel=use_wavg_kernel)

    return combine
