"""Combiners — *how gathered knowledge becomes one update*. The port
has the buffer trainer's ``store`` combiner of
``repro.core.exchange.combiners``: the eq. 4 weighted average over
every agent's knowledge store, and the shared per-edge relevance tail
``edge_effective``.

The reference vmaps the share step over the n stores; the port hands
the whole (n, m, P) plane stack to one launch of the fused CUDA kernel
(``repro_torch.kernels.ddal_wavg``), int8 stores to its int8 twin.
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


@COMBINERS.register("store")
def make_store_combiner(*, use_wavg_kernel: bool = False):
    """``combine(stores, rel, step) -> (ḡ (n, P), Σw (n,))``. Relevance
    already rode in on each piece's R at delivery, so ``rel`` is unused.
    ``use_wavg_kernel=True`` keeps the legacy path: weights computed
    outside, then the plain contraction kernel. Int8 stores
    (``knowledge_quant_block > 0``) always take the int8 fused step."""

    def combine(stores, rel, step):
        del rel, step
        return K.weighted_average(stores, use_kernel=use_wavg_kernel)

    return combine
