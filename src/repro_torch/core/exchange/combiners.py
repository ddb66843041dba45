"""Combiners — *how gathered knowledge becomes one update*. The port
has the buffer trainer's ``store`` combiner of
``repro.core.exchange.combiners``: the eq. 4 weighted average over
every agent's knowledge store.

The reference vmaps the share step over the n stores; the port hands
the whole (n, m, P) plane stack to one launch of the fused CUDA kernel
(``repro_torch.kernels.ddal_wavg``).
"""
from __future__ import annotations

from repro_torch.core import knowledge as K
from repro_torch.core.exchange.registry import COMBINERS


@COMBINERS.register("store")
def make_store_combiner(*, use_wavg_kernel: bool = False):
    """``combine(stores, rel, step) -> (ḡ (n, P), Σw (n,))``. Relevance
    already rode in on each piece's R at delivery, so ``rel`` is unused.
    ``use_wavg_kernel=True`` keeps the legacy path: weights computed
    outside, then the plain contraction kernel."""

    def combine(stores, rel, step):
        del rel, step
        return K.weighted_average(stores, use_kernel=use_wavg_kernel)

    return combine
