"""Delay models — *how stale is knowledge on arrival* — the port of
``repro.core.exchange.delays``. Each attaches per-edge delivery delays
onto the static schedule's topology at build time.

``none``
    Same-epoch delivery (the paper's setup).
``uniform``
    Every edge delayed by ``GroupSpec.max_delay`` epochs.
``hops``
    Graph-distance staleness: an edge from a distance-d source
    delivers d·latency epochs late, latency = ``max(max_delay, 1)``.
    Static schedules only.

``dense_scalar`` is the uniform delay a resampling schedule carries
across table swaps (``None`` for ``none``); ``hops`` raises there.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.exchange.registry import DELAYS
from repro_torch.core.topology import Topology, delay_from_hops


@DELAYS.register("none")
class NoDelay:
    def attach(self, topo: Topology) -> Topology:
        return topo

    def dense_scalar(self) -> Optional[int]:
        return None


@DELAYS.register("uniform", params={"max_delay": ("max_delay", int)})
class UniformDelay:
    def __init__(self, delay: int):
        if delay < 0:
            raise ValueError(f"uniform delay must be >= 0, got {delay}")
        self.delay = int(delay)

    def attach(self, topo: Topology) -> Topology:
        return topo.with_delay(self.delay)

    def dense_scalar(self) -> int:
        return self.delay


@DELAYS.register("hops")
class HopDelay:
    def __init__(self, latency: int, graph: Optional[Topology] = None):
        self.latency = max(int(latency), 1)
        self.graph = graph

    def attach(self, topo: Topology) -> Topology:
        return delay_from_hops(topo, self.latency, graph=self.graph)

    def dense_scalar(self) -> Optional[int]:
        raise ValueError(
            "the 'hops' delay model measures distances on a fixed "
            "graph and cannot follow a resampling schedule — use "
            "delay='uniform' (or 'none') with dynamic/relevance_topk")
