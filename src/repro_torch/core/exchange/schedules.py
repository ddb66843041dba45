"""Topology schedules — *which graph is in force at step t*. The port
has the ``static`` schedule of ``repro.core.exchange.schedules``; the
resampling ones wait for a later slice."""
from __future__ import annotations

import numpy as np

from repro_torch.core.exchange.registry import SCHEDULES
from repro_torch.core.topology import Topology


@SCHEDULES.register("static")
class StaticSchedule:
    """The graph named by ``GroupSpec.topology``, fixed for the run."""

    def __init__(self, topo: Topology):
        self.base = topo

    @property
    def max_delay(self) -> int:
        return self.base.max_delay

    def init_table(self) -> np.ndarray:
        return self.base.nbr

    def refresh(self, step, nbr, rel):
        del step, rel
        return nbr

    def materialize(self, step, nbr, rel) -> Topology:
        del step, nbr, rel
        return self.base
