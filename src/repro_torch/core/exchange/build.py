"""Assemble an :class:`ExchangeProtocol` from a ``GroupSpec`` — the
port of ``repro.core.exchange.build`` for the buffer trainer.

Each strategy family is resolved against the port's registries exactly
as the reference resolves ``"auto"`` for the buffer trainer: the
``static`` schedule over the spec's topology, the ``uniform``
estimator, the spec's delay model (``none`` by default) and the
``store`` combiner. ``GroupSpec`` has already refused every key the
port lacks.
"""
from __future__ import annotations

from typing import Optional

# importing the strategy modules registers them
from repro_torch.core.exchange import combiners, delays, estimators  # noqa: F401
from repro_torch.core.exchange.registry import (
    COMBINERS,
    DELAYS,
    ESTIMATORS,
    SCHEDULES,
    TRANSPORTS,
)
from repro_torch.core.exchange.schedules import StaticSchedule
from repro_torch.core.topology import Topology, make_topology

# perfect delivery: no fault model at all (the reference's "none")
TRANSPORTS.register("none")(lambda **kw: None)


class ExchangeProtocol:
    """The four strategies plus the spec facts the trainer needs,
    behind the reference's calls: ``topology_at`` → ``observe`` →
    ``apply_relevance`` → (delay lines) → ``combine``."""

    def __init__(self, *, spec, schedule: StaticSchedule, estimator,
                 combiner):
        self.spec = spec
        self.schedule = schedule
        self.estimator = estimator
        self.combiner = combiner
        self.static_topology = schedule.base
        self.max_delay = max(schedule.max_delay, spec.max_delay)

    def init_table(self):
        return self.schedule.init_table()

    def init_relevance(self, device=None):
        return self.estimator.init(self.spec.n_agents, device)

    def topology_at(self, step, nbr, rel_state=None):
        """(graph in force at ``step``, refreshed carried table)."""
        nbr = self.schedule.refresh(step, nbr, None)
        return self.schedule.materialize(step, nbr, None), nbr

    def observe(self, rel_state, **kw):
        return self.estimator.observe(rel_state, **kw)

    def apply_relevance(self, topo: Topology, rel_state) -> Topology:
        # the uniform estimator learns nothing: the static prior stands
        return topo

    def combine(self, stores, rel_state, step):
        return self.combiner(stores, None, step)


def _delay_key(spec) -> str:
    key = spec.exchange_delay
    return "none" if key == "auto" else key


def _make_delay_model(spec, delay):
    key = _delay_key(spec)
    if key != "none" and delay is not None:
        raise ValueError(
            f"explicit delay= arrays and the {key!r} delay model are "
            f"mutually exclusive — pick one delay source")
    if key == "uniform":
        return DELAYS.get("uniform")(spec.max_delay)
    if key == "hops":
        return DELAYS.get("hops")(max(spec.max_delay, 1))
    return DELAYS.get("none")()


def build_exchange(spec, *, topology: Optional[Topology] = None,
                   relevance=None, delay=None,
                   use_wavg_kernel: bool = False) -> ExchangeProtocol:
    """Build the buffer trainer's exchange protocol for ``spec``.
    ``topology`` overrides the graph the spec names; ``relevance`` /
    ``delay`` are dense (n, n) src→dst or per-edge (n, k) overrides."""
    delay_model = _make_delay_model(spec, delay)
    if topology is not None:
        if relevance is not None:
            topology = topology.with_relevance(relevance)
        if delay is not None:
            topology = topology.with_delay(delay)
    else:
        topology = make_topology(spec, delay=delay, relevance=relevance)
    return ExchangeProtocol(
        spec=spec,
        schedule=SCHEDULES.get("static")(delay_model.attach(topology)),
        estimator=ESTIMATORS.get("uniform")(),
        combiner=COMBINERS.get("store")(use_wavg_kernel=use_wavg_kernel))
