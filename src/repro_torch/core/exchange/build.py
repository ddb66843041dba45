"""Assemble an :class:`ExchangeProtocol` from a ``GroupSpec`` — the
port of ``repro.core.exchange.build`` for the buffer trainer.

Each strategy family is resolved against the port's registries exactly
as the reference resolves ``"auto"`` for the buffer trainer: the
``static`` schedule over the spec's topology, the estimator that
``relevance_mode`` / ``relevance_sketch_dim`` name (``uniform``,
``grad_cos`` or ``grad_cos+sketch``), the spec's delay model (``none``
by default) and the ``store`` combiner. ``GroupSpec`` has already
refused every key the port lacks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

# importing the strategy modules registers them
from repro_torch.core.exchange import combiners, delays, estimators  # noqa: F401
from repro_torch.core.exchange.registry import (
    COMBINERS,
    DELAYS,
    ESTIMATORS,
    SCHEDULES,
    TRANSPORTS,
)
from repro_torch.core.exchange.combiners import edge_effective
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
        self._edge_tables: Dict[str, Tuple[torch.Tensor, ...]] = {}

    def init_table(self):
        return self.schedule.init_table()

    def init_relevance(self, device=None):
        return self.estimator.init(self.spec.n_agents, device)

    def topology_at(self, step, nbr, rel_state=None):
        """(graph in force at ``step``, refreshed carried table)."""
        nbr = self.schedule.refresh(step, nbr, None)
        return self.schedule.materialize(step, nbr, None), nbr

    def observe(self, rel_state, *, grads, rnd=0, enabled=True):
        """One estimator update (the identity for ``uniform``)."""
        return self.estimator.observe(rel_state, grads=grads, rnd=rnd,
                                      enabled=enabled)

    def edge_tables(self, device) -> Tuple[torch.Tensor, ...]:
        """(nbr, mask, prior relevance) of the static graph on
        ``device``, copied there once: the learned R is gathered onto
        the edges on the card every epoch without a host round trip."""
        key = str(torch.device(device))
        if key not in self._edge_tables:
            topo = self.static_topology
            self._edge_tables[key] = (
                torch.as_tensor(topo.nbr, dtype=torch.int64, device=device),
                torch.as_tensor(topo.mask, device=device),
                torch.as_tensor(topo.relevance, device=device))
        return self._edge_tables[key]

    def apply_relevance(self, topo: Topology, rel_state) -> Topology:
        """Effective per-edge R = static prior × learned estimate, as a
        device tensor on ``topo``'s edge table; ``topo`` untouched when
        nothing is learned (the uniform fixed point)."""
        if not self.estimator.learns:
            return topo
        rel = self.estimator.matrix(rel_state)
        return edge_effective(topo, rel, *self.edge_tables(rel.device))

    def combine(self, stores, rel_state, step):
        # the store combiner, the port's only one, reads relevance from
        # each piece's R (set at delivery), never an (n, n) matrix
        del rel_state
        return self.combiner(stores, None, step)


def _estimator_key(spec) -> str:
    key = spec.exchange_estimator
    if key != "auto":
        return key
    if spec.relevance_mode == "uniform":
        return "uniform"
    return ("grad_cos+sketch" if spec.relevance_sketch_dim > 0
            else "grad_cos")


def _make_estimator(spec):
    return ESTIMATORS.get(_estimator_key(spec)).from_spec(spec)


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
        estimator=_make_estimator(spec),
        combiner=COMBINERS.get("store")(use_wavg_kernel=use_wavg_kernel))
