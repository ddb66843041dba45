"""Assemble an :class:`ExchangeProtocol` from a ``GroupSpec`` — the
port of ``repro.core.exchange.build`` for the buffer trainer.

Each strategy family is resolved against the port's registries exactly
as the reference resolves ``"auto"`` for the buffer trainer: the
``static`` schedule over the spec's topology, or ``dynamic`` when
``resample_every > 0`` (``relevance_topk`` when asked for); the
estimator that ``relevance_mode`` / ``relevance_sketch_dim`` name
(``uniform``, ``grad_cos`` or ``grad_cos+sketch``), or ``obs_stats``;
the spec's delay model (``none`` by default); the ``store`` combiner;
and the transport, ``faulty`` when any fault rate is nonzero. The
faulty transport's knob-derived headroom deepens the delay line, and
``max_staleness`` or a decaying transport makes the stores and the
line carry each piece's send epoch. ``GroupSpec`` has already refused
every key the port lacks.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# importing the strategy modules registers them
from repro_torch.core.exchange import combiners, delays, estimators  # noqa: F401
from repro_torch.core.exchange.registry import (
    COMBINERS,
    DELAYS,
    ESTIMATORS,
    SCHEDULES,
)
from repro_torch.core.exchange.combiners import edge_effective
from repro_torch.core.exchange.schedules import (DynamicSchedule,
                                                 RelevanceTopKSchedule,
                                                 StaticSchedule)
from repro_torch.core.topology import (DynamicTopology, Topology,
                                       make_topology)


class ExchangeProtocol:
    """The four strategies plus the spec facts the trainer needs,
    behind the reference's calls: ``topology_at`` → ``observe`` →
    ``apply_relevance`` → (delay lines) → ``combine``."""

    def __init__(self, *, spec, schedule, estimator, combiner,
                 transport=None):
        self.spec = spec
        self.schedule = schedule
        self.estimator = estimator
        self.combiner = combiner
        self.transport = transport
        self.static_topology = schedule.base
        self.max_delay = max(schedule.max_delay, spec.max_delay)
        if transport is not None:
            # jitter, retransmit backoff and the duplicate's +1 land
            # deeper in the line; knob-derived, not plan-realised
            self.max_delay += transport.extra_delay
        ms = spec.max_staleness
        #: stores and delay lines carry each piece's send epoch
        self.track_born = (ms is not None or (
            transport is not None and spec.transport_decay < 1.0))
        self._edge_tables: dict = {}

    @property
    def wants_obs(self) -> bool:
        return self.estimator.wants_obs

    def init_table(self) -> np.ndarray:
        return self.schedule.init_table()

    def init_relevance(self, device=None):
        return self.estimator.init(self.spec.n_agents, device)

    def topology_at(self, step: int, nbr, rel_state=None, alive=None):
        """(graph in force at ``step``, refreshed carried table).
        ``alive`` (host (n,) bool) keeps dead agents out of resampled
        draws."""
        rel = None
        if self.schedule.uses_relevance:
            rel = self.estimator.matrix(rel_state)
        nbr = self.schedule.refresh(step, nbr, rel, alive)
        return self.schedule.materialize(step, nbr, rel), nbr

    def observe(self, rel_state, *, grads, aux=None, rnd=0, enabled=True,
                alive=None):
        """One estimator update (the identity for ``uniform``);
        ``alive`` (device (n,) bool) freezes entries touching a dead
        agent."""
        return self.estimator.observe(rel_state, grads=grads, aux=aux,
                                      rnd=rnd, enabled=enabled,
                                      alive=alive)

    def edge_tables(self, topo: Topology, device):
        """(nbr, mask, prior relevance) of ``topo`` on ``device``,
        uploaded once per distinct table (a resampled table is new once
        a round): the learned R is gathered onto the edges on the card
        every epoch without a host round trip."""
        key = (str(torch.device(device)), np.asarray(topo.nbr).tobytes(),
               np.asarray(topo.mask).tobytes(),
               np.asarray(topo.relevance).tobytes())
        if key not in self._edge_tables:
            if len(self._edge_tables) > 4:
                self._edge_tables.clear()
            self._edge_tables[key] = (
                torch.as_tensor(np.asarray(topo.nbr), dtype=torch.int64,
                                device=device),
                torch.as_tensor(np.asarray(topo.mask), device=device),
                torch.as_tensor(np.asarray(topo.relevance), device=device))
        return self._edge_tables[key]

    def apply_relevance(self, topo: Topology, rel_state) -> Topology:
        """Effective per-edge R = static prior × learned estimate, as a
        device tensor on ``topo``'s edge table; ``topo`` untouched when
        nothing is learned (the uniform fixed point)."""
        if not self.estimator.learns:
            return topo
        rel = self.estimator.matrix(rel_state)
        return edge_effective(topo, rel, *self.edge_tables(topo,
                                                           rel.device))

    def combine(self, stores, rel_state, step):
        # the store combiner, the port's only one, reads relevance from
        # each piece's R (set at delivery), never an (n, n) matrix
        del rel_state
        return self.combiner(stores, None, step)


def _schedule_key(spec) -> str:
    key = spec.exchange_schedule
    if key != "auto":
        return key
    return "dynamic" if spec.resample_every > 0 else "static"


def _estimator_key(spec) -> str:
    key = spec.exchange_estimator
    if key != "auto":
        return key
    if spec.relevance_mode == "uniform":
        return "uniform"
    return ("grad_cos+sketch" if spec.relevance_sketch_dim > 0
            else "grad_cos")


def _make_estimator(spec, obs_dim):
    return ESTIMATORS.get(_estimator_key(spec)).from_spec(spec, obs_dim)


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


def _make_schedule(spec, key: str, topology, relevance, delay,
                   delay_model):
    """The schedule, with explicit ``relevance`` / ``delay`` overrides
    and the delay model attached where the reference attaches them (the
    edge table of a static graph, the dense carries of a resampling
    one)."""
    if topology is not None:
        if isinstance(topology, DynamicTopology):
            if key == "relevance_topk":
                sched = RelevanceTopKSchedule(
                    topology.base,
                    topology.resample_every or spec.resample_every,
                    topology.seed, spec.explore_eps,
                    dense_delay=topology.dense_delay,
                    dense_relevance=topology.dense_relevance)
                sched.with_dense(delay=delay, relevance=relevance)
                return sched.with_dense(delay=delay_model.dense_scalar())
            if (spec.exchange_schedule == "static"
                    and topology.resample_every > 0):
                raise ValueError(
                    "exchange_schedule='static' pins a fixed graph "
                    "but the explicit DynamicTopology resamples every "
                    f"{topology.resample_every} epochs — pass its "
                    ".base (a static Topology) or drop the override")
            topology = topology.with_dense(delay=delay,
                                           relevance=relevance)
            scalar = delay_model.dense_scalar()
            if scalar is not None:
                topology = topology.with_dense(delay=scalar)
            if topology.dense_delay is None:
                topology._uniform_base_delay()  # validate early
            return DynamicSchedule(topology)
        if key == "relevance_topk":
            sched = RelevanceTopKSchedule(topology, spec.resample_every,
                                          spec.topology_seed,
                                          spec.explore_eps)
            sched.with_dense(delay=delay, relevance=relevance)
            return sched.with_dense(delay=delay_model.dense_scalar())
        if key == "dynamic":
            raise ValueError(
                "schedule 'dynamic' was requested with an explicit "
                "static Topology — pass a DynamicTopology (it carries "
                "the resample cadence and dense annotations) or drop "
                "the explicit topology to build one from the spec")
        if relevance is not None:
            topology = topology.with_relevance(relevance)
        if delay is not None:
            topology = topology.with_delay(delay)
        return StaticSchedule(delay_model.attach(topology))

    built = make_topology(spec, delay=delay, relevance=relevance)
    if key == "relevance_topk":
        if isinstance(built, DynamicTopology):
            base, dd, dr = (built.base, built.dense_delay,
                            built.dense_relevance)
        else:
            base, dd, dr = built, None, None
        sched = RelevanceTopKSchedule(base, spec.resample_every,
                                      spec.topology_seed, spec.explore_eps,
                                      dense_delay=dd, dense_relevance=dr)
        return sched.with_dense(delay=delay_model.dense_scalar())
    if isinstance(built, DynamicTopology):
        scalar = delay_model.dense_scalar()
        if scalar is not None:
            built = built.with_dense(delay=scalar)
        return SCHEDULES.get("dynamic")(built)
    if key == "dynamic":
        raise ValueError(
            "schedule 'dynamic' needs resample_every >= 1 (and "
            "topology='random_k'); use 'static' for a fixed graph")
    return SCHEDULES.get("static")(delay_model.attach(built))


def build_exchange(spec, *, topology=None, relevance=None, delay=None,
                   obs_dim: Optional[int] = None,
                   use_wavg_kernel: bool = False) -> ExchangeProtocol:
    """Build the buffer trainer's exchange protocol for ``spec``.
    ``topology`` (a ``Topology`` or ``DynamicTopology``) overrides the
    graph the spec names; ``relevance`` / ``delay`` are dense (n, n)
    src→dst or per-edge (n, k) overrides; ``obs_dim`` is needed by the
    ``obs_stats`` estimator only."""
    from repro_torch.core.transport import make_transport
    delay_model = _make_delay_model(spec, delay)
    estimator = _make_estimator(spec, obs_dim)
    schedule = _make_schedule(spec, _schedule_key(spec), topology,
                              relevance, delay, delay_model)
    transport = make_transport(spec, tuple(schedule.base.nbr.shape))
    return ExchangeProtocol(
        spec=spec, schedule=schedule, estimator=estimator,
        combiner=COMBINERS.get("store")(spec=spec, transport=transport,
                                        use_wavg_kernel=use_wavg_kernel),
        transport=transport)
