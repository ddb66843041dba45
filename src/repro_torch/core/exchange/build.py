"""Assemble an :class:`ExchangeProtocol` from a ``GroupSpec`` — the
port of ``repro.core.exchange.build`` for both trainers.

``kind`` names the trainer: ``"buffer"`` (``repro_torch.core.ddal``,
knowledge stores) or ``"streaming"`` (``repro_torch.core.sharded_ddal``,
window accumulators); it defaults to ``spec.knowledge_mode``. Each
strategy family is resolved against the port's registries exactly as
the reference resolves ``"auto"``: the ``static`` schedule over the
spec's topology, or ``dynamic`` when ``resample_every > 0``
(``relevance_topk`` when asked for); the estimator that
``relevance_mode`` / ``relevance_sketch_dim`` name (``uniform``,
``grad_cos`` or ``grad_cos+sketch``), or ``obs_stats``; the spec's
delay model (``none`` by default); the ``store`` combiner for the
buffer trainer and, for the streaming one, ``pod`` when ``pods > 0``
(the reference's ``build.py:214-220``) else ``flat``; and the transport,
``faulty`` when any fault rate is nonzero. The faulty transport's
knob-derived headroom deepens the delay line, and ``max_staleness`` or
a decaying transport makes the stores and the line carry each piece's
send epoch.

The streaming trainer takes the reference's checks (its
``build.py:376-422``): no ``store`` combiner, no delay model, no
``obs_stats`` estimator, no ``max_staleness``, no transport jitter or
retransmit; and ``full`` with nothing time-varying and no faulty
transport builds no graph object at all (the global-sum fast path, an
explicit ``relevance`` then weighting the dense eq. 4). ``GroupSpec``
has already refused every key the port lacks.

``mesh`` (a two-level ``(pod_axis, "agent")`` ``DeviceMesh``) places the
streaming trainer's agents over the ranks: the protocol then carries
the calling rank's ``AgentShard`` (``shard``), gathers the estimator's
inputs over the world in ``observe``, and its combiner returns the
rank's rows of ḡ. A ``(data, model)`` mesh places no agents (every rank
holds the group's slices of each leaf): the protocol is the one-device
one, and ``sketch_step`` / ``observe`` take the rank's ``ModelShards``
(``shards=``) to sum their partial sketches and cosines over the model
axis. A ``(pod_axis, "data", "model")`` mesh does both: the shard is
the pod's block, gathered over ``pod_axis`` only, and ``observe`` takes
the gather and the ``shards`` together (the sketch summed over
``model`` in ``sketch_step``, then its rows gathered; exact
``grad_cos``'s chunks gathered, then its sums taken over ``model``).
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
    """The four strategies plus the spec facts the trainers need, behind
    the reference's calls. The buffer trainer drives ``topology_at`` →
    ``observe`` → ``apply_relevance`` → (delay lines) → ``combine``; the
    streaming trainer ``sketch_step`` (accumulation) → ``observe`` →
    ``combine`` at share steps."""

    def __init__(self, *, spec, schedule, estimator, combiner,
                 transport=None, kind: str = "buffer", shard=None):
        self.spec = spec
        self.kind = kind
        #: the calling rank's block of agents on a mesh (None: one device)
        self.shard = shard
        self.schedule = schedule
        self.estimator = estimator
        self.combiner = combiner
        self.transport = transport
        self.static_topology = (schedule.base if schedule is not None
                                else None)
        sched_delay = schedule.max_delay if schedule is not None else 0
        self.max_delay = max(sched_delay, spec.max_delay)
        if transport is not None:
            # jitter, retransmit backoff and the duplicate's +1 land
            # deeper in the line; knob-derived, not plan-realised
            self.max_delay += transport.extra_delay
        ms = spec.max_staleness
        #: stores and delay lines carry each piece's send epoch
        self.track_born = kind == "buffer" and (ms is not None or (
            transport is not None and spec.transport_decay < 1.0))
        self._edge_tables: dict = {}

    @property
    def wants_obs(self) -> bool:
        return self.estimator.wants_obs

    @property
    def sketch_dim(self) -> int:
        return self.estimator.sketch_dim

    def streaming_rel_init(self, device=None):
        """``Knowledge.rel``'s seed: ``None`` when nothing is learned."""
        if not self.estimator.learns:
            return None
        return self.estimator.init(self.spec.n_agents, device)

    def sketch_step(self, grads, rnd: int, shards=None):
        """This step's (n, d) window-sketch contribution (sketched
        estimators; ``None`` otherwise). ``shards`` (a ``ModelShards``:
        ``grads`` are the rank's slices) sums the ranks' partial sketches
        over the model axis."""
        out = self.estimator.sketch_step(grads, rnd, shards=shards)
        if out is not None and shards is not None:
            shards.all_reduce(out)
        return out

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

    def observe(self, rel_state, *, grads=None, sketch=None, aux=None,
                rnd=0, enabled=True, alive=None, shards=None):
        """One estimator update (the identity for ``uniform``);
        ``sketch`` is the streaming window's carried (n, d) sketch;
        ``alive`` (device (n,) bool) freezes entries touching a dead
        agent. On a mesh ``grads`` and ``sketch`` hold the rank's rows:
        the sketch is gathered over the world here, and exact
        ``grad_cos`` gathers the window a column chunk at a time, so
        every rank gets the group's relevance. ``shards`` (a
        ``ModelShards``: ``grads`` are the rank's slices of each leaf)
        makes exact ``grad_cos`` sum its partial dot products and norms
        over the model axis (a sketch is already the whole one); on a
        ``(pod, data, model)`` mesh both apply."""
        kw = {}
        if self.shard is not None and enabled and self.estimator.learns:
            if sketch is not None:
                sketch = self.shard.gather(sketch)
            else:
                kw["gather"] = self.shard.gather
        if shards is not None and sketch is None and self.estimator.learns:
            kw["shards"] = shards
        return self.estimator.observe(rel_state, grads=grads,
                                      sketch=sketch, aux=aux, rnd=rnd,
                                      enabled=enabled, alive=alive, **kw)

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

    def combine(self, knowledge, rel_state, step, alive=None, out=None):
        """The eq. 4 aggregation of the chosen combiner, given the
        estimator's dense (n, n) R (``None`` when nothing is learned).
        The streaming ``flat`` combiner also takes ``alive`` and an
        ``out`` tree for ḡ; the buffer trainer's ``store`` combiner
        reads relevance from each piece's R (set at delivery). On a mesh
        ``knowledge`` and the result are the rank's rows, ``alive`` the
        group's mask."""
        rel = None
        if self.estimator.learns and rel_state is not None:
            rel = self.estimator.matrix(rel_state)
        return self.combiner(knowledge, rel, step, alive, out)


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


KINDS = ("buffer", "streaming")


def _combiner_key(spec, kind: str) -> str:
    key = spec.exchange_combiner
    if key != "auto":
        return key
    if kind == "buffer":
        return "store"
    return "pod" if spec.pods > 0 else "flat"


def _check_streaming(spec, estimator, faulty: bool) -> None:
    """The reference's refusals of streaming specs (``build.py:380-422``)."""
    if _delay_key(spec) != "none":
        raise ValueError(
            f"delay model {_delay_key(spec)!r} has no effect on the "
            f"streaming trainer (window accumulators exchange at "
            f"share steps; there is no delay line to stale) — drop "
            f"exchange_delay, or use the buffer trainer for "
            f"asynchrony simulation")
    if estimator.wants_obs:
        raise ValueError(
            f"estimator {_estimator_key(spec)!r} needs the trainers' "
            f"observation side channel (metrics['obs_moments']), "
            f"which the streaming train step does not carry — it "
            f"would silently hold the uniform prior forever; use the "
            f"buffer trainer for observation-statistics relevance")
    if spec.max_staleness is not None:
        raise ValueError(
            "max_staleness ages buffer-trainer arrival slots; the "
            "streaming trainer's window accumulators are rebuilt "
            "every share round and have no staleness to cut — "
            "drop max_staleness or use the buffer trainer")
    if faulty and (spec.transport_jitter > 0
                   or spec.transport_retransmit > 0):
        raise ValueError(
            "transport_jitter / transport_retransmit delay "
            "deliveries through the buffer trainer's delay line; "
            "the streaming trainer exchanges whole windows at "
            "share steps (no line to delay — a message is either "
            "in this round or gone), got jitter="
            f"{spec.transport_jitter}, retransmit="
            f"{spec.transport_retransmit}; zero them or use the "
            "buffer trainer")


def build_exchange(spec, *, kind: Optional[str] = None, topology=None,
                   relevance=None, delay=None,
                   obs_dim: Optional[int] = None,
                   use_wavg_kernel: bool = False,
                   mesh=None) -> ExchangeProtocol:
    """Build the exchange protocol of the ``kind`` trainer (default
    ``spec.knowledge_mode``) for ``spec``. ``topology`` (a ``Topology``
    or ``DynamicTopology``) overrides the graph the spec names;
    ``relevance`` / ``delay`` are dense (n, n) src→dst or per-edge
    (n, k) overrides; ``obs_dim`` is needed by the ``obs_stats``
    estimator only; ``mesh`` places the streaming trainer's agents on a
    ``(spec.pod_axis, "agent")`` or a ``(spec.pod_axis, "data",
    "model")`` device mesh."""
    from repro_torch.core.transport import make_transport, transport_enabled
    kind = kind or spec.knowledge_mode
    if kind not in KINDS:
        raise ValueError(
            f"unknown exchange kind {kind!r}; expected one of {KINDS}")
    sched_key = _schedule_key(spec)
    comb_key = _combiner_key(spec, kind)
    if kind == "buffer" and comb_key != "store":
        raise ValueError(
            f"the buffer trainer aggregates knowledge stores and "
            f"needs the 'store' combiner, got {comb_key!r}")
    if kind == "streaming" and comb_key == "store":
        raise ValueError(
            "the 'store' combiner aggregates ring-buffer pieces and "
            "only serves the buffer trainer; streaming wants 'flat' "
            "or 'pod'")
    delay_model = _make_delay_model(spec, delay)
    estimator = _make_estimator(spec, obs_dim)
    faulty = transport_enabled(spec)
    if kind == "streaming":
        _check_streaming(spec, estimator, faulty)
    if kind == "buffer":
        if mesh is not None:
            raise ValueError(
                "a device mesh places the streaming trainer's agents; "
                "the buffer trainer runs on one device")
        schedule = _make_schedule(spec, sched_key, topology, relevance,
                                  delay, delay_model)
        transport = make_transport(spec, tuple(schedule.base.nbr.shape))
        combiner = COMBINERS.get("store")(spec=spec, transport=transport,
                                          use_wavg_kernel=use_wavg_kernel)
        return ExchangeProtocol(spec=spec, schedule=schedule,
                                estimator=estimator, combiner=combiner,
                                transport=transport, kind=kind)
    # the global-sum fast path: no graph object when the spec names the
    # full topology with nothing time-varying (an explicit relevance
    # matrix then weights the dense eq. 4); a faulty transport drops
    # per-round edges, so it always needs the edge table
    dense_R = None
    if (topology is None and spec.topology == "full"
            and spec.resample_every == 0 and sched_key == "static"
            and not faulty):
        schedule = None
        dense_R = relevance
    else:
        schedule = _make_schedule(spec, sched_key, topology, relevance,
                                  delay, delay_model)
    transport = make_transport(
        spec, tuple(schedule.base.nbr.shape) if schedule is not None
        else (spec.n_agents, spec.n_agents))
    # the pod mesh and the (pod, data, model) mesh place agents: on a
    # (data, model) mesh every rank holds the group, and the combiner
    # runs its one-device form
    from repro_torch.core.sharded_ddal import agent_shard, mesh_kind
    if mesh_kind(mesh, spec.pod_axis) not in ("pod", "pod_model"):
        mesh = None
    combiner = COMBINERS.get(comb_key)(spec=spec, schedule=schedule,
                                       estimator=estimator, dense_R=dense_R,
                                       transport=transport, mesh=mesh)
    shard = None
    if mesh is not None:
        shard = agent_shard(mesh, spec.n_agents, spec.pod_axis)
    return ExchangeProtocol(spec=spec, schedule=schedule,
                            estimator=estimator, combiner=combiner,
                            transport=transport, kind=kind, shard=shard)
