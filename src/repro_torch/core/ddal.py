"""DDAL — Decentralised Distributed Asynchronous Learning (paper §5,
Algorithm 1) over a group of n agents — the port of
``repro.core.ddal``.

The agent is abstracted behind callbacks that act on the whole group
at once (every tensor has a leading agent axis):

    gen_grads(agent_states, gen)  -> (grads (n, P), metrics, states')
    apply_grads(agent_states, g)  -> agent_states'
    params_of(agent_states)       -> params (n, P)

Per epoch (Algorithm 1):
    epoch < threshold : independent learning — update with own grads.
    epoch ≥ threshold : send every piece (with T, R metadata) through
        the delay lines into the stores; every ``minibatch`` epochs
        update with the eq. 4 weighted average of each store.

The epoch is a host integer here, so the reference's ``lax.switch``
over hold / independent / group update is a Python branch; the
per-agent "store has a valid piece" select stays on the device.

With ``knowledge_quant_block > 0`` the stores and the delay line hold
int8 planes; their blocks follow the leaves of the agents' parameter
tree (``layout``), as the reference blocks each leaf on its own. With
a learning estimator (``relevance_mode="grad_cos"``, ``obs_stats``) the
relevance state lives on the device and rides on every sent piece's R.
A resampling schedule (``dynamic``, ``relevance_topk``) refreshes the
carried gossip table ``nbr``, a host array, at round boundaries.

**Elastic membership** (``spec.elastic``): ``GroupState.alive`` is a
host (n,) bool, changed only between epochs by ``kill`` and ``revive``
(from a ``repro_torch.core.chaos`` plan, say). A dead agent sends and
receives nothing, and its row is frozen: whatever the epoch did to it
is discarded. **Faulty transport and staleness**: with a faulty
transport or ``max_staleness`` an agent whose store weighs nothing on
an update epoch takes its own gradients (the local fallback),
selected per agent on the device with no read back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import PlaneLayout, tree_select
from repro_torch.core import knowledge as K
from repro_torch.core import transport as TP
from repro_torch.core.exchange import ExchangeProtocol, build_exchange
from repro_torch.core.weighting import training_experience


class GroupState(NamedTuple):
    agent_states: Any            # leading (n,) agent axis
    stores: K.KnowledgeStore     # (n, m, P) planes
    flight: K.SparseInFlight     # (n, k, D+2, P) planes
    epoch: int                   # host epoch counter
    relevance: Any               # estimator state: (n, n) R, or the
                                 # obs_stats moments
    nbr: np.ndarray              # (n, k) current gossip table (host)
    alive: Optional[np.ndarray] = None   # (n,) host bool (elastic)


class DDAL:
    """Group-agent learning loop. Construct once, then call
    ``epoch_step`` in your own loop or ``run`` for N epochs. Runs on
    the CUDA card unless ``device="cpu"``. ``layout`` is the agents'
    parameter leaf table over a flat row; int8 stores
    (``knowledge_quant_block > 0``) need it, to block each leaf on its
    own."""

    def __init__(self, spec, gen_grads: Callable, apply_grads: Callable,
                 params_of: Callable, *, relevance=None, delay=None,
                 topology=None, use_wavg_kernel: bool = False,
                 exchange: ExchangeProtocol = None, device=None,
                 layout: PlaneLayout = None):
        self.device = resolve_device(device)
        self.spec = spec
        self.layout = layout
        self.quant_block = spec.knowledge_quant_block
        self.gen_grads = gen_grads
        self.apply_grads = apply_grads
        self.params_of = params_of
        if exchange is None:
            exchange = build_exchange(
                spec, kind="buffer", topology=topology, relevance=relevance,
                delay=delay, use_wavg_kernel=use_wavg_kernel)
        elif exchange.kind != "buffer":
            raise ValueError(
                f"DDAL needs a 'buffer' exchange protocol, got "
                f"{exchange.kind!r}")
        else:
            stale = [name for name, v in
                     [("topology", topology), ("relevance", relevance),
                      ("delay", delay),
                      ("use_wavg_kernel", use_wavg_kernel or None)]
                     if v is not None]
            if stale:
                raise ValueError(
                    f"{', '.join(stale)} would be silently ignored: "
                    f"these are baked into the protocol at build time "
                    f"— pass them to build_exchange(...) instead of "
                    f"to DDAL when supplying a prebuilt exchange")
        self.exchange = exchange
        self.static_topology = exchange.static_topology
        self.max_delay = exchange.max_delay
        self.elastic = bool(spec.elastic)
        self.transport = exchange.transport
        self.track_born = exchange.track_born
        # a faulty transport or a staleness cutoff can starve an agent of
        # knowledge on an update epoch: it then takes its own gradients
        self.local_fallback = (self.transport is not None
                               or spec.max_staleness is not None)
        self._alive_dev = (None, None)

    def init(self, agent_states) -> GroupState:
        """Empty stores and delay lines beside ``agent_states``."""
        n = self.spec.n_agents
        params = self.params_of(agent_states)
        if params.shape[0] != n or params.device.type != self.device.type:
            raise ValueError(
                f"agent states hold {tuple(params.shape)} params on "
                f"{params.device}; the group has {n} agents on "
                f"{self.device}")
        p = params.shape[1]
        k = self.static_topology.degree
        blocks = None
        if self.quant_block:
            if self.layout is None or self.layout.size != p:
                raise ValueError(
                    f"int8 knowledge planes block each parameter leaf on "
                    f"its own, as the reference does: DDAL needs the "
                    f"agents' layout (layout=...) of their {p}-element "
                    f"rows, got "
                    f"{None if self.layout is None else self.layout.size}")
            blocks = self.layout.blocks(self.quant_block)
        leaves = (None if self.transport is None else
                  TP.LeafTable.of(p, self.layout, blocks))
        return GroupState(
            agent_states=agent_states,
            stores=K.make_store(n, self.spec.m_pieces, p, params.device,
                                blocks, self.track_born),
            flight=K.make_sparse_inflight(n, k, self.max_delay, p,
                                          params.device, blocks, leaves,
                                          self.track_born),
            epoch=0,
            relevance=self.exchange.init_relevance(params.device),
            nbr=self.exchange.init_table(),
            alive=np.ones((n,), bool) if self.elastic else None)

    def _alive_on(self, alive: np.ndarray, device) -> torch.Tensor:
        """The device copy of the host ``alive`` mask, uploaded only when
        membership changed."""
        key, dev = self._alive_dev
        if key is None or not np.array_equal(key, alive) or \
                dev.device != torch.device(device):
            dev = torch.as_tensor(np.asarray(alive, bool), device=device)
            self._alive_dev = (np.array(alive, bool), dev)
        return dev

    def epoch_step(self, gs: GroupState, gen: torch.Generator
                   ) -> Tuple[GroupState, Any]:
        """One epoch for the whole group; ``gen`` drives the agents'
        episodes. The delay line of ``gs`` is updated in place."""
        spec = self.spec
        ex = self.exchange
        n = spec.n_agents
        epoch = gs.epoch
        alive = gs.alive if self.elastic else None
        if self.elastic and alive is None:
            raise ValueError(
                "spec.elastic=True but GroupState.alive is None — the "
                "state was built by a non-elastic init(); rebuild it "
                "with this trainer's init()")
        grads, metrics, astates = self.gen_grads(gs.agent_states, gen)
        alive_dev = (None if alive is None
                     else self._alive_on(alive, grads.device))

        warmup = epoch < spec.threshold
        sharing = not warmup

        topo, nbr = ex.topology_at(epoch, gs.nbr, gs.relevance, alive)
        aux = (metrics.get("obs_moments")
               if ex.wants_obs and isinstance(metrics, dict) else None)
        # the estimator's round is the epoch (it seeds the sketch); on
        # warm-up epochs it holds the state without computing anything
        learned = ex.observe(gs.relevance, grads=grads, aux=aux, rnd=epoch,
                             enabled=sharing, alive=alive_dev)
        topo = ex.apply_relevance(topo, learned)

        # lines 8–10: append + async exchange over the graph
        T = torch.full((n,), training_experience(epoch, spec.t_weighting),
                       dtype=torch.float32, device=grads.device)
        faults = None if self.transport is None else self.transport.at(
            epoch)
        flight = K.sparse_send(gs.flight, topo, grads, T, epoch, sharing,
                               alive, faults, ex.schedule.resamples)
        flight, stores = K.sparse_deliver(flight, gs.stores, epoch,
                                          self.static_topology, alive_dev)

        # lines 5–6 / 11–14: warm-up updates with own grads every
        # epoch; sharing updates with the eq. 4 average every
        # ``minibatch`` epochs, only agents with ≥1 valid piece (or,
        # with the local fallback, their own gradients otherwise)
        if warmup:
            astates = self.apply_grads(astates, grads)
        elif epoch % spec.minibatch == 0:
            gbar, wsum = ex.combine(stores, learned, epoch)
            updated = self.apply_grads(astates, gbar)
            empty = (self.apply_grads(astates, grads)
                     if self.local_fallback else astates)
            astates = tree_select(wsum > 0, updated, empty)
        if alive_dev is not None and not alive.all():
            # a dead agent is frozen: its pre-epoch state is restored
            # (with every agent alive the select would keep every row)
            astates = tree_select(alive_dev, astates, gs.agent_states)

        new_gs = GroupState(agent_states=astates, stores=stores,
                            flight=flight, epoch=epoch + 1,
                            relevance=learned, nbr=nbr, alive=gs.alive)
        return new_gs, metrics

    # -----------------------------------------------------------------
    # elastic membership — host-side events between epochs
    # -----------------------------------------------------------------
    def kill(self, gs: GroupState, dead) -> GroupState:
        """Mark agents dead (``dead``: (n,) bool, True = kill now). The
        exchange is scrubbed of them: every delay-line plane to a dead
        destination or from a dead source (the source of edge (i, j) is
        ``nbr[i, j]`` of the current gossip table) loses its valid bit,
        and the victims' stores are emptied, so a later revival replays
        nothing stale."""
        if gs.alive is None:
            raise ValueError("kill() needs an elastic GroupState "
                             "(spec.elastic=True)")
        dead = np.asarray(dead, bool)
        alive = gs.alive & ~dead
        drop = dead[np.asarray(gs.nbr)] | dead[:, None]         # (n, k)
        dev = gs.flight.valid.device
        valid = gs.flight.valid.clone()
        valid[torch.as_tensor(drop, device=dev)] = False
        flight = gs.flight._replace(valid=valid)
        d = torch.as_tensor(dead, device=dev)

        def clear(x):
            if x is None:
                return None
            m = d.reshape((-1,) + (1,) * (x.ndim - 1))
            return torch.where(m, torch.zeros((), dtype=x.dtype,
                                              device=dev), x)

        st = gs.stores
        stores = st._replace(
            grads=clear(st.grads), T=clear(st.T), R=clear(st.R),
            valid=clear(st.valid), ptr=clear(st.ptr),
            scale=clear(st.scale), born=clear(st.born))
        return gs._replace(stores=stores, flight=flight, alive=alive)

    def revive(self, gs: GroupState, mask,
               restore: Optional[GroupState] = None) -> GroupState:
        """Bring agents back (``mask``: (n,) bool, True = revive). They
        resume from their frozen pre-death rows, or, with ``restore``
        (a checkpointed ``GroupState``), from that state's agent rows
        and stores. Their delay-line rows stay cleared: fresh planes
        start flowing at the next sharing epoch."""
        if gs.alive is None:
            raise ValueError("revive() needs an elastic GroupState "
                             "(spec.elastic=True)")
        m = np.asarray(mask, bool)
        out = gs._replace(alive=gs.alive | m)
        if restore is not None:
            md = torch.as_tensor(m, device=gs.stores.T.device)
            out = out._replace(
                agent_states=tree_select(md, restore.agent_states,
                                         gs.agent_states),
                stores=K.select_rows(md, restore.stores, gs.stores))
        return out

    def run(self, gs: GroupState, gen: torch.Generator, n_epochs: int
            ) -> Tuple[GroupState, Dict[str, torch.Tensor]]:
        """``n_epochs`` epochs; returns per-epoch metrics stacked as
        (n_epochs, n)."""
        # each epoch's metrics are copied into rows preallocated at the
        # first epoch: thousands of small tensors kept alive between the
        # epochs' large temporaries fragment the host heap on the CPU
        stacked: Dict[str, Any] = {}
        for e in range(n_epochs):
            gs, metrics = self.epoch_step(gs, gen)
            if e == 0:
                stacked = {key: tuple(x.new_empty((n_epochs,) + x.shape)
                                      for x in v)
                           if isinstance(v, tuple) else
                           v.new_empty((n_epochs,) + v.shape)
                           for key, v in metrics.items()}
            for key, v in metrics.items():
                if isinstance(v, tuple):       # obs_moments
                    for buf, x in zip(stacked[key], v):
                        buf[e] = x
                else:
                    stacked[key][e] = v
        return gs, stacked
