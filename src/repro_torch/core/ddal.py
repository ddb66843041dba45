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
a learning estimator (``relevance_mode="grad_cos"``) the (n, n)
relevance state lives on the device and rides on every sent piece's R.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import PlaneLayout, tree_select
from repro_torch.core import knowledge as K
from repro_torch.core.exchange import ExchangeProtocol, build_exchange
from repro_torch.core.weighting import training_experience


class GroupState(NamedTuple):
    agent_states: Any            # leading (n,) agent axis
    stores: K.KnowledgeStore     # (n, m, P) planes
    flight: K.SparseInFlight     # (n, k, D+2, P) planes
    epoch: int                   # host epoch counter
    relevance: torch.Tensor      # (n, n) estimator state (uniform: ones)
    nbr: np.ndarray              # (n, k) gossip table (static)


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
                spec, topology=topology, relevance=relevance,
                delay=delay, use_wavg_kernel=use_wavg_kernel)
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
        return GroupState(
            agent_states=agent_states,
            stores=K.make_store(n, self.spec.m_pieces, p, params.device,
                                blocks),
            flight=K.make_sparse_inflight(n, k, self.max_delay, p,
                                          params.device, blocks),
            epoch=0,
            relevance=self.exchange.init_relevance(params.device),
            nbr=self.exchange.init_table())

    def epoch_step(self, gs: GroupState, gen: torch.Generator
                   ) -> Tuple[GroupState, Any]:
        """One epoch for the whole group; ``gen`` drives the agents'
        episodes. The delay line of ``gs`` is updated in place."""
        spec = self.spec
        ex = self.exchange
        n = spec.n_agents
        epoch = gs.epoch
        grads, metrics, astates = self.gen_grads(gs.agent_states, gen)

        warmup = epoch < spec.threshold
        sharing = not warmup

        topo, nbr = ex.topology_at(epoch, gs.nbr, gs.relevance)
        # the estimator's round is the epoch (it seeds the sketch); on
        # warm-up epochs it holds the state without computing anything
        learned = ex.observe(gs.relevance, grads=grads, rnd=epoch,
                             enabled=sharing)
        topo = ex.apply_relevance(topo, learned)

        # lines 8–10: append + async exchange over the graph
        T = torch.full((n,), training_experience(epoch, spec.t_weighting),
                       dtype=torch.float32, device=grads.device)
        flight = K.sparse_send(gs.flight, topo, grads, T, epoch, sharing)
        flight, stores = K.sparse_deliver(flight, gs.stores, epoch,
                                          self.static_topology)

        # lines 5–6 / 11–14: warm-up updates with own grads every
        # epoch; sharing updates with the eq. 4 average every
        # ``minibatch`` epochs, only agents with ≥1 valid piece
        if warmup:
            astates = self.apply_grads(astates, grads)
        elif epoch % spec.minibatch == 0:
            gbar, wsum = ex.combine(stores, learned, epoch)
            updated = self.apply_grads(astates, gbar)
            astates = tree_select(wsum > 0, updated, astates)

        new_gs = GroupState(agent_states=astates, stores=stores,
                            flight=flight, epoch=epoch + 1,
                            relevance=learned, nbr=nbr)
        return new_gs, metrics

    def run(self, gs: GroupState, gen: torch.Generator, n_epochs: int
            ) -> Tuple[GroupState, Dict[str, torch.Tensor]]:
        """``n_epochs`` epochs; returns per-epoch metrics stacked as
        (n_epochs, n)."""
        # each epoch's metrics are copied into rows preallocated at the
        # first epoch: thousands of small tensors kept alive between the
        # epochs' large temporaries fragment the host heap on the CPU
        stacked: Dict[str, torch.Tensor] = {}
        for e in range(n_epochs):
            gs, metrics = self.epoch_step(gs, gen)
            if e == 0:
                stacked = {key: v.new_empty((n_epochs,) + v.shape)
                           for key, v in metrics.items()}
            for key, v in metrics.items():
                stacked[key][e] = v
        return gs, stacked
