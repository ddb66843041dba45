"""Topology schedules — *which graph is in force at step t* — the port
of ``repro.core.exchange.schedules`` for the buffer trainer's
carried-table loop.

``static``
    The graph never changes: ``materialize`` returns the wrapped
    ``Topology`` object itself.
``dynamic``
    Uniform gossip resampling (:class:`~repro_torch.core.topology.
    DynamicTopology`): the ``random_k`` table is redrawn every
    ``resample_every`` epochs from the round's uniforms.
``relevance_topk``
    Gumbel top-k gossip over the learned relevance: every round each
    destination keeps the k−1 sources with the largest
    ``log R[src, dst] + Gumbel``, and with probability ε takes a fresh
    uniform gossip row instead.

The epoch is a host integer, so a refresh is a host ``if`` at round
boundaries and the table stays a host array. The round's three draws
of ``relevance_topk`` (the Gumbel uniforms in [1e-12, 1), the ε-coin
uniforms, the uniform fallback's uniforms) come from the hook
``topk_draws``, which a test replaces with the reference's recorded
``jax.random`` draws; its default is a CPU generator seeded by
``(seed, round)``. The learned R is read from the card once per round,
at the boundary. ``jax.lax.top_k`` breaks ties toward the lower index,
and ties are real here (the self and dead columns are all −inf when
fewer than k−1 live candidates remain), so the columns are picked by a
stable descending sort, which breaks them the same way.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.exchange.registry import SCHEDULES
from repro_torch.core.topology import (DynamicTopology, Topology, host_f32,
                                       round_generator, sample_gossip)


@SCHEDULES.register(
    "static", params={"topology": ("topology", str),
                      "degree": ("degree", int),
                      "topology_seed": ("topology_seed", int)})
class StaticSchedule:
    """The graph named by ``GroupSpec.topology``, fixed for the run."""

    uses_relevance = False
    #: True when the table is redrawn: the reference's send then sees
    #: traced delays and takes its one-hot path
    resamples = False

    def __init__(self, topo: Topology):
        self.base = topo
        self.topology = topo

    @property
    def max_delay(self) -> int:
        return self.base.max_delay

    def init_table(self) -> np.ndarray:
        return np.asarray(self.base.nbr, np.int32)

    def refresh(self, step, nbr, rel, alive=None):
        del step, rel, alive
        return nbr

    def materialize(self, step, nbr, rel) -> Topology:
        del step, nbr, rel
        return self.base

    def at_step(self, step, rel, alive=None) -> Topology:
        """The graph in force at ``step`` for the streaming trainer,
        which carries no table: a pure function of the step (``rel``
        the dense learned R or ``None``, ``alive`` host (n,) bool)."""
        del step, rel, alive
        return self.base


@SCHEDULES.register(
    "dynamic", params={"resample_every": ("resample_every", int)})
class DynamicSchedule(StaticSchedule):
    """Uniform gossip resampling; with ``resample_every <= 0`` it is the
    static base."""

    def __init__(self, dyn: DynamicTopology):
        self.topology = dyn
        self.base = dyn.base
        self.resamples = dyn.resample_every > 0

    @property
    def max_delay(self) -> int:
        return self.topology.max_delay

    def refresh(self, step, nbr, rel, alive=None):
        del rel
        if not self.resamples:
            return nbr
        return self.topology.refresh_table(step, nbr, alive)

    def materialize(self, step, nbr, rel) -> Topology:
        del step, rel
        if not self.resamples:
            return self.base
        return self.topology.with_table(nbr)

    def at_step(self, step, rel, alive=None) -> Topology:
        del rel
        return self.topology.at_epoch(step, alive)


def topk_draws(seed: int, rnd: int, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Round ``rnd``'s draws of a ``relevance_topk`` schedule: the
    Gumbel uniforms (n, n) in [1e-12, 1), the ε-coin uniforms (n,) and
    the uniform fallback's uniforms (n, n), fp32 on the CPU (the hook
    tests replace with the reference's draws)."""
    g = round_generator(seed, rnd, stream=1)
    u = torch.rand((n, n), generator=g)
    gumbel_u = torch.clamp(u * (1.0 - 1e-12) + 1e-12, 1e-12, 1.0)
    return (gumbel_u, torch.rand((n,), generator=g),
            torch.rand((n, n), generator=g))


@SCHEDULES.register(
    "relevance_topk", params={"explore_eps": ("explore_eps", float)})
class RelevanceTopKSchedule(StaticSchedule):
    """Gumbel top-k gossip over the learned relevance, with ε-greedy
    uniform rows; slot 0 stays the self-loop. A pure function of
    ``(seed, epoch // resample_every, R)`` given the round's draws."""

    uses_relevance = True
    resamples = True

    def __init__(self, base: Topology, resample_every: int, seed: int,
                 eps: float, dense_delay=None, dense_relevance=None):
        if resample_every < 1:
            raise ValueError(
                f"relevance_topk resamples on a cadence and needs "
                f"resample_every >= 1, got {resample_every}")
        if not 0.0 <= eps <= 1.0:
            raise ValueError(
                f"explore_eps must be in [0, 1], got {eps}")
        if not np.asarray(base.mask).all():
            raise ValueError(
                "relevance_topk resamples a k-regular table and "
                "cannot carry a padded edge mask — give it a "
                "regular-degree base (e.g. random_k)")
        if (dense_relevance is None
                and (np.asarray(base.relevance)
                     != np.asarray(base.mask, np.float32)).any()):
            raise ValueError(
                "the base topology's per-edge relevance prior cannot "
                "follow relevance_topk's table swaps — pass the prior "
                "as a dense (n, n) relevance= matrix instead")
        self.base = base
        self.topology = DynamicTopology(base=base,
                                        resample_every=resample_every,
                                        seed=seed, dense_delay=dense_delay,
                                        dense_relevance=dense_relevance)
        if dense_delay is None:
            self.topology._uniform_base_delay()  # validate early
        self.resample_every = resample_every
        self.seed = seed
        self.eps = eps

    @property
    def max_delay(self) -> int:
        return self.topology.max_delay

    def with_dense(self, delay=None, relevance=None
                   ) -> "RelevanceTopKSchedule":
        """Attach dense (resample-surviving) delay / relevance carries to
        the wrapped topology and its base."""
        if delay is not None or relevance is not None:
            self.topology = self.topology.with_dense(delay=delay,
                                                     relevance=relevance)
            self.base = self.topology.base
        return self

    def explore_mask(self, step: int) -> np.ndarray:
        """(n,) bool — which destinations explore in ``step``'s round."""
        n = self.base.n_agents
        _, u_e, _ = topk_draws(self.seed, int(step) // self.resample_every,
                               n)
        return (host_f32(u_e) < self.eps).numpy()

    def sample_table(self, step: int, rel, alive=None) -> np.ndarray:
        """The (n, k) int32 table of ``step``'s resample round.
        ``rel`` is the dense (n, n) ``R[src, dst]`` (``None``: uniform);
        ``alive`` forces dead source columns to −inf before the pick and
        shapes the uniform fallback the same way."""
        n, k = self.base.nbr.shape
        u_g, u_e, u_u = (host_f32(x) for x in topk_draws(
                             self.seed, int(step) // self.resample_every,
                             n))
        if rel is None:
            R = torch.ones((n, n), dtype=torch.float32)
        else:
            R = host_f32(rel)
        R = torch.clamp_min(R, 1e-30)
        gumbel = -torch.log(-torch.log(u_g))
        scores = torch.log(R.T) + gumbel
        scores = torch.where(torch.eye(n, dtype=torch.bool), -torch.inf,
                             scores)
        if alive is not None:
            live = torch.from_numpy(np.array(alive, bool))
            scores = torch.where(live[None, :], scores, -torch.inf)
        order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
        greedy = np.concatenate(
            [np.arange(n, dtype=np.int32)[:, None],
             order[:, :k - 1].numpy().astype(np.int32)], axis=1)
        uniform = sample_gossip(u_u, k, alive)
        explore = (u_e < self.eps).numpy()
        return np.where(explore[:, None], uniform, greedy).astype(np.int32)

    def refresh(self, step, nbr, rel, alive=None):
        if int(step) % self.resample_every:
            return nbr
        return self.sample_table(step, rel, alive)

    def materialize(self, step, nbr, rel) -> Topology:
        del step, rel
        return self.topology.with_table(nbr)

    def at_step(self, step, rel, alive=None) -> Topology:
        return self.topology.with_table(self.sample_table(step, rel, alive))

