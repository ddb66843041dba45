"""Group MDP — the paper's formalisation of GARL (paper §4, eq. 3) —
the port of ``repro.core.group_mdp``.

    ⟨S_1..n, A_1..n, P_1..n, R_1..n, γ_1..n, K_1..n, K_-1..-n⟩

Each agent i has its own stationary environment (S_i, A_i, P_i, R_i,
γ_i), a local-knowledge set K_i and a received-knowledge set K_-i; the
only coupling between agents is knowledge communication. This module
is the spec level: it declares the group, checks its structure and
binds per-agent environments; the learning dynamics live in
``repro_torch.core.ddal``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch.configs.base import GroupSpec


@dataclasses.dataclass(frozen=True)
class AgentEnv:
    """One agent's own MDP: an environment (``reset(gen, n)`` /
    ``step(state, action)``, as ``repro_torch.rl.envs`` has them) and
    its discount."""
    env: Any
    gamma: float = 0.99


@dataclasses.dataclass(frozen=True)
class GroupMDP:
    """A group of n agents, each with its own environment; knowledge is
    coupled through the relevance matrix R (``R[j, i]`` = relevance of
    j's knowledge to i). ``homogeneous()`` is the paper's §6 case."""
    agents: Sequence[AgentEnv]
    spec: GroupSpec
    relevance: Optional[Any] = None     # (n, n), diagonal included

    def __post_init__(self):
        n = len(self.agents)
        if n != self.spec.n_agents:
            raise ValueError(
                f"GroupSpec.n_agents={self.spec.n_agents} but "
                f"{n} agent environments were given")
        if self.relevance is not None:
            if tuple(np.shape(self.relevance)) != (n, n):
                raise ValueError(f"relevance must be ({n},{n})")

    @property
    def n(self) -> int:
        return len(self.agents)

    @classmethod
    def homogeneous(cls, env, n: int, spec: Optional[GroupSpec] = None,
                    gamma: float = 0.99) -> "GroupMDP":
        """Paper §6: every agent plays the same game and relevance is
        uniform."""
        spec = spec or GroupSpec(n_agents=n)
        if spec.n_agents != n:
            spec = dataclasses.replace(spec, n_agents=n)
        return cls(agents=tuple(AgentEnv(env, gamma) for _ in range(n)),
                   spec=spec)
