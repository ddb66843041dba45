"""Episode rollout (Algorithm 1 line 2: "generate k experiences") —
the port of ``repro.rl.rollout``.

One epoch is one episode per agent, run for exactly ``env.max_steps``
steps with no early exit, so the shapes and the post-terminal masking
are those of the reference's ``lax.scan``. Tensors are agent-major:
(n, T, ...).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch


class Trajectory(NamedTuple):
    obs: torch.Tensor        # (n, T, obs_dim)
    actions: torch.Tensor    # (n, T) int64
    rewards: torch.Tensor    # (n, T)
    next_obs: torch.Tensor   # (n, T, obs_dim)
    dones: torch.Tensor      # (n, T) bool — episode over AFTER this step
    mask: torch.Tensor       # (n, T) fp32 — 1 for real steps


def run_episode(env, select_action: Callable, gen: torch.Generator,
                n: int) -> Trajectory:
    """``select_action(obs (n, obs_dim), gen) -> (n,) actions``; runs
    ``env.max_steps`` steps for n agents from ``env.reset(gen, n)``."""
    s = env.reset(gen, n)
    steps = []
    for _ in range(env.max_steps):
        o = env.obs(s)
        live = torch.logical_not(s.done)
        a = select_action(o, gen)
        s, no, r, d = env.step(s, a)
        steps.append((o, a, r, no, d, live.to(torch.float32)))
    obs, actions, rewards, next_obs, dones, mask = (
        torch.stack(xs, dim=1) for xs in zip(*steps))
    return Trajectory(obs, actions, rewards * mask, next_obs, dones, mask)


def episode_return(traj: Trajectory) -> torch.Tensor:
    return torch.sum(traj.rewards, dim=-1)


def obs_moments(traj: Trajectory
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each agent's masked moment contributions of one episode's
    observations: ``(obs_sum (n, d), sq_sum (n,), count (n,))``, the
    side channel the ``obs_stats`` relevance estimator merges
    (``metrics["obs_moments"]``). Post-terminal steps are masked out."""
    m = traj.mask[..., None]
    obs_sum = torch.sum(traj.obs * m, dim=1)
    sq_sum = torch.sum(torch.square(traj.obs) * m, dim=(1, 2))
    return obs_sum, sq_sum, torch.sum(traj.mask, dim=1)
