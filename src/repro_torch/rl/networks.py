"""Small MLP networks for the RL agents — the port of
``repro.rl.networks``:

* ``policy_value``: A2C's policy and value networks (paper eq. 8–9);
* ``dueling_q``: the dueling architecture of DDADQN (paper eq. 7), a
  shared trunk with advantage and value heads;
* ``group_policy_act``: one forward that serves a batch of requests
  routed across the group's stacked policies.

Parameters are stacked over agents: a linear layer is
``{"w": (n, din, dout), "b": (n, dout)}`` and is applied to (n, B, din)
inputs with one batched matmul, so every agent runs its own network in
one call.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch


def _init_linear(gen: torch.Generator, n: int, din: int, dout: int
                 ) -> Dict[str, torch.Tensor]:
    w = torch.randn((n, din, dout), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return {"w": w * math.sqrt(2.0 / din),
            "b": torch.zeros((n, dout), dtype=torch.float32,
                             device=gen.device)}


def _linear(p, x):
    return torch.bmm(x, p["w"]) + p["b"].unsqueeze(1)


def init_mlp(gen: torch.Generator, n: int, dims: Sequence[int]) -> list:
    return [_init_linear(gen, n, a, b) for a, b in zip(dims[:-1], dims[1:])]


def mlp(params: list, x: torch.Tensor, final_act: bool = False):
    """x: (n, B, din) → (n, B, dout)."""
    for i, p in enumerate(params):
        x = _linear(p, x)
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def init_policy_value(gen: torch.Generator, n: int, obs_dim: int,
                      n_actions: int, hidden: int = 64) -> Dict[str, Any]:
    return {
        "policy": init_mlp(gen, n, (obs_dim, hidden, hidden, n_actions)),
        "value": init_mlp(gen, n, (obs_dim, hidden, hidden, 1)),
    }


def policy_logits(params, obs):
    return mlp(params["policy"], obs)


def state_value(params, obs):
    return mlp(params["value"], obs)[..., 0]


# ----------------------------------------------------------------------
# Dueling double-DQN (paper §5.1): shared trunk, A and V heads,
# Q(s,a) = V(s) + A(s,a) - mean_a A(s,a), the Wang et al. 2016 combine
# the reference keeps for identifiability
# ----------------------------------------------------------------------
def init_dueling_q(gen: torch.Generator, n: int, obs_dim: int,
                   n_actions: int, hidden: int = 64) -> Dict[str, Any]:
    return {
        "trunk": init_mlp(gen, n, (obs_dim, hidden)),
        "adv": init_mlp(gen, n, (hidden, hidden, n_actions)),
        "val": init_mlp(gen, n, (hidden, hidden, 1)),
    }


def dueling_q_values(params, obs):
    """obs (n, B, obs_dim) → Q (n, B, n_actions); the reference's order
    of float ops, (v + a) - mean(a)."""
    h = mlp(params["trunk"], obs, final_act=True)
    a = mlp(params["adv"], h)
    v = mlp(params["val"], h)
    return v + a - torch.mean(a, dim=-1, keepdim=True)


# ----------------------------------------------------------------------
# Serving entry points: the policy forward a serving engine routes per
# request
# ----------------------------------------------------------------------
def policy_forward(params, obs):
    """The policy's action logits: obs (n, B, obs_dim) over n stacked
    policies → (n, B, n_actions)."""
    return policy_logits(params, obs)


def _rows(tree, idx: torch.Tensor):
    if isinstance(tree, dict):
        return {k: _rows(v, idx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rows(v, idx) for v in tree)
    return tree[idx]


def group_policy_act(planes, agent_ids: torch.Tensor, obs: torch.Tensor,
                     gen: Optional[torch.Generator] = None,
                     temperature: float = 0.0):
    """Multi-tenant RL policy serving: one forward serves a batch of
    requests routed across the group.

    ``planes`` is the stacked per-agent policy tree (leaves
    ``(A, *param)``), ``agent_ids`` the (B,) routing vector and ``obs``
    the (B, obs_dim) requests. Each request's parameters are gathered
    from the planes and one batched forward advances every tenant.
    Returns ``(actions (B,) int64, logits (B, n_actions))``; temperature
    ≤ 0 is greedy argmax, otherwise a Gumbel-max sample from ``gen``
    (required) of the logits over the temperature."""
    logits = policy_forward(_rows(planes, agent_ids), obs.unsqueeze(1))[:, 0]
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1), logits
    if gen is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    from repro_torch.rl.a2c import sample_categorical
    return sample_categorical(logits / temperature, gen), logits
