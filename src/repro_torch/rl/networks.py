"""Small MLP networks for the RL agents — the port of
``repro.rl.networks`` (policy and value networks of A2C, paper eq.
8–9).

Parameters are stacked over agents: a linear layer is
``{"w": (n, din, dout), "b": (n, dout)}`` and is applied to (n, B, din)
inputs with one batched matmul, so every agent runs its own network in
one call. The dueling Q network waits for the DQN slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence

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
