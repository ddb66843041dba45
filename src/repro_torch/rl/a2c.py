"""A2C agents for DDA3C (paper §5.2) — the port of ``repro.rl.a2c``.

One epoch (Algorithm 1 lines 2–4): every agent runs one episode, then
the one-step advantage loss and its gradients are computed:

    Q(s_t, a_t) = r                      (terminal s_{t+1})
                = r + γ V(s_{t+1})       (non-terminal)   [paper eq. 9]
    ∇θ log π_θ(a_t|s_t) · (Q(s_t,a_t) − V(s_t))           [paper eq. 8]

plus the value-network MSE on the same one-step target.

The group's parameters live in one (n, P) fp32 tensor, a row per agent
(``PlaneLayout``). The agents' losses are independent, so one backward
pass of their sum yields every agent's own gradient row at once.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import PlaneLayout
from repro_torch.optim import Optimizer
from repro_torch.rl import networks as nets
from repro_torch.rl.rollout import (Trajectory, episode_return, obs_moments,
                                    run_episode)


class A2CState(NamedTuple):
    params: torch.Tensor     # (n, P) fp32 — one flat row per agent
    opt_state: Any
    step: torch.Tensor       # (n,) int32 — optimiser step counters


def init_a2c(gen: torch.Generator, n: int, env, opt: Optimizer,
             hidden: int = 64) -> Tuple[A2CState, PlaneLayout]:
    """n freshly initialised agents and the layout of their rows."""
    tree = nets.init_policy_value(gen, n, env.obs_dim, env.n_actions,
                                  hidden)
    layout = PlaneLayout.from_tree(tree, lead=1)
    params = layout.flatten(tree)
    step = torch.zeros((n,), dtype=torch.int32, device=params.device)
    return A2CState(params, opt.init(params), step), layout


def sample_categorical(logits: torch.Tensor, gen: torch.Generator
                       ) -> torch.Tensor:
    """One action per row of ``logits`` by the Gumbel-max trick, the
    method of ``jax.random.categorical``: argmax(logits + G) with
    G = -log(-log(U)), U uniform in [tiny, 1). It stays on the device
    (no host-side checks, unlike ``torch.multinomial``)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def a2c_loss(params, traj: Trajectory, gamma: float,
             value_coef: float = 0.5, entropy_coef: float = 0.01
             ) -> torch.Tensor:
    """Per-agent average loss, (n,). ``params`` is the unflattened
    parameter tree (leaves with a leading agent axis)."""
    logits = nets.policy_logits(params, traj.obs)           # (n, T, A)
    v = nets.state_value(params, traj.obs)                  # (n, T)
    v_next = nets.state_value(params, traj.next_obs)        # (n, T)
    q = traj.rewards + gamma * torch.where(traj.dones, 0.0,
                                           v_next.detach())
    adv = q - v
    logp = torch.log_softmax(logits, dim=-1)
    logp_a = torch.gather(logp, -1, traj.actions.unsqueeze(-1))[..., 0]
    pg = -logp_a * adv.detach()
    value = 0.5 * torch.square(adv)
    probs = torch.softmax(logits, dim=-1)
    entropy = -torch.sum(probs * logp, dim=-1)
    per_step = pg + value_coef * value - entropy_coef * entropy
    denom = torch.clamp_min(torch.sum(traj.mask, dim=-1), 1.0)
    return torch.sum(per_step * traj.mask, dim=-1) / denom


def make_a2c_callbacks(env, opt: Optimizer, layout: PlaneLayout,
                       gamma: float = 0.99, entropy_coef: float = 0.01,
                       track_obs: bool = False):
    """(gen_grads, apply_grads, params_of) for
    ``repro_torch.core.ddal.DDAL``, over the whole group at once. With
    ``track_obs`` the metrics carry each episode's observation moments
    (``obs_moments``), the side channel of the ``obs_stats``
    estimator."""

    def gen_grads(state: A2CState, gen: torch.Generator):
        n = state.params.shape[0]
        with torch.no_grad():
            net = layout.unflatten(state.params)

            def select(obs, g):
                logits = nets.policy_logits(net, obs.unsqueeze(1))[:, 0]
                return sample_categorical(logits, g)

            traj = run_episode(env, select, gen, n)
        flat = state.params.detach().requires_grad_(True)
        loss = a2c_loss(layout.unflatten(flat), traj, gamma,
                        entropy_coef=entropy_coef)
        (grads,) = torch.autograd.grad(loss.sum(), flat)
        metrics = {"loss": loss.detach(), "return": episode_return(traj)}
        if track_obs:
            metrics["obs_moments"] = obs_moments(traj)
        return grads, metrics, state

    def apply_grads(state: A2CState, grads: torch.Tensor) -> A2CState:
        params, opt_state = opt.update(grads, state.opt_state,
                                       state.params, state.step)
        return A2CState(params, opt_state, state.step + 1)

    def params_of(state: A2CState) -> torch.Tensor:
        return state.params

    return gen_grads, apply_grads, params_of


def make_a2c_group(env, opt: Optimizer, spec, gen: torch.Generator, *,
                   device=None, topology=None, gamma: float = 0.99,
                   entropy_coef: float = 0.01, hidden: int = 64,
                   relevance=None, delay=None):
    """Entry point for a DDA3C group: the exchange protocol for
    ``spec``, the DDAL loop over it and the initial group state.

    Runs on the CUDA card unless ``device="cpu"``; ``gen`` draws the
    initial weights and must live on that device. ``topology`` /
    ``relevance`` / ``delay`` override the graph and its annotations
    as in the reference; with ``spec.exchange_estimator="obs_stats"``
    the callbacks stream each episode's observation moments. Returns
    (ddal, group_state)."""
    from repro_torch.core.ddal import DDAL
    from repro_torch.core.exchange import build_exchange
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(
            f"generator lives on {gen.device}, the group on {dev}")
    exchange = build_exchange(spec, kind="buffer", topology=topology,
                              relevance=relevance, delay=delay,
                              obs_dim=env.obs_dim)
    astates, layout = init_a2c(gen, spec.n_agents, env, opt, hidden)
    gen_g, app, pof = make_a2c_callbacks(env, opt, layout, gamma=gamma,
                                         entropy_coef=entropy_coef,
                                         track_obs=exchange.wants_obs)
    ddal = DDAL(spec, gen_g, app, pof, exchange=exchange, device=dev,
                layout=layout)
    return ddal, ddal.init(astates)

