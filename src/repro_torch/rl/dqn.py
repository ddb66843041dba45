"""Double-dueling DQN agents for DDADQN (paper §5.1) — the port of
``repro.rl.dqn``.

Gradients follow paper eq. 5–6:

    ∇θ L = ∇θ ( y_t − Q(φ_t, a_t; θ) )²
    y_t  = r                                          (terminal)
         = r + γ Q(φ', argmax_a' Q(φ', a'; θ); θ⁻)    (double DQN)

with the dueling combine of eq. 7 (``repro_torch.rl.networks``) and a
target network θ⁻ refreshed every ``target_period`` updates. One epoch
is one episode per agent into its replay ring plus one minibatch
gradient (Algorithm 1 lines 2–4).

The group is agent-major: parameters, target parameters and AdamW
moments are (n, P) rows (``PlaneLayout``), the replay rings (n, C, …)
planes with (n,) ``ptr`` and ``size``. Nothing in an epoch reads a
device value back to the host.

Torch cannot draw threefry's streams, so the random draws go through
two hooks that a test replaces with the reference's recorded draws:
``explore_draws`` (each step's ε-greedy uniform and random action) and
``sample_indices`` (the replay minibatch).

With ``track_obs`` the metrics carry each episode's observation
moments (``rollout.obs_moments``) for the ``obs_stats`` relevance
estimator, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import PlaneLayout
from repro_torch.optim import Optimizer
from repro_torch.rl import networks as nets
from repro_torch.rl.rollout import (Trajectory, episode_return, obs_moments,
                                    run_episode)


class Replay(NamedTuple):
    obs: torch.Tensor        # (n, C, obs_dim)
    actions: torch.Tensor    # (n, C) int64
    rewards: torch.Tensor    # (n, C)
    next_obs: torch.Tensor   # (n, C, obs_dim)
    dones: torch.Tensor      # (n, C) bool
    ptr: torch.Tensor        # (n,) int32 — steps written so far
    size: torch.Tensor       # (n,) int32


def make_replay(n: int, capacity: int, obs_dim: int, device) -> Replay:
    """n empty rings of ``capacity`` steps."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Replay(
        obs=zeros(n, capacity, obs_dim),
        actions=zeros(n, capacity, dtype=torch.int64),
        rewards=zeros(n, capacity),
        next_obs=zeros(n, capacity, obs_dim),
        dones=zeros(n, capacity, dtype=torch.bool),
        ptr=zeros(n, dtype=torch.int32),
        size=zeros(n, dtype=torch.int32))


def replay_add_traj(rep: Replay, traj: Trajectory) -> Replay:
    """Append every agent's live steps (``traj.mask > 0``, in step
    order) to its ring.

    The reference scans the steps and writes each live one at
    ``ptr % C``. Here live step t of agent i goes to slot
    (ptr + cumsum(live) − 1) mod C in one write. Where an episode has
    more live steps than C, a slot keeps the last step that lands on
    it, as the scan leaves it: each slot's writer is the largest step
    index landing there (a scatter-max, whose result does not depend
    on the order of the writes), and the planes are gathered from it,
    so no write has repeated indices."""
    n, C = rep.actions.shape
    T = traj.actions.shape[1]
    dev = rep.actions.device
    live = traj.mask > 0
    count = torch.cumsum(live.to(torch.int32), dim=1, dtype=torch.int32)
    slot = (rep.ptr[:, None] + count - 1) % C                   # (n, T)
    steps = torch.arange(T, device=dev).expand(n, T)
    writer = torch.full((n, C), -1, dtype=torch.int64, device=dev)
    writer.scatter_reduce_(1, slot.to(torch.int64),
                           torch.where(live, steps, -1), reduce="amax")
    hit = writer >= 0
    rows = torch.clamp_min(writer, 0)

    def put(buf, x):
        tail = buf.shape[2:]
        idx = rows.reshape((n, C) + (1,) * len(tail)).expand((n, C) + tail)
        got = torch.gather(x.to(buf.dtype), 1, idx)
        return torch.where(hit.reshape((n, C) + (1,) * len(tail)), got, buf)

    added = count[:, -1]
    return Replay(
        obs=put(rep.obs, traj.obs),
        actions=put(rep.actions, traj.actions),
        rewards=put(rep.rewards, traj.rewards),
        next_obs=put(rep.next_obs, traj.next_obs),
        dones=put(rep.dones, traj.dones),
        ptr=rep.ptr + added,
        size=torch.clamp_max(rep.size + added, C))


def sample_indices(size: torch.Tensor, batch: int,
                   gen: torch.Generator) -> torch.Tensor:
    """(n, batch) replay indices, uniform in [0, max(size, 1)) per
    agent, drawn on the device from ``gen`` (``size`` is never read
    back to the host)."""
    hi = torch.clamp_min(size, 1).to(torch.float32)[:, None]
    u = torch.rand((size.shape[0], batch), generator=gen,
                   device=size.device)
    return torch.minimum((u * hi).to(torch.int64), hi.to(torch.int64) - 1)


def replay_sample(rep: Replay, gen: torch.Generator, batch: int):
    """A minibatch of ``batch`` steps per agent, indices from
    ``sample_indices``: (obs, actions, rewards, next_obs, dones), each
    (n, batch, …)."""
    idx = sample_indices(rep.size, batch, gen)

    def take(buf):
        tail = buf.shape[2:]
        return torch.gather(buf, 1, idx.reshape(
            idx.shape + (1,) * len(tail)).expand(idx.shape + tail))

    return tuple(take(b) for b in (rep.obs, rep.actions, rep.rewards,
                                   rep.next_obs, rep.dones))


def explore_draws(n: int, n_actions: int, gen: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ε-greedy step's draws for n agents: a uniform in [0, 1) and a
    random action, each (n,)."""
    u = torch.rand((n,), generator=gen, device=gen.device)
    rand = torch.randint(0, n_actions, (n,), generator=gen,
                         device=gen.device)
    return u, rand


class DQNState(NamedTuple):
    params: torch.Tensor          # (n, P) fp32
    target_params: torch.Tensor   # (n, P) fp32
    opt_state: Any
    replay: Replay
    step: torch.Tensor            # (n,) int32 — updates so far
    eps_t: torch.Tensor           # (n,) int32 — exploration anneal counter


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    gamma: float = 0.99
    batch: int = 64
    capacity: int = 10_000
    target_period: int = 100     # copy θ→θ⁻ every C updates
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay: int = 2_000       # linear anneal epochs
    hidden: int = 64


def init_dqn(gen: torch.Generator, n: int, env, opt: Optimizer,
             cfg: DQNConfig) -> Tuple[DQNState, PlaneLayout]:
    """n freshly initialised agents on ``gen``'s device and the layout
    of their rows."""
    tree = nets.init_dueling_q(gen, n, env.obs_dim, env.n_actions,
                               cfg.hidden)
    layout = PlaneLayout.from_tree(tree, lead=1)
    params = layout.flatten(tree)
    zeros = torch.zeros((n,), dtype=torch.int32, device=params.device)
    return DQNState(
        params=params,
        target_params=params.clone(),
        opt_state=opt.init(params),
        replay=make_replay(n, cfg.capacity, env.obs_dim, params.device),
        step=zeros,
        eps_t=zeros.clone()), layout


def _fma(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """x·a + b rounded once to fp32, as a fused multiply-add rounds it,
    for fp32 ``x`` and fp32-representable ``a``, ``b``. The product is
    exact in fp64; the sum is rounded to fp64 with its error kept
    (TwoSum), and where that rounding landed exactly on a tie between
    two fp32 values the error decides the side."""
    p = x.double() * a
    s = p + b
    bb = s - p
    err = (p - (s - bb)) + (b - bb)
    f = s.float()
    fd = f.double()
    away = torch.nextafter(f, torch.where(s > fd, torch.inf, -torch.inf
                                          ).to(torch.float32))
    ad = away.double()
    tie = (fd + ad == 2 * s) & (err != 0)
    return torch.where(tie & ((err > 0) == (ad > fd)), away, f)


def epsilon(cfg: DQNConfig, t: torch.Tensor) -> torch.Tensor:
    """ε at anneal step ``t`` (n,) int32: eps_start + clip(t / eps_decay,
    0, 1)·(eps_end − eps_start) in fp32, bit for bit as the reference's
    compiled step has it. XLA turns the division by the constant into a
    product with f32(1 / eps_decay) and fuses the last product and sum
    into one fused multiply-add."""
    def f32(x):      # the fp32 value as a Python float: no upload
        return float(torch.tensor(x, dtype=torch.float32))

    inv = float(torch.tensor(1.0) / cfg.eps_decay)       # fp32 division
    frac = torch.clamp(t.to(torch.float32) * inv, 0.0, 1.0)
    return _fma(frac, f32(cfg.eps_end - cfg.eps_start), f32(cfg.eps_start))


def dqn_loss(params, target_params, batch, gamma: float) -> torch.Tensor:
    """Per-agent eq. 5 loss, (n,). ``params`` and ``target_params`` are
    unflattened trees (leaves with a leading agent axis); the batch is
    (n, B, …). The gradient flows through Q(φ, a; θ) only: the online
    argmax and the target net's value are computed without it."""
    obs, actions, rewards, next_obs, dones = batch
    q = nets.dueling_q_values(params, obs)                  # (n, B, A)
    q_a = torch.gather(q, -1, actions.unsqueeze(-1))[..., 0]
    with torch.no_grad():
        # double DQN: the online net selects, the target net evaluates
        a_star = torch.argmax(nets.dueling_q_values(params, next_obs), -1)
        q_next_tgt = nets.dueling_q_values(target_params, next_obs)
        q_star = torch.gather(q_next_tgt, -1, a_star.unsqueeze(-1))[..., 0]
    y = rewards + gamma * torch.where(dones, 0.0, q_star)
    return torch.mean(torch.square(y - q_a), dim=-1)        # eq. 5


def make_dqn_callbacks(env, opt: Optimizer, cfg: DQNConfig,
                       layout: PlaneLayout, track_obs: bool = False):
    """(gen_grads, apply_grads, params_of) for
    ``repro_torch.core.ddal.DDAL``, over the whole group at once. With
    ``track_obs`` the metrics carry each episode's observation moments
    (``obs_moments``)."""

    def gen_grads(state: DQNState, gen: torch.Generator):
        n = state.params.shape[0]
        eps = epsilon(cfg, state.eps_t)
        with torch.no_grad():
            net = layout.unflatten(state.params)

            def select(obs, g):
                q = nets.dueling_q_values(net, obs.unsqueeze(1))[:, 0]
                u, rand = explore_draws(n, env.n_actions, g)
                return torch.where(u < eps, rand, torch.argmax(q, dim=-1))

            traj = run_episode(env, select, gen, n)
            replay = replay_add_traj(state.replay, traj)
            batch = replay_sample(replay, gen, cfg.batch)
        flat = state.params.detach().requires_grad_(True)
        loss = dqn_loss(layout.unflatten(flat),
                        layout.unflatten(state.target_params), batch,
                        cfg.gamma)
        (grads,) = torch.autograd.grad(loss.sum(), flat)
        # no learning from a near-empty buffer; the optimiser still steps
        ok = (replay.size >= cfg.batch).to(torch.float32)
        grads = grads * ok[:, None]
        new_state = state._replace(replay=replay, eps_t=state.eps_t + 1)
        metrics = {"loss": loss.detach(), "return": episode_return(traj),
                   "epsilon": eps}
        if track_obs:
            metrics["obs_moments"] = obs_moments(traj)
        return grads, metrics, new_state

    def apply_grads(state: DQNState, grads: torch.Tensor) -> DQNState:
        params, opt_state = opt.update(grads, state.opt_state,
                                       state.params, state.step)
        step = state.step + 1
        sync = (step % cfg.target_period) == 0                  # per agent
        target = torch.where(sync[:, None], params, state.target_params)
        return DQNState(params, target, opt_state, state.replay, step,
                        state.eps_t)

    def params_of(state: DQNState) -> torch.Tensor:
        return state.params

    return gen_grads, apply_grads, params_of


def make_dqn_group(env, opt: Optimizer, spec, gen: torch.Generator,
                   cfg: Optional[DQNConfig] = None, *, device=None,
                   topology=None, relevance=None, delay=None):
    """Entry point for a DDADQN group: the exchange protocol for
    ``spec``, the DDAL loop over it and the initial group state.

    Runs on the CUDA card unless ``device="cpu"``; ``gen`` draws the
    initial weights and must live on that device. ``topology`` /
    ``relevance`` / ``delay`` override the graph and its annotations
    as in the reference; with ``spec.exchange_estimator="obs_stats"``
    the callbacks stream each episode's observation moments. Returns
    (ddal, group_state)."""
    from repro_torch.core.ddal import DDAL
    from repro_torch.core.exchange import build_exchange
    cfg = cfg or DQNConfig()
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(
            f"generator lives on {gen.device}, the group on {dev}")
    exchange = build_exchange(spec, kind="buffer", topology=topology,
                              relevance=relevance, delay=delay,
                              obs_dim=env.obs_dim)
    astates, layout = init_dqn(gen, spec.n_agents, env, opt, cfg)
    gen_g, app, pof = make_dqn_callbacks(env, opt, cfg, layout,
                                         track_obs=exchange.wants_obs)
    ddal = DDAL(spec, gen_g, app, pof, exchange=exchange, device=dev,
                layout=layout)
    return ddal, ddal.init(astates)
