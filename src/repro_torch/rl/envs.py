"""The paper's environments batched over a leading agent axis — the
port of ``repro.rl.envs``.

Every agent plays its own environment; the state fields are (n,)
tensors and one ``step`` advances all of them.

* ``CartPole``: the reference's dynamics, constants and reward (gym's
  classic-control CartPole-v0 with Euler integration, episodes capped
  at 100 steps as in the paper's §6). Python-float constants meet fp32
  tensors as in the reference, so the arithmetic stays fp32.
* ``GridWorld``: an N×N grid, start top-left, goal bottom-right, step
  cost -0.01, goal +1, one-hot observations; the reference's second,
  different task for heterogeneous groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch


class CartPoleState(NamedTuple):
    x: torch.Tensor          # (n,) fp32 — cart position
    x_dot: torch.Tensor
    theta: torch.Tensor      # pole angle (rad)
    theta_dot: torch.Tensor
    t: torch.Tensor          # (n,) int32 — step count
    done: torch.Tensor       # (n,) bool


@dataclasses.dataclass(frozen=True)
class CartPole:
    """CartPole-v0 (gym classic_control constants)."""
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5            # half pole length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12 * 2 * math.pi / 360
    x_threshold: float = 2.4
    max_steps: int = 100           # paper §6: max 100 steps per episode

    obs_dim: int = 4
    n_actions: int = 2

    def reset(self, gen: torch.Generator, n: int) -> CartPoleState:
        """n fresh states, each coordinate uniform in [-0.05, 0.05),
        drawn from ``gen`` on its device."""
        vals = torch.rand((n, 4), generator=gen, device=gen.device,
                          dtype=torch.float32) * 0.1 - 0.05
        zeros = torch.zeros((n,), dtype=torch.int32, device=gen.device)
        return CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2],
                             vals[:, 3], zeros, zeros.to(torch.bool))

    def obs(self, s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def step(self, s: CartPoleState, action: torch.Tensor
             ) -> Tuple[CartPoleState, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        force = torch.where(action == 1, self.force_mag, -self.force_mag
                            ).to(torch.float32)
        costh = torch.cos(s.theta)
        sinth = torch.sin(s.theta)
        temp = (force + polemass_length * s.theta_dot ** 2 * sinth
                ) / total_mass
        thetaacc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh ** 2 /
                           total_mass))
        xacc = temp - polemass_length * thetaacc * costh / total_mass
        x = s.x + self.tau * s.x_dot
        x_dot = s.x_dot + self.tau * xacc
        theta = s.theta + self.tau * s.theta_dot
        theta_dot = s.theta_dot + self.tau * thetaacc
        t = s.t + 1
        fell = ((torch.abs(x) > self.x_threshold)
                | (torch.abs(theta) > self.theta_threshold))
        done = fell | (t >= self.max_steps) | s.done
        # gym gives +1 for every step taken, including the failing one;
        # once an episode was already done, further steps score 0
        reward = torch.where(s.done, 0.0, 1.0).to(torch.float32)
        ns = CartPoleState(x, x_dot, theta, theta_dot, t, done)
        return ns, self.obs(ns), reward, done


class GridState(NamedTuple):
    pos: torch.Tensor        # (n,) int32 — flattened cell index
    t: torch.Tensor          # (n,) int32 — step count
    done: torch.Tensor       # (n,) bool


@dataclasses.dataclass(frozen=True)
class GridWorld:
    """N×N gridworld: start top-left, goal bottom-right, step cost
    -0.01, goal +1. The observation is the one-hot cell."""
    size: int = 5
    max_steps: int = 50

    @property
    def obs_dim(self) -> int:
        return self.size * self.size

    n_actions: int = 4      # up / down / left / right

    def reset(self, gen: torch.Generator, n: int) -> GridState:
        """n agents at the start cell, on ``gen``'s device; nothing is
        drawn, as the reference ignores its key."""
        zeros = torch.zeros((n,), dtype=torch.int32, device=gen.device)
        return GridState(zeros, zeros.clone(), zeros.to(torch.bool))

    def obs(self, s: GridState) -> torch.Tensor:
        """The one-hot cell, (n, obs_dim) fp32 (a compare, which reads
        nothing back to the host)."""
        cells = torch.arange(self.obs_dim, dtype=torch.int32,
                             device=s.pos.device)
        return (s.pos.unsqueeze(-1) == cells).to(torch.float32)

    def step(self, s: GridState, action: torch.Tensor):
        n = self.size
        r, c = s.pos // n, s.pos % n
        # the reference's tables dr = [-1, 1, 0, 0], dc = [0, 0, -1, 1],
        # computed from the action so that no step uploads a table
        i32 = torch.int32
        dr = (action == 1).to(i32) - (action == 0).to(i32)
        dc = (action == 3).to(i32) - (action == 2).to(i32)
        r = torch.clamp(r + dr, 0, n - 1)
        c = torch.clamp(c + dc, 0, n - 1)
        pos = r * n + c
        t = s.t + 1
        at_goal = pos == (n * n - 1)
        done = at_goal | (t >= self.max_steps) | s.done
        reward = torch.where(s.done, 0.0, torch.where(at_goal, 1.0, -0.01)
                             ).to(torch.float32)
        ns = GridState(pos, t, done)
        return ns, self.obs(ns), reward, done
