"""CartPole-v0 batched over a leading agent axis — the port of
``repro.rl.envs.CartPole``.

Every agent plays its own environment; the state fields are (n,)
tensors and one ``step`` advances all of them. The dynamics, constants
and reward are the reference's (gym's classic-control CartPole with
Euler integration, episodes capped at 100 steps as in the paper's §6).
Python-float constants meet fp32 tensors as in the reference, so the
arithmetic stays fp32.
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
