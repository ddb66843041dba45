"""Shared harness for the paper-reproduction benchmarks (Figs. 2–5) on
the torch path — the twin of ``benchmarks/common.py``.

Each benchmark builds a DDAL group of A2C or DQN CartPole agents, runs
n_epochs and reports per-agent reward trajectories plus the paper's
qualitative stability metrics:

  * tail-mean   — mean reward over the last 20% of epochs
  * tail-std    — its std (the paper's "fluctuation")
  * frac@100    — fraction of tail epochs at the optimal reward 100

and the group's epochs/s (host clock around ``DDAL.run``, ended by
reading the rewards back), beside the device it ran on. The paper
trains 50k epochs; the default budgets are the reference's, and
``--full`` restores paper scale. Groups run on the CUDA card unless
``device="cpu"``.

Each run draws from its own stream, seeded by (seed, n_agents), as the
reference's runs draw from ``jax.random.split(key, n_agents)``: the
port's per-agent draws are elements of batched draws, so on the card a
group of n seeded like a group of one would replay the lone agent's
episodes in its agent 0 until sharing starts, and the figures' checks
would compare correlated runs.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import GroupSpec
from repro_torch.rl import CartPole, DQNConfig, make_a2c_group, \
    make_dqn_group


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


# ---------------------------------------------------------------------
# the gate benches' shared helpers (bench_wavg_kernel, bench_relevance_
# sketch, bench_fault_transport, bench_topology_scaling, ...)
# ---------------------------------------------------------------------
def device_info(device) -> dict:
    """What a bench's JSON records of where it ran: the device, and on
    the card its name and power limit as ``nvidia-smi`` prints them
    (``None`` where it cannot be read)."""
    dev = torch.device(device)
    info = {"device": dev.type, "name": _device_name(dev), "card": None}
    if dev.type == "cuda":
        import subprocess
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60)
            if smi.returncode == 0 and smi.stdout.strip():
                info["card"] = smi.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError):
            pass
    return info


def synchronize(device) -> None:
    """Wait for the work queued on the card (the reference's
    ``block_until_ready``); nothing to wait for on the host."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_s(thunk, device) -> float:
    """Host seconds of one call, the card synchronised after it."""
    t0 = time.perf_counter()
    thunk()
    synchronize(device)
    return time.perf_counter() - t0


def best_ms(thunk, device, repeats: int = 5) -> float:
    """Best-of-``repeats`` ms of one call after one warm-up call. On the
    card: CUDA events around the call, queued while a spin kernel holds
    the card for 1.5× the host's time to queue the call (at 2 GHz; the
    card's clock is at most 1.98 GHz), so the events time the card's
    work and not the host's launches. On the host: the host clock."""
    thunk()
    synchronize(device)
    if torch.device(device).type != "cuda":
        return min(wall_s(thunk, device) for _ in range(repeats)) * 1e3
    t0 = time.perf_counter()
    thunk()
    host_s = time.perf_counter() - t0
    synchronize(device)
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(host_s * 1.5 * 2e9) + 1_000_000)
        start.record()
        thunk()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def epoch_ms(thunk, epochs: int, device, repeats: int = 5) -> float:
    """Best-of-``repeats`` host ms per epoch of ``thunk`` (a run of
    ``epochs`` epochs, the card synchronised after it), after one
    warm-up call."""
    thunk()
    synchronize(device)
    return min(wall_s(thunk, device) for _ in range(repeats)) \
        / epochs * 1e3


def pair_best_s(ta, tb, device, repeats: int, alternate: bool = False):
    """Interleaved best-of-``repeats`` host seconds of two thunks (A B A
    B …, or with ``alternate`` the order flipping every round), after
    one warm-up call each, so that both see the same load."""
    ta()
    tb()
    synchronize(device)
    best_a = best_b = float("inf")
    for r in range(repeats):
        flip = alternate and r % 2 == 1
        for which in ((1, 0) if flip else (0, 1)):
            dt = wall_s(ta if which == 0 else tb, device)
            if which == 0:
                best_a = min(best_a, dt)
            else:
                best_b = min(best_b, dt)
    return best_a, best_b


def clone_state(x):
    """A copy of a group state whose tensors share nothing with ``x``
    (``DDAL.epoch_step`` updates the delay line in place, so a timed
    run restarts from a copy)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: clone_state(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(clone_state(v) for v in x))
    return x


def write_json(path: str, payload: dict) -> None:
    import json
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    print(f"wrote {path}")


@dataclasses.dataclass
class RunResult:
    rewards: np.ndarray          # (epochs, n_agents)
    wall_s: float
    spec: GroupSpec
    device: str

    @property
    def epochs_per_s(self) -> float:
        return self.rewards.shape[0] / self.wall_s

    def tail(self, frac: float = 0.2) -> np.ndarray:
        n = max(1, int(self.rewards.shape[0] * frac))
        return self.rewards[-n:]

    def summary(self, label: str) -> str:
        t = self.tail()
        lines = [f"{label}: {self.rewards.shape[0]} epochs, "
                 f"{self.rewards.shape[1]} agent(s), "
                 f"{self.wall_s:.1f}s, {self.epochs_per_s:.2f} epochs/s "
                 f"on {self.device}"]
        for a in range(t.shape[1]):
            lines.append(
                f"  agent {a}: tail-mean={t[:, a].mean():6.2f} "
                f"tail-std={t[:, a].std():6.2f} "
                f"frac@100={(t[:, a] >= 100).mean():.2f}")
        return "\n".join(lines)


def run_generator(seed: int, n_agents: int, device) -> torch.Generator:
    """The generator of one run of ``n_agents`` agents at ``seed``."""
    state = np.random.SeedSequence((seed, n_agents)).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _run(make_group, env, opt, spec, epochs, seed, device, *args,
         **kwargs):
    dev = resolve_device(device)
    gen = run_generator(seed, spec.n_agents, dev)
    ddal, gs = make_group(env, opt, spec, gen, *args, device=dev,
                          **kwargs)
    t0 = time.time()
    gs, metrics = ddal.run(gs, gen, epochs)
    rewards = metrics["return"].cpu().numpy()
    return RunResult(rewards=rewards, wall_s=time.time() - t0, spec=spec,
                     device=_device_name(dev))


def run_a2c_group(n_agents: int, epochs: int, threshold: int,
                  minibatch: int = 100, m_pieces: int = 32,
                  lr: float = 3e-3, seed: int = 0,
                  max_steps: int = 100, topology: str = "full",
                  degree: int = 4, topology_seed: int = 0,
                  device=None) -> RunResult:
    spec = GroupSpec(n_agents=n_agents, threshold=threshold,
                     minibatch=minibatch, m_pieces=m_pieces,
                     topology=topology, degree=degree,
                     topology_seed=topology_seed)
    return _run(make_a2c_group, CartPole(max_steps=max_steps),
                optim.adamw(lr), spec, epochs, seed, device)


def dqn_config(epochs: int) -> DQNConfig:
    """The figures' DQN settings for a run of ``epochs``."""
    return DQNConfig(capacity=10_000, eps_decay=max(500, epochs // 4))


def run_dqn_group(n_agents: int, epochs: int, threshold: int,
                  minibatch: int = 200, m_pieces: int = 32,
                  lr: float = 1e-3, seed: int = 0,
                  max_steps: int = 100, topology: str = "full",
                  degree: int = 4, topology_seed: int = 0,
                  device=None) -> RunResult:
    cfg = dqn_config(epochs)
    spec = GroupSpec(n_agents=n_agents, threshold=threshold,
                     minibatch=minibatch, m_pieces=m_pieces,
                     topology=topology, degree=degree,
                     topology_seed=topology_seed)
    return _run(make_dqn_group, CartPole(max_steps=max_steps),
                optim.adamw(lr), spec, epochs, seed, device, cfg)


def run_disjoint_groups(groups: int, size: int, epochs: int,
                        seed: int = 0, device=None,
                        agent: str = "a2c") -> RunResult:
    """One DDAL run of ``groups`` disjoint groups of ``size`` agents
    (each agent's in-neighbours are its own group), so that one run
    gives many figures' groups, each on its figure's schedule
    (``disjoint_schedule``). The rewards' column g·size + j is agent j
    of group g."""
    from repro_torch.core.topology import _from_neighbor_lists
    n = groups * size
    nbrs = [[size * (i // size) + j for j in range(size)]
            for i in range(n)]
    threshold, minibatch = disjoint_schedule(agent, size, epochs)
    spec = GroupSpec(n_agents=n, threshold=threshold, minibatch=minibatch,
                     m_pieces=32)
    make, lr, args = ((make_dqn_group, 1e-3, (dqn_config(epochs),))
                      if agent == "dqn" else (make_a2c_group, 3e-3, ()))
    return _run(make, CartPole(), optim.adamw(lr), spec, epochs, seed,
                device, *args, topology=_from_neighbor_lists(nbrs))


def disjoint_schedule(agent: str, size: int, epochs: int):
    """(threshold, minibatch) of the figure whose groups have ``size``
    ``agent`` agents: size 1 never shares; A2C pairs share from 40 % of
    the budget (Fig. 2), larger A2C groups from half (Figs. 3–4); DQN
    groups from 43 %, every tenth of the budget (Fig. 5)."""
    if agent not in ("a2c", "dqn"):
        raise ValueError(f"agent must be 'a2c' or 'dqn', not {agent!r}")
    if size == 1:
        return epochs + 1, 100
    if agent == "dqn":
        return int(epochs * 0.43), max(50, epochs // 10)
    return (int(epochs * 0.4) if size == 2 else epochs // 2), 100


def group_outcomes(rewards: np.ndarray, groups: int, size: int) -> dict:
    """How often the figures' outcomes occur among disjoint groups,
    over the tail (last 20 %) of ``rewards`` (epochs, groups · size)."""
    tail = rewards[-max(1, rewards.shape[0] // 5):]
    mean = tail.mean(0).reshape(groups, size)
    f100 = (tail >= 100).mean(0).reshape(groups, size)
    return {
        "groups with an agent at frac@100 > 0.9":
            int((f100.max(1) > 0.9).sum()),
        "groups with a majority above 80":
            int(((mean > 80).sum(1) >= size // 2 + 1).sum()),
        "agents at frac@100 > 0.9": int((f100 > 0.9).sum()),
        "agents below 50": int((mean < 50).sum()),
        "agents stuck below 12": int((mean < 12).sum()),
        "tail mean": float(tail.mean()),
    }


def sparkline(xs: np.ndarray, width: int = 60) -> str:
    """Terminal mini-plot of a reward trajectory."""
    blocks = " ▁▂▃▄▅▆▇█"
    if len(xs) > width:
        chunk = len(xs) // width
        xs = xs[:chunk * width].reshape(width, chunk).mean(axis=1)
    lo, hi = 0.0, max(float(np.max(xs)), 1.0)
    idx = ((xs - lo) / (hi - lo) * (len(blocks) - 1)).astype(int)
    return "".join(blocks[i] for i in np.clip(idx, 0, len(blocks) - 1))


def print_checks(checks: dict):
    for k, v in checks.items():
        print(f"  [{'PASS' if v else 'FAIL'}] {k}")
