"""Chaos — a seeded, host-side fault injector for elastic membership —
the port of ``repro.core.chaos``, a copy of its numpy planner.

Faults are planned, not sampled on the fly: :func:`chaos_schedule`
rolls the whole kill/revive history up front with its own ``numpy``
generator, so a schedule is a plain ``(n_epochs, n_agents)`` bool
matrix, bitwise the reference's for the same seed. Membership events
are host-side decisions between epochs (``DDAL.kill`` /
``DDAL.revive``), and planning in numpy keeps a schedule from touching
any trainer's random stream.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def chaos_schedule(seed: int, n_agents: int, n_epochs: int,
                   kill_prob: float = 0.1, revive_after: int = 3,
                   min_alive: int = 1) -> np.ndarray:
    """Plan a deterministic kill/revive history.

    Returns ``alive[e, i]`` — whether agent ``i`` participates in
    epoch ``e``. Per epoch, each live agent dies with ``kill_prob``;
    a dead agent stays down exactly ``revive_after`` epochs, then
    revives. Kills are skipped (in agent order) whenever they would
    leave fewer than ``min_alive`` survivors, so the group never goes
    dark. Epoch 0 is always all-alive.
    """
    if not 0.0 <= kill_prob <= 1.0:
        raise ValueError(f"kill_prob must be in [0, 1], got {kill_prob}")
    if revive_after < 1:
        raise ValueError(f"revive_after must be >= 1, got {revive_after}")
    if not 1 <= min_alive <= n_agents:
        raise ValueError(f"min_alive must be in [1, {n_agents}], "
                         f"got {min_alive}")
    rng = np.random.default_rng(seed)
    down_until = np.zeros(n_agents, np.int64)     # first epoch back up
    alive = np.ones((n_epochs, n_agents), bool)
    for e in range(1, n_epochs):
        cur = down_until <= e                      # alive entering e
        wants = cur & (rng.random(n_agents) < kill_prob)
        budget = int(cur.sum()) - min_alive        # kills we can afford
        for i in np.flatnonzero(wants):
            if budget <= 0:
                break
            down_until[i] = e + revive_after
            budget -= 1
        alive[e] = down_until <= e
    return alive


def membership_events(alive: np.ndarray
                      ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Diff a schedule into per-epoch events.

    Yields ``(epoch, kill_mask, revive_mask)`` for every epoch whose
    membership differs from the previous one — the masks to hand to
    ``kill`` / ``revive`` *before* running that epoch. Epochs with no
    change are skipped.
    """
    alive = np.asarray(alive, bool)
    for e in range(1, alive.shape[0]):
        kill = alive[e - 1] & ~alive[e]
        revive = ~alive[e - 1] & alive[e]
        if kill.any() or revive.any():
            yield e, kill, revive
