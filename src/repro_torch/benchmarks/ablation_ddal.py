"""DDAL ablations (beyond the paper) on the torch path — the twin of
``benchmarks/ablation_ddal.py``: the knobs the paper introduces but
never sweeps.

  * asynchrony tolerance — a per-edge delivery delay d ∈ {0, 50, 150}
    epochs at share cadence 100 (staleness must exceed the cadence to
    bite: delayed pieces then miss their own share step and mix into
    later ones). The reference's docstring says {0, 5, 20}; its code,
    which this twin follows, runs 0 / 50 / 150;
  * T-weighting — epochs vs sqrt vs uniform, each at a delay of 150 so
    that the window mixes pieces of different maturity;
  * topology — full vs ring on 4 agents (K_{i,i'} ⊂ K_i: knowledge
    flows only to ring neighbours).

Each cell: DDA3C on CartPole-v0, 2,500 epochs, sharing from epoch
1,000 (40 % of the budget), share cadence 100, tail mean and std of
the return over the last 20 %. ``--epochs`` cuts the budget and keeps
sharing from 40 % of it; ``--cells`` runs a subset (by index or name),
so that the eight cells can run as parallel processes on the card.
Each cell's run draws from its own stream seeded by (seed, n_agents)
(``common.run_generator``), not from the reference's keys, so the
numbers are the port's own.

Each row also carries the share-step launches of its run
(``fused_wavg.launches``; 0 on the host), the pieces from other
agents that had reached the agent that heard fewest by the last share
step (its store's write count then, less its own pieces: the self-loop
delivers one every sharing epoch) and its epochs/s. A delayed piece
reaches a share step only where one sent at the first share step
arrives before the last: 500 epochs or more at delay 150. ``--json``
writes the rows with the device's name and power limit; by default
``BENCH_ablation_ddal_torch.json`` next to this file.

    python -m repro_torch.benchmarks.ablation_ddal [--epochs 2500]
        [--cells 0 3 ...] [--device cuda|cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import GroupSpec

_DEFAULT_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_ablation_ddal_torch.json")
EPOCHS = 2_500
THRESHOLD = 1_000              # sharing from 40 % of the budget


def _run(spec: GroupSpec, delay=None, epochs=EPOCHS, seed=0,
         device=None):
    """One cell: (tail mean, tail std, share-step launches, pieces from
    others heard by the last share step, epochs/s); reading the returns
    back ends the timed run."""
    from repro_torch import optim
    from repro_torch.benchmarks.common import run_generator
    from repro_torch.common.device import resolve_device
    from repro_torch.kernels.ddal_wavg import ops as wavg_ops
    from repro_torch.rl import CartPole, make_a2c_group

    dev = resolve_device(device)
    gen = run_generator(seed, spec.n_agents, dev)
    ddal, gs = make_a2c_group(CartPole(), optim.adamw(3e-3), spec, gen,
                              device=dev, delay=delay)
    shares = [e for e in range(spec.threshold, epochs)
              if e % spec.minibatch == 0]
    split = shares[-1] + 1 if shares else epochs
    before = wavg_ops.fused_wavg.launches
    t0 = time.perf_counter()
    gs, metrics = ddal.run(gs, gen, split)
    heard = (int(gs.stores.ptr.min()) - (split - spec.threshold)
             if shares else 0)
    returns = [metrics["return"]]
    if epochs > split:
        gs, metrics = ddal.run(gs, gen, epochs - split)
        returns.append(metrics["return"])
    r = torch.cat(returns).cpu().numpy()
    wall = time.perf_counter() - t0
    tail = r[-epochs // 5:]
    return (float(tail.mean()), float(tail.std()),
            wavg_ops.fused_wavg.launches - before, heard, epochs / wall)


def cells(epochs: int = EPOCHS):
    """The eight cells: (name, spec, delay matrix or None), in the
    reference's order, sharing from 40 % of ``epochs``."""
    threshold = THRESHOLD * epochs // EPOCHS
    base = dict(n_agents=2, threshold=threshold, minibatch=100,
                m_pieces=32)
    out = []
    for d in (0, 50, 150):
        delay = np.full((2, 2), d, np.int32) * (
            1 - np.eye(2, dtype=np.int32))
        out.append((f"delay={d}", GroupSpec(**base, max_delay=d), delay))
    for tw in ("epochs", "sqrt", "uniform"):
        delay = np.asarray([[0, 150], [150, 0]], np.int32)
        out.append((f"T={tw} (stale)",
                    GroupSpec(**base, max_delay=150, t_weighting=tw),
                    delay))
    base4 = dict(n_agents=4, threshold=threshold, minibatch=100,
                 m_pieces=32)
    for topo in ("full", "ring"):
        out.append((f"topology={topo} (4 agents)",
                    GroupSpec(**base4, topology=topo), None))
    return out


def _pick(all_cells, which):
    if not which:
        return all_cells
    names = [c[0] for c in all_cells]
    out = []
    for w in which:
        out.append(all_cells[int(w)] if str(w).isdigit()
                   else all_cells[names.index(w)])
    return out


def main(verbose: bool = True, epochs: int = EPOCHS, which=None,
         device=None, json_path=None):
    rows = []
    for name, spec, delay in _pick(cells(epochs), which):
        row = _run(spec, delay=delay, epochs=epochs, device=device)
        rows.append((name,) + tuple(row))
        if verbose:
            mean, std, launches, heard, eps = row
            print(f"{name:26s} {mean:10.2f} {std:9.2f} "
                  f"({launches} share-step launches, {heard} pieces "
                  f"heard by the last, {eps:.2f} epochs/s)", flush=True)
    if verbose:
        print(f"{'cell':26s} {'tail-mean':>10s} {'tail-std':>9s}")
        for name, mean, std, *_ in rows:
            print(f"{name:26s} {mean:10.2f} {std:9.2f}")
        print(f"(DDA3C CartPole, {epochs} epochs, share@"
              f"{THRESHOLD * epochs // EPOCHS}; optimum = 100)")
    if json_path:
        from repro_torch.benchmarks.common import device_info, write_json
        from repro_torch.common.device import resolve_device
        write_json(json_path, {
            "bench": "ablation_ddal", "epochs": epochs,
            **device_info(resolve_device(device)),
            "rows": [dict(cell=n, tail_mean=m, tail_std=s,
                          share_launches=k, heard_by_last_share=x,
                          epochs_per_s=e)
                     for n, m, s, k, x, e in rows]})
    return [(n, m, s) for n, m, s, *_ in rows]


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--cells", nargs="*", default=None,
                   help="cell indices (0-7) or names; default: all")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=_DEFAULT_JSON)
    a = p.parse_args()
    main(epochs=a.epochs, which=a.cells, device=a.device, json_path=a.json)
