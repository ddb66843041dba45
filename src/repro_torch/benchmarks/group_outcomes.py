"""How often the paper's figures' outcomes occur, from many groups in
one run: ``--groups`` disjoint groups of ``--size`` A2C or DQN agents
(``--agent``) trained by one DDAL (``common.run_disjoint_groups``), once
per seed. A figure's check is one outcome of one seed; these rates say
how often it holds.

    python -m repro_torch.benchmarks.group_outcomes [--groups 32]
        [--size 1] [--epochs 3000] [--seeds 0 1] [--agent a2c|dqn]
        [--device cuda|cpu]
"""
from __future__ import annotations

from repro_torch.benchmarks.common import group_outcomes, \
    run_disjoint_groups


def main(groups: int = 32, size: int = 1, epochs: int = 3_000,
         seeds=(0, 1), device=None, verbose: bool = True,
         agent: str = "a2c"):
    """Returns the outcome counts of each seed's run."""
    out = {}
    for seed in seeds:
        res = run_disjoint_groups(groups, size, epochs, seed=seed,
                                  device=device, agent=agent)
        out[seed] = group_outcomes(res.rewards, groups, size)
        if verbose:
            counts = ", ".join(f"{k}: {v}" for k, v in out[seed].items())
            print(f"seed {seed}: {groups} groups of {size} {agent}, "
                  f"{epochs} epochs, {res.epochs_per_s:.2f} epochs/s on "
                  f"{res.device}; {counts}")
    return out


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--groups", type=int, default=32)
    p.add_argument("--size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=3_000)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--agent", default="a2c", choices=["a2c", "dqn"])
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.groups, a.size, a.epochs, a.seeds, device=a.device,
         agent=a.agent)
