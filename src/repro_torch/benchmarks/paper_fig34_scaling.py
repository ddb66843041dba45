"""Paper Figs. 3–4 — DDA3C scaling to 4 and 6 agents with earlier
sharing starts (paper: 4 agents share at 10k/20k, 6 agents at 5k/10k
— i.e. at 50% of a shrinking budget), on the torch path; the twin of
``benchmarks/paper_fig34_scaling.py``.

Claims checked: group learning still reaches stable optimal policies;
occasional outlier agents do not poison the rest (the majority stays
at the optimum).

Each run draws from its own stream, seeded by (seed, n_agents)
(``common.run_generator``), so the runs are independent as the
reference's are.

    python -m repro_torch.benchmarks.paper_fig34_scaling
        [--epochs E4 E6] [--full] [--seed S] [--device cuda|cpu]
"""
from __future__ import annotations

from repro_torch.benchmarks.common import print_checks, run_a2c_group, \
    sparkline


def main(epochs4: int = 4_000, epochs6: int = 3_000, seed: int = 0,
         verbose: bool = True, device=None):
    out = {}
    for n, epochs in ((4, epochs4), (6, epochs6)):
        res = run_a2c_group(n, epochs, threshold=epochs // 2,
                            seed=seed, device=device)
        out[n] = res
        if verbose:
            print(res.summary(f"fig{'3' if n == 4 else '4'} DDA3C "
                              f"{n}-agent (share@{epochs // 2})"))
            for a in range(n):
                print("  " + sparkline(res.rewards[:, a]))

    checks = {}
    for n, res in out.items():
        t = res.tail()
        good = (t.mean(axis=0) > 80).sum()
        checks[f"{n}-agent: majority of agents near-optimal"] = \
            good >= (n // 2 + 1)
    if verbose:
        print_checks(checks)
    out["checks"] = checks
    return out


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, nargs=2, default=[4_000, 3_000],
                   metavar=("E4", "E6"),
                   help="epochs of the 4-agent and the 6-agent group")
    p.add_argument("--full", action="store_true",
                   help="paper scale (20k / 10k epochs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    e4, e6 = (20_000, 10_000) if a.full else a.epochs
    main(e4, e6, a.seed, device=a.device)
