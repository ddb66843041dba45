"""Paper Fig. 5 — DDADQN: single double-dueling-DQN agent vs 2-agent
group on CartPole-v0, on the torch path; the twin of
``benchmarks/paper_fig5_dqn.py``.

Paper claims checked: the single DQN fluctuates hard early but
eventually converges; the 2-agent group (sharing from 3k of 7k,
minibatch 1000 in the paper — scaled here) converges faster and with
fewer/smaller fluctuations after the first shared update.

Each run draws from its own stream, seeded by (seed, n_agents)
(``common.run_generator``), so the runs are independent as the
reference's are.

    python -m repro_torch.benchmarks.paper_fig5_dqn [--epochs N]
        [--full] [--seed S] [--device cuda|cpu]
"""
from __future__ import annotations

from repro_torch.benchmarks.common import print_checks, run_dqn_group, \
    sparkline


def main(epochs: int = 4_000, seed: int = 0, verbose: bool = True,
         device=None):
    threshold = int(epochs * 0.43)            # paper: 3k of ~7k
    minibatch = max(50, epochs // 10)         # paper: 1000 of 7k
    single = run_dqn_group(1, epochs, threshold=epochs + 1, seed=seed,
                           device=device)
    group = run_dqn_group(2, epochs, threshold=threshold,
                          minibatch=minibatch, seed=seed, device=device)

    if verbose:
        print(single.summary("fig5a single-agent DQN"))
        print("  " + sparkline(single.rewards[:, 0]))
        print(group.summary(
            f"fig5bc DDADQN 2-agent (share@{threshold}, "
            f"minibatch={minibatch})"))
        for a in range(2):
            print("  " + sparkline(group.rewards[:, a]))

    s_tail, g_tail = single.tail(), group.tail()
    checks = {
        "group tail-mean >= single tail-mean - 5":
            float(g_tail.mean()) >= float(s_tail.mean()) - 5.0,
        "group tail fluctuation <= single":
            float(g_tail.std(axis=0).mean())
            <= float(s_tail.std(axis=0).mean()) + 1e-6,
    }
    if verbose:
        print_checks(checks)
    return {"single": single, "group": group, "checks": checks}


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=4_000)
    p.add_argument("--full", action="store_true",
                   help="paper scale (7k epochs, minibatch 1000)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(7_000 if a.full else a.epochs, a.seed, device=a.device)
