"""Quickstart on the torch path — the twin of ``examples/quickstart.py``.

Two A2C agents play CartPole-v0 in *separate* environments and share
gradient knowledge through DDAL (paper Algorithm 1). Run:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

from repro_torch.benchmarks.common import run_a2c_group

EPOCHS = 1_500
THRESHOLD = 600          # epochs of independent warm-up learning


def main(epochs: int = EPOCHS, threshold: int = THRESHOLD, device=None,
         seed: int = 0):
    """Trains the group (CartPole, AdamW 3e-3, minibatch 100, 32
    pieces); prints the reference's lines and the epochs/s, and returns
    the (epochs, 2) rewards."""
    res = run_a2c_group(2, epochs, threshold, seed=seed, device=device)
    rewards = res.rewards
    for a in range(rewards.shape[1]):
        before = rewards[:threshold, a].mean()
        after = rewards[-300:, a].mean()
        print(f"agent {a}: mean reward {before:6.1f} (warm-up) -> "
              f"{after:6.1f} (after group sharing)")
    print("knowledge sharing starts at epoch", threshold,
          "- a reward of 100 is the optimum")
    print(f"{epochs} epochs in {res.wall_s:.1f} s, "
          f"{res.epochs_per_s:.2f} epochs/s on {res.device}")
    return rewards


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.epochs, device=a.device, seed=a.seed)
