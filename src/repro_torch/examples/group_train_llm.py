"""End-to-end example — the twin of ``examples/group_train_llm.py``:
DDAL group-agent training of a small llama-family model on synthetic
Markov data through the streaming trainer
(``repro_torch.core.sharded_ddal``).

Each agent is its own environment — a distinct order-1 Markov token
stream (50 % shared structure) — and the group exchanges gradient
knowledge at every ``minibatch``-th step after the warm-up.

    PYTHONPATH=src python -m repro_torch.examples.group_train_llm \\
        --device cpu --steps 30                          # ~25 M params
    PYTHONPATH=src python -m repro_torch.examples.group_train_llm \\
        --params-100m                                    # on the card

The reference's configs and schedule (threshold 20, minibatch 10, AdamW
3e-4, batch 4 × 256); the weights and the streams are the port's own
draws. It prints the reference's lines and returns the (steps, agents)
losses.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--params-100m", action="store_true",
                   help="~100M params")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--agents", type=int, default=2)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from repro_torch import optim
    from repro_torch.checkpoint import save
    from repro_torch.common.pytree import tree_leaves_with_paths
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.core.sharded_ddal import (init_train_state,
                                               make_group_train_step)
    from repro_torch.data import StreamSpec, make_group_batch

    base = get_arch_config("llama3.2-3b")
    if args.params_100m:
        cfg = base.with_(n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
                         head_dim=64, d_ff=1792, vocab_size=32_000,
                         param_dtype="float32", compute_dtype="float32")
    else:
        cfg = base.with_(n_layers=6, d_model=384, n_heads=6, n_kv_heads=3,
                         head_dim=64, d_ff=1024, vocab_size=16_000,
                         param_dtype="float32", compute_dtype="float32")
    spec = GroupSpec(n_agents=args.agents, threshold=20, minibatch=10,
                     knowledge_mode="streaming")
    shape = ShapeConfig("llm", seq_len=256, global_batch=4, kind="train")
    opt = optim.adamw(3e-4)
    stream = StreamSpec(seed=0, similarity=0.5)

    state = init_train_state(cfg, spec, opt, seed=0, device=args.device)
    n_params = sum(x.numel() for _, x in tree_leaves_with_paths(
        state.params)) // spec.n_agents
    print(f"{n_params:,} params/agent × {spec.n_agents} agents; "
          f"warm-up {spec.threshold} steps, share every {spec.minibatch}")

    step_fn = make_group_train_step(cfg, spec, opt)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        batch = make_group_batch(cfg, shape, stream, spec.n_agents, i,
                                 args.device)
        state, m = step_fn(state, batch)
        losses.append(m["loss"].cpu().numpy())
        if i % 10 == 0 or i == args.steps - 1:
            ls = " ".join(f"{float(x):6.3f}" for x in losses[-1])
            tag = " <shared>" if m["shared"] else ""
            print(f"step {i:4d} [{ls}]{tag}  "
                  f"({(i + 1) / (time.time() - t0):.2f} steps/s)")

    losses = np.stack(losses)
    print(f"\nloss agent-mean: first10={losses[:10].mean():.3f} "
          f"last10={losses[-10:].mean():.3f} "
          f"(uniform = {np.log(cfg.vocab_size):.3f})")
    if args.ckpt:
        save(args.ckpt, state.params, step=args.steps)
        print("checkpoint saved to", args.ckpt)
    return losses


if __name__ == "__main__":
    main()
