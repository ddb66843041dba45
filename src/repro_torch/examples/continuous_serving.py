"""Continuous batching on the torch path — the twin of
``examples/continuous_serving.py``: 8 requests stream through 2
persistent decode slots; finished slots are refilled without stopping
the others (vLLM-style).

    PYTHONPATH=src python -m repro_torch.examples.continuous_serving \
        [--arch llama3.2-3b|mamba2-780m] [--device cpu]

The arch runs ``reduced()``, as in the reference; its weights come from
``torch.Generator`` seed 0 (not the reference's), the requests from the
reference's numpy draw.
"""
from __future__ import annotations

import time


def main(argv=None) -> dict:
    """Serves the requests; prints the reference's lines and returns
    {request index: tokens}."""
    import argparse

    import numpy as np
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.configs import ARCH_IDS, get_arch_config
    from repro_torch.models import get_model
    from repro_torch.serving import ContinuousBatcher, ServeConfig

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3.2-3b", choices=list(ARCH_IDS))
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--new-tokens", type=int, default=12)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch_config(args.arch).reduced()
    params = get_model(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    batcher = ContinuousBatcher(
        cfg, params, ServeConfig(max_len=96, max_new_tokens=args.new_tokens),
        batch_size=args.slots, prompt_pad=16)

    rng = np.random.default_rng(0)
    requests = [list(rng.integers(0, cfg.vocab_size, int(n)))
                for n in rng.integers(2, 14, args.requests)]
    print(f"{args.requests} requests → {args.slots} slots "
          f"(reduced {args.arch}, {device.type})")
    t0 = time.time()
    results = batcher.run(requests)
    dt = time.time() - t0
    for rid in sorted(results):
        print(f"  req {rid} [{len(requests[rid]):2d} prompt toks] "
              f"-> {results[rid]}")
    n_tok = sum(len(v) for v in results.values())
    print(f"{n_tok} tokens in {dt:.1f}s")
    return results


if __name__ == "__main__":
    main()
