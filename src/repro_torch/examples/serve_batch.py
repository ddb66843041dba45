"""Batched serving on the torch path — the twin of
``examples/serve_batch.py``: prefill + decode over the model's cache
(the KV cache of llama3.2-3b, the SSM state of mamba2-780m), two
requests a batch, temperature sampling.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \
        [--arch llama3.2-3b|mamba2-780m] [--device cpu]

The arch runs ``reduced()``, as in the reference; its weights come from
``torch.Generator`` seed 0 and the samples from a generator of seed 1
(not the reference's streams), the requests from the reference's numpy
draw.
"""
from __future__ import annotations

import time


def main(argv=None) -> list:
    """Serves the requests; prints the reference's lines and returns
    each batch's (B, new_tokens) tokens."""
    import argparse

    import numpy as np
    import torch

    from repro_torch.common.device import resolve_device
    from repro_torch.configs import ARCH_IDS, get_arch_config
    from repro_torch.models import get_model
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3.2-3b", choices=list(ARCH_IDS))
    p.add_argument("--new-tokens", type=int, default=24)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch_config(args.arch).reduced()
    params = get_model(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    engine = ServeEngine(cfg, params, ServeConfig(
        max_len=128, max_new_tokens=args.new_tokens,
        temperature=args.temperature))

    rng = np.random.default_rng(0)
    requests = [list(rng.integers(0, cfg.vocab_size, int(n)))
                for n in rng.integers(3, 20, 5)]
    print(f"serving {len(requests)} requests on reduced {args.arch} "
          f"(batch=2, temperature={args.temperature}, {device.type})")
    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(1)
    outs = []
    for toks, lens in serve_batches(requests, batch_size=2, device="cpu"):
        out = engine.generate(toks.to(device), lens, gen).cpu()
        outs.append(out)
        for i in range(out.shape[0]):
            print(f"  prompt[{int(lens[i]):2d} toks] -> "
                  f"{out[i].numpy()[:12]}...")
    print(f"done in {time.time() - t0:.1f}s")
    return outs


if __name__ == "__main__":
    main()
