"""Host cost of a kernel call through its custom op's dispatcher, beside
the direct launch, on one card.

    python src/repro_torch/benchmarks/dispatch_cost.py [--calls 50] \
        [--blocks 20]

For the SSD intra-chunk kernel at mamba2-780m's prefill shape (b, nc,
l, h, p, n, g) = (2, 4, 256, 48, 64, 128, 1) and the flash kernel at
llama3.2-3b's (B, S, H, K, D) = (2, 1024, 24, 8, 128), both in bf16, it
times blocks of ``--calls`` calls on the host clock, from the first
call to the last one's return: the launches queue on the card, which is
synchronised after each block, outside the timing. The routes take
turns block by block: the direct launch (``ops._launch``, what a card
tensor takes), the custom op (``torch.ops.repro_torch.*``, what a meta
or fake tensor takes) and the public wrapper (its checks, then the
direct launch). It prints the median µs per call of each route over
``--blocks`` blocks and the op's extra µs per call, beside the card's
name and power limit. The inputs come from seeded
``torch.Generator`` s. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time


def _ssd_inputs(torch):
    b, nc, l, h, p, n, g = 2, 4, 256, 48, 64, 128, 1
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dtc = torch.nn.functional.softplus(normal(b, nc, l, h))
    cs = torch.cumsum(dtc * -torch.exp(normal(h)), dim=2)
    return (normal(b, nc, l, h, p).bfloat16(), dtc, cs,
            normal(b, nc, l, g, n).bfloat16(),
            normal(b, nc, l, g, n).bfloat16())


def _flash_inputs(torch):
    B, S, H, K, D = 2, 1024, 24, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                 for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--blocks", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    x = _ssd_inputs(torch)
    q, k, v = _flash_inputs(torch)
    scale = 1.0 / 128 ** 0.5
    kernels = {
        "ssd_intra_chunk": {
            "direct": lambda: ssd._launch(*x),
            "op": lambda: torch.ops.repro_torch.ssd_intra_chunk(*x),
            "wrapper": lambda: ssd.ssd_intra_chunk(*x)},
        "flash_attention": {
            "direct": lambda: fa._launch(q, k, v, 0, scale),
            "op": lambda: torch.ops.repro_torch.flash_attention(
                q, k, v, 0, scale),
            "wrapper": lambda: fa.flash_attention(q, k, v)}}
    with torch.no_grad():
        for name, routes in kernels.items():
            us = {route: [] for route in routes}
            for block in range(args.blocks + 1):     # the first warms up
                for route, call in routes.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(args.calls):
                        call()
                    t = time.perf_counter() - t0
                    torch.cuda.synchronize()
                    if block:
                        us[route].append(t / args.calls * 1e6)
            med = {route: statistics.median(v) for route, v in us.items()}
            print(f"[dispatch] {name}: host µs per call, median of "
                  f"{args.blocks} blocks of {args.calls}: "
                  + ", ".join(f"{route} {m:.2f}" for route, m in med.items())
                  + f"; the op's extra {med['op'] - med['direct']:.2f} µs "
                  f"a call; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
