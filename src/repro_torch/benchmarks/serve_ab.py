"""Two checkouts' serving decode step, timed in turns on one card.

    python src/repro_torch/benchmarks/serve_ab.py --old DIR --new DIR \
        [--arch llama3.2-3b] [--pairs 2]

runs a worker process in each checkout in the order old, new, new, old
(``--pairs`` times) and prints each worker's ms per decode step and the
ratio of the medians new / old, beside the card's name and power
limit. Each worker builds ``--arch`` at its published widths and depth
from ``torch.Generator`` seed 0 (fp32 weights, bf16 compute), prefills
the serving launcher's first batch (2 requests of the launcher's draw,
seed 0, prompt-len 1024; ``max_len`` 1056) and times
``ServeEngine.decode`` of 32 tokens 7 times on the host clock with the
card synchronised around each, dropping the first (warm-up). Decode is
given the prompt lengths as the checkout's launcher gives them: from
the host where its decode takes them, else on the card. Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ORDER = ("old", "new", "new", "old")
RUNS = 7


def worker(arch: str) -> list:
    """ms per decode step of each warm run in this checkout."""
    import torch

    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.models import get_model
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    cfg = get_arch_config(arch)
    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    serve = ServeConfig(max_len=1056, max_new_tokens=32)
    engine = ServeEngine(cfg, params, serve)
    toks, lens = serve_batches(draw_prompts(cfg.vocab_size, 2, 1024, 0), 2,
                               device="cuda")[0]
    lengths = [int(n) for n in lens.cpu()]
    ms = []
    for _ in range(RUNS):
        logits, cache = engine.prefill(toks, lens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            engine.decode(logits, cache, lengths)
        except AttributeError:       # a decode that takes card tensors only
            lengths = lens
            engine.decode(logits, cache, lengths)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3
                  / (serve.max_new_tokens - 1))
    return ms[1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--new", type=Path)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.arch)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    medians = {"old": [], "new": []}
    for which in ORDER * args.pairs:
        root = (args.old if which == "old" else args.new).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             "--arch", args.arch], cwd=root, env=env, capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        medians[which].append(statistics.median(ms))
        print(f"[ab] {which}: {args.arch} decode ms per step, warm runs "
              + ", ".join(f"{m:.2f}" for m in ms)
              + f"; median {medians[which][-1]:.2f}", flush=True)
    ratio = (statistics.median(medians["new"])
             / statistics.median(medians["old"]))
    print(f"[ab] {card}; order {', '.join(ORDER)} x {args.pairs}; median "
          f"of the medians new / old {ratio:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
