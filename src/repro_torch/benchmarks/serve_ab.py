"""Two checkouts' serving step, timed in turns on one card.

    python src/repro_torch/benchmarks/serve_ab.py --old DIR --new DIR \
        [--arch llama3.2-3b] [--phase decode|prefill|score] [--pairs 2]

runs a worker process in each checkout in the order old, new, new, old
(``--pairs`` times) and prints each worker's ms per step and the ratio
of the medians new / old, beside the card's name and power limit. Each
worker builds ``--arch`` at its published widths and depth from
``torch.Generator`` seed 0 (fp32 weights, bf16 compute) and takes the
serving launcher's first batch (2 requests of the launcher's draw,
seed 0, prompt-len 1024; ``max_len`` 1056). It times one step 7 times
on the host clock with the card synchronised around each, dropping the
first (warm-up):

- ``decode``: ``ServeEngine.decode`` of 32 tokens after a prefill, ms
  per token. Decode is given the prompt lengths as the checkout's
  launcher gives them: from the host where its decode takes them, else
  on the card. No decode reaches a kernel wrapper.
- ``prefill``: ``ServeEngine.prefill`` of the batch (mamba2-780m: one
  SSD launch a layer).
- ``score``: a cache-free ``model.forward`` of the batch's 2 x 1024
  ids under ``torch.no_grad()`` (llama3.2-3b: one flash launch a
  layer).

Needs a CUDA card.
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


def worker(arch: str, phase: str) -> dict:
    """ms per step of each warm run of ``phase`` in this checkout, and
    the launches of the flash and SSD kernels over all runs."""
    import torch

    from repro_torch.configs import get_arch_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
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
    flash_attention.launches = ssd_intra_chunk.launches = 0

    def result():
        return {"ms": ms[1:], "launches": flash_attention.launches
                + ssd_intra_chunk.launches}
    if phase != "decode":
        model = get_model(cfg)
        batch = {"tokens": toks, "positions": torch.arange(
            toks.shape[1], dtype=torch.int32, device="cuda").expand(
                toks.shape).contiguous()}
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                if phase == "prefill":
                    engine.prefill(toks, lens)
                else:
                    model.forward(cfg, params, batch, None)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return result()
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
    return result()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--new", type=Path)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--phase", default="decode",
                    choices=("decode", "prefill", "score"))
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.arch, args.phase)))
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
             "--arch", args.arch, "--phase", args.phase], cwd=root,
            env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        ms = got["ms"]
        medians[which].append(statistics.median(ms))
        print(f"[ab] {which}: {args.arch} {args.phase} ms per step, warm "
              f"runs " + ", ".join(f"{m:.2f}" for m in ms)
              + f"; median {medians[which][-1]:.2f}; kernel launches "
              f"{got['launches']}", flush=True)
    ratio = (statistics.median(medians["new"])
             / statistics.median(medians["old"]))
    print(f"[ab] {card}; order {', '.join(ORDER)} x {args.pairs}; median "
          f"of the medians new / old {ratio:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
