"""Benchmark orchestrator on the torch path — the twin of
``benchmarks/run.py``: one benchmark per paper table / figure plus the
beyond-paper tables, each the port's twin.

    python -m repro_torch.benchmarks.run [--full] [--skip-rl] [--quick]
        [--device cuda|cpu] [--dryrun PATH ...]

  fig2    DDA3C 1 vs 2 agents            (paper Fig. 2)
  fig34   DDA3C 4- and 6-agent scaling   (paper Figs. 3–4)
  fig5    DDADQN 1 vs 2 agents           (paper Fig. 5)
  wavg    eq. 4 kernel gates + roofline  (beyond paper)
  cadence DDAL cadence vs traffic        (beyond paper)
  roofline the dry run's table           (from its JSON, if present)

The roofline table reads the records that
``python -m repro_torch.launch.dryrun --all --out PATH`` writes (the
reference's record layout: ``arch``, ``shape``, ``ok``, ``roofline``,
``memory``); by default the reference's four file names in the
working directory, else the ``--dryrun`` paths. Its times are the dry
run's predictions at the H100 data sheet's rates, not card times.
``--quick`` runs the wavg gates at their smoke sizes (the reference's
``--quick`` leaves them at full size).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

DRYRUN_FILES = ("dryrun_single_pod.json", "dryrun_multi_pod.json",
                "dryrun_single_pod_optimized.json",
                "dryrun_multi_pod_optimized.json")


def _roofline_table(path: str):
    with open(path) as f:
        recs = json.load(f)
    ok = [r for r in recs if r.get("ok")]
    print(f"\n== roofline (from {path}: {len(ok)}/{len(recs)} pairs) ==")
    print(f"{'arch':22s} {'shape':12s} {'dom':10s} {'t_comp':>10s} "
          f"{'t_mem':>10s} {'t_coll':>10s} {'useful':>7s} {'GiB/dev':>8s}")
    for r in ok:
        rf = r["roofline"]
        gib = (r.get("memory") or {}).get("total_bytes_per_device")
        print(f"{r['arch']:22s} {r['shape']:12s} {rf['dominant']:10s} "
              f"{rf['t_compute']:10.3e} {rf['t_memory']:10.3e} "
              f"{rf['t_collective']:10.3e} {rf['useful_ratio']:7.2f} "
              f"{(gib / 2**30 if gib else 0):8.2f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--full", action="store_true",
                   help="paper-scale epoch budgets (slow)")
    p.add_argument("--skip-rl", action="store_true",
                   help="skip the RL figure benches")
    p.add_argument("--quick", action="store_true",
                   help="tiny epoch budgets (smoke only)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dryrun", nargs="*", default=None,
                   help="dry-run JSON files for the roofline table")
    args = p.parse_args(argv)
    dev = args.device

    t0 = time.time()
    print("== bench: eq.4 weighted-average kernel (beyond paper) ==")
    from repro_torch.benchmarks.bench_wavg_kernel import main as wavg
    wavg(["--device", dev] + (["--smoke"] if args.quick else []))

    print("\n== bench: DDAL cadence vs traffic (beyond paper) ==")
    from repro_torch.benchmarks.bench_train_throughput import main as cad
    cad(steps=4 if args.quick else 12, device=dev)

    if not args.skip_rl:
        e2 = 800 if args.quick else (50_000 if args.full else 5_000)
        e5 = 600 if args.quick else (7_000 if args.full else 4_000)
        print("\n== bench: paper Fig. 2 (DDA3C 1 vs 2 agents) ==")
        from repro_torch.benchmarks.paper_fig2_a2c import main as fig2
        fig2(epochs=e2, device=dev)
        print("\n== bench: paper Figs. 3-4 (4/6-agent scaling) ==")
        from repro_torch.benchmarks.paper_fig34_scaling import main as fig34
        if args.quick:
            fig34(epochs4=600, epochs6=400, device=dev)
        elif args.full:
            fig34(epochs4=20_000, epochs6=10_000, device=dev)
        else:
            fig34(device=dev)
        print("\n== bench: paper Fig. 5 (DDADQN 1 vs 2 agents) ==")
        from repro_torch.benchmarks.paper_fig5_dqn import main as fig5
        fig5(epochs=e5, device=dev)
        if not args.quick:
            print("\n== bench: DDAL ablations (delay / T-weighting / "
                  "topology — beyond paper) ==")
            from repro_torch.benchmarks.ablation_ddal import main as abl
            abl(device=dev)

    for path in (DRYRUN_FILES if args.dryrun is None else args.dryrun):
        if os.path.exists(path):
            _roofline_table(path)

    print(f"\nall benchmarks done in {time.time() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
