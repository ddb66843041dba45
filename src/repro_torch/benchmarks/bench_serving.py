"""Serving load bench on the torch path — the twin of
``benchmarks/bench_serving.py``: open-loop Poisson traffic against the
multi-tenant ``GroupServeEngine``, latency/throughput gated.

An open-loop arrival process (exponential inter-arrivals at a fixed
offered load — arrivals do NOT wait for the server, the production
regime) drives a group of agents' policies through one engine, with a
param hot-swap published mid-run. Floors derive from a *calibrated*
single-step service time measured on the same machine, so the gates
track engine regressions rather than host speed:

1. **completeness** — every request finishes with a sane token count;
   the mid-run hot-swap drops or corrupts nothing.
2. **throughput** — sustained token throughput ≥ ``thr_frac`` × the
   offered token rate (the open-loop load is set below calibrated
   capacity, so a healthy engine keeps up and the measured rate is
   arrival-bound; an engine that lost its batching falls behind and
   the drain tail collapses the ratio).
3. **latency p50/p99** — request latency percentiles ≤ slack × the
   ideal no-queueing request latency (prefill + max_new_tokens decode
   steps at the calibrated step time). Slacks absorb the queueing
   delay of the offered load plus host noise; a per-slot host sync
   creeping back into the decode loop blows straight through them.

The traffic, the calibration, the gates and their bounds are the
reference's. The planes are drawn from ``torch.Generator`` seeds (agent
a from seed + a, the swap's from seed + 99 + a), so they are not the
reference's. ``--full`` serves the arch's published config (default:
``reduced()``, as the reference always does); ``--device`` picks the
card (default) or the host. Every run writes ``BENCH_serving_torch.json``
next to this file (override with ``--json``) and exits non-zero on a
failed gate.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving \\
        [--smoke] [--full] [--device cuda|cpu] [--arch llama3.2-3b] \\
        [--agents 4] [--slots 4] [--requests 32] [--load 0.6] \\
        [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import deque

_DEFAULT_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_serving_torch.json")


def build_engine(args, metrics):
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import agent_planes
    from repro_torch.serving import (GroupServeEngine, ParamStore, Router,
                                     ServeConfig)

    cfg = get_arch_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    store = ParamStore(agent_planes(cfg, args.agents, args.seed,
                                    args.device), donate=True)
    serve = ServeConfig(max_len=args.max_len,
                        max_new_tokens=args.new_tokens)
    engine = GroupServeEngine(cfg, store, serve, batch_size=args.slots,
                              prompt_pad=args.prompt_pad,
                              router=Router(args.router),
                              metrics=metrics, seed=args.seed)
    return cfg, engine


def make_requests(cfg, args, rng):
    """Deterministic request stream: prompts inside ONE pad bucket
    (prefill compiles once), agents round-robin."""
    from repro_torch.serving import GroupRequest
    reqs = []
    for rid in range(args.requests):
        n = int(rng.integers(2, args.prompt_pad))
        prompt = [int(t) for t in
                  rng.integers(0, cfg.vocab_size, n)]
        reqs.append(GroupRequest(rid, rid % args.agents, prompt))
    return reqs


def calibrate(engine, reqs) -> dict:
    """Warm the jit caches on a slot-filling prefix of the request
    stream, then time the steady-state decode step (min over the
    drain: the noise-robust statistic for a deterministic workload)
    and one warm prefill."""
    warm = reqs[:engine.B]
    for r in warm:
        engine.submit(r)
    engine.step()                      # compiles prefill + decode
    step_times = []
    while not engine.idle:
        t0 = time.monotonic()
        engine.step()
        step_times.append(time.monotonic() - t0)
    t_step = min(step_times) if step_times else 1e-3
    # warm prefill+splice timing: one more request through a hot cache
    t0 = time.monotonic()
    engine.submit(warm[0])
    engine.step()
    t_prefill = max(time.monotonic() - t0 - t_step, 0.0)
    while not engine.idle:
        engine.step()
    engine.reset()
    engine.metrics.__init__(clock=engine.metrics.clock)  # fresh traces
    return {"t_step_s": t_step, "t_prefill_s": t_prefill,
            "capacity_tok_s": engine.B / t_step}


def drive_open_loop(engine, reqs, calib, args, swap_planes) -> dict:
    """Open-loop Poisson arrivals at ``args.load`` × calibrated
    capacity; a fresh param version is published once the stream is
    half admitted. Wall-clock driven: arrivals become visible at
    their scheduled times whether or not the engine kept up."""
    import numpy as np
    mnt = args.new_tokens
    cap_req_s = calib["capacity_tok_s"] / mnt     # requests/s capacity
    lam = max(args.load * cap_req_s, 1e-6)
    rng = np.random.default_rng(args.seed + 1)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, len(reqs)))

    t0 = time.monotonic()
    engine.metrics.clock = lambda: time.monotonic() - t0
    pending = deque(zip(arrivals.tolist(), reqs))
    swap_at = len(reqs) // 2
    submitted = 0
    swapped = False
    while pending or not engine.idle:
        now = time.monotonic() - t0
        while pending and pending[0][0] <= now:
            t_arr, req = pending.popleft()
            engine.submit(req, at=t_arr)
            submitted += 1
        if not swapped and submitted >= swap_at:
            engine.store.publish(swap_planes, donate=True)
            engine.metrics.observe_swap()
            swapped = True
        if engine.idle and pending:
            time.sleep(max(pending[0][0] - (time.monotonic() - t0),
                           0.0))
            continue
        engine.step()
    return {"offered_req_s": lam, "offered_tok_s": lam * mnt,
            "arrival_span_s": float(arrivals[-1]), "swapped": swapped}


# ---------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------
def gate_completeness(engine, reqs, mnt: int) -> dict:
    ok = True
    bad = []
    for r in reqs:
        toks = engine.results.get(r.rid)
        if toks is None or not 1 <= len(toks) <= mnt:
            ok = False
            bad.append(r.rid)
    return {"pass": ok, "completed": len(engine.results),
            "expected": len(reqs), "bad_rids": bad[:8],
            "detail": "every request finishes with 1..max_new_tokens "
                      "tokens across the mid-run hot-swap"}


def gate_throughput(summary, load_info, thr_frac: float) -> dict:
    offered = load_info["offered_tok_s"]
    got = summary["throughput_tok_s"]
    return {"pass": bool(got >= thr_frac * offered),
            "throughput_tok_s": got, "offered_tok_s": offered,
            "floor_frac": thr_frac,
            "detail": "sustained tokens/s vs the offered open-loop "
                      "rate (load < 1 ⇒ a healthy engine keeps up)"}


def gate_latency(summary, calib, args) -> dict:
    ideal = (calib["t_prefill_s"]
             + args.new_tokens * calib["t_step_s"])
    p50_bound = args.slack_p50 * ideal
    p99_bound = args.slack_p99 * ideal
    return {"pass": bool(summary["latency_p50"] <= p50_bound
                         and summary["latency_p99"] <= p99_bound),
            "ideal_latency_s": ideal,
            "p50": summary["latency_p50"], "p50_bound": p50_bound,
            "p99": summary["latency_p99"], "p99_bound": p99_bound,
            "detail": "request latency vs slack × calibrated "
                      "no-queueing latency"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="CI fast path: small stream, loose load")
    p.add_argument("--arch", default="llama3.2-3b")
    p.add_argument("--agents", type=int, default=4)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--requests", type=int, default=None)
    p.add_argument("--new-tokens", type=int, default=None)
    p.add_argument("--max-len", type=int, default=None)
    p.add_argument("--prompt-pad", type=int, default=8)
    p.add_argument("--router", default="fifo",
                   choices=["fifo", "fair"])
    p.add_argument("--load", type=float, default=0.6,
                   help="offered load as a fraction of calibrated "
                        "capacity (open loop: arrivals don't wait)")
    p.add_argument("--slack-p50", type=float, default=6.0)
    p.add_argument("--slack-p99", type=float, default=15.0)
    p.add_argument("--thr-frac", type=float, default=0.4,
                   help="throughput floor as a fraction of the "
                        "offered token rate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default=_DEFAULT_JSON,
                   help="machine-readable results path")
    p.add_argument("--full", action="store_true",
                   help="the arch's published config (default: reduced())")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.requests is None:
        args.requests = 12 if args.smoke else 48
    if args.new_tokens is None:
        args.new_tokens = 8 if args.smoke else 16
    if args.max_len is None:
        args.max_len = 64 if args.smoke else 128

    import numpy as np

    from repro_torch.common.device import resolve_device
    from repro_torch.launch.serve import agent_planes
    from repro_torch.serving import ServeMetrics

    args.device = resolve_device(args.device)
    metrics = ServeMetrics()
    cfg, engine = build_engine(args, metrics)
    rng = np.random.default_rng(args.seed)
    reqs = make_requests(cfg, args, rng)

    print(f"serving load bench: arch={args.arch} "
          f"agents={args.agents} slots={args.slots} "
          f"requests={args.requests} new_tokens={args.new_tokens} "
          f"load={args.load} device={args.device.type}"
          f"{'' if args.full else ' (reduced)'}")
    calib = calibrate(engine, reqs)
    print(f"calibrated: t_step={calib['t_step_s'] * 1e3:.1f}ms "
          f"t_prefill={calib['t_prefill_s'] * 1e3:.1f}ms "
          f"capacity={calib['capacity_tok_s']:.1f} tok/s")

    # the hot-swap payload: a fresh init published mid-run (same
    # shapes), handed over to the store without a copy
    swap_planes = agent_planes(cfg, args.agents, args.seed + 99,
                               args.device)

    load_info = drive_open_loop(engine, reqs, calib, args, swap_planes)
    summary = engine.metrics.summary()
    print(f"completed {summary['completed']}/{summary['requests']} "
          f"requests, {summary['tokens']} tokens in "
          f"{summary['span_s']:.2f}s "
          f"({summary['throughput_tok_s']:.1f} tok/s vs "
          f"{load_info['offered_tok_s']:.1f} offered)")
    print(f"latency p50={summary['latency_p50'] * 1e3:.0f}ms "
          f"p99={summary['latency_p99'] * 1e3:.0f}ms  "
          f"ttft p50={summary['ttft_p50'] * 1e3:.0f}ms  "
          f"queue depth mean={summary['queue_depth_mean']:.1f} "
          f"max={summary['queue_depth_max']} swaps={summary['swaps']}")

    gates = {
        "completeness": gate_completeness(engine, reqs,
                                          args.new_tokens),
        "throughput": gate_throughput(summary, load_info,
                                      args.thr_frac),
        "latency": gate_latency(summary, calib, args),
    }
    for name, g in gates.items():
        print(f"gate {name}: {'PASS' if g['pass'] else 'FAIL'} "
              f"({ {k: v for k, v in g.items() if k != 'pass'} })")

    payload = {"bench": "serving", "arch": args.arch,
               "agents": args.agents, "slots": args.slots,
               "requests": args.requests,
               "new_tokens": args.new_tokens, "load": args.load,
               "router": args.router, "full": args.full,
               "device": args.device.type,
               "calibration": calib, "open_loop": load_info,
               "summary": summary, "rows": engine.metrics.rows(),
               "gates": gates}
    with open(args.json, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    print(f"\nwrote {args.json}")

    if not all(g["pass"] for g in gates.values()):
        raise SystemExit("serving load gate FAILED")
    return payload


if __name__ == "__main__":
    main()
