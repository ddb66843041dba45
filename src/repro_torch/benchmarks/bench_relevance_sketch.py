"""Relevance-estimator scaling gates on the torch path — the twin of
``benchmarks/bench_relevance_sketch.py``: sketched streaming relevance
must stay O(A·|params|) streaming + O(A²·d) comparisons.

The exact ``grad_cos`` estimator costs O(A²·|params|) FLOPs per share
step, and the retired flatten oracle (``core.relevance.flatten_cosine``)
also builds an (A, P) fp32 concat of every agent's gradients. This
bench drives the sketched estimator (``core.relevance.sketch_cosine``
over ``kernels.grad_sketch.sketch_pytree``: one launch per leaf, the
kernel on the card, its plain version on the host) across growing
parameter counts and FAILS (non-zero exit) unless:

1. **streaming memory** — the reference bounds the largest jaxpr
   intermediate by max(largest leaf, ``DEFAULT_BLOCK``·d·4) plus the
   n·max(d, n)·4 tail. The port restates it as the card can observe
   it: the estimator's ``torch.cuda.max_memory_allocated`` above its
   inputs (on the host: the plain version's peak live bytes above its
   inputs, counted on ``meta`` tensors by
   ``roofline.trace.StepCounter``) ≤ max(largest leaf, the sketch's
   working buffer) + n·max(d, n)·4. The working buffer is what the
   sketch that runs holds whatever P: on the card the kernel's
   (chunks, n, d) fp32 partial sums and its (n, d) output for the leaf
   that needs the most (``grad_sketch.ops.sketch_geometry``), in place
   of the reference's projection block; on the host the plain
   version's counted peak over one ``TILE`` of positions. The exact
   per-leaf path (``grad_cosine``) obeys the same bound, every sketch
   peak stays below the (n, P) concat, and the flatten oracle provably
   reaches the concat (methodology sanity check);
2. **streaming time** — per-parameter sketch time does not grow with
   |params|: t(P₂)/t(P₁) ≤ (P₂/P₁) × 2.5 between the two largest
   sizes (CUDA events on the card, the host clock on the host);
3. **accuracy** — sketched-vs-exact cosine max abs error ≤ 0.15 at
   d = 256, with the d-sweep reported alongside;
4. **equivalence** — ``sketch_dim = 0`` bit-identical to the flatten
   oracle on the single-leaf bench model and ≤ 2e-6 from it on the
   multi-leaf one.

The smoke sweep's scales are 4, 8, 16 (the reference's 1, 2, 4): the
working buffer is about 8 MiB on the card (1,024 chunks of an (8, 256)
partial sum at 8 agents) and 7 MiB on the host, more than the whole
(n, P) concat below scale 3, where "below the concat" could not hold.
The full sweep keeps the reference's 4, 16, 64. ``bench_grads`` is the
reference's numpy draw, so both packages see the same tree.

Every run writes ``BENCH_relevance_sketch_torch.json`` next to this
file (override with ``--json``).

    python -m repro_torch.benchmarks.bench_relevance_sketch [--smoke]
        [--dim 256] [--device cuda|cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.benchmarks.common import (best_ms, device_info,
                                           synchronize, write_json)
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_leaves_with_paths
from repro_torch.core import relevance as REL
from repro_torch.core.pod_dispatch import relevance_exchange_bytes
from repro_torch.kernels.grad_sketch import ref as sketch_ref
from repro_torch.kernels.grad_sketch.ops import sketch_geometry

_DEFAULT_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_relevance_sketch_torch.json")

SMOKE_SCALES = [4, 8, 16]
FULL_SCALES = [4, 16, 64]


# ---------------------------------------------------------------------
# bench model: grouped-agent gradients with realistic cosine structure
# ---------------------------------------------------------------------
def bench_arrays(n: int, scale: int, seed: int = 0, noise: float = 0.5,
                 single_leaf: bool = False) -> dict:
    """The reference's ``bench_grads`` draw, as numpy arrays: half the
    agents descend a shared direction, half its negation, plus
    per-agent noise; ``scale`` multiplies the leaf widths."""
    shapes = {
        "embed": (256 * scale, 128),
        "attn": (128, 256 * scale),
        "mlp": (256 * scale, 128),
        "norm": (128 * scale,),
    }
    if single_leaf:
        shapes = {"w": (512 * scale, 128)}
    rng = np.random.default_rng(seed)
    tree = {}
    for name, shape in shapes.items():
        p = int(np.prod(shape))
        base = rng.normal(size=p)
        g = np.empty((n, p), np.float32)
        for i in range(n):
            sign = 1.0 if i < n // 2 else -1.0
            g[i] = sign * base + noise * rng.normal(size=p)
        tree[name] = g.reshape((n,) + shape)
    return tree


def bench_grads(n: int, scale: int, seed: int = 0, noise: float = 0.5,
                single_leaf: bool = False, device="cpu") -> dict:
    """``bench_arrays`` as stacked fp32 leaves on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in
            bench_arrays(n, scale, seed, noise, single_leaf).items()}


def _leaves(tree):
    return [x for _, x in tree_leaves_with_paths(tree)]


def tree_params(tree) -> int:
    leaves = _leaves(tree)
    return sum(x.numel() for x in leaves) // leaves[0].shape[0]


def max_leaf_bytes(tree) -> int:
    return max(x.numel() * x.element_size() for x in _leaves(tree))


def _meta_like(tree):
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


# ---------------------------------------------------------------------
# memory: what the estimator holds above its inputs
# ---------------------------------------------------------------------
def peak_bytes(fn, tree) -> int:
    """Peak bytes ``fn(tree)`` holds above its inputs: the card's
    ``max_memory_allocated`` for a card tree, after one warm-up call
    (one-time allocations such as cuBLAS's workspace are not the
    estimator's) and with the allocator's cache emptied, else the peak live bytes ``StepCounter`` counts for
    the same call on ``meta`` tensors."""
    dev = _leaves(tree)[0].device
    if dev.type == "cuda":
        fn(tree)         # warm-up: the kernel's library, cuBLAS's workspace
        synchronize(dev)
        # cached free blocks are handed out whole when a split would
        # leave < 1 MiB, which counts up to 1 MiB per allocation that
        # the estimator did not ask for: start from fresh segments
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn(tree)
        synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
        return peak
    from repro_torch.roofline.trace import StepCounter
    meta = _meta_like(tree)
    with StepCounter() as counter:
        out = fn(meta)
        del out
    return counter.peak


def plain_tile_bytes(n: int, dim: int) -> int:
    """The plain sketch's working set: its counted peak over one
    ``TILE`` of positions (it materialises the signs a tile at a
    time, so the peak does not grow with P)."""
    from repro_torch.roofline.trace import StepCounter
    G = torch.empty((n, sketch_ref.TILE), device="meta")
    with StepCounter() as counter:
        out = sketch_ref.sketch_flat(G, 0, dim)
        del out
    return counter.peak


def working_bytes(tree, dim: int) -> int:
    """The sketch's working buffer whatever P (gate 1): on the card the
    kernel's (chunks, n, d) partial sums and (n, d) output of the leaf
    that needs the most, on the host ``plain_tile_bytes``."""
    leaves = _leaves(tree)
    n = leaves[0].shape[0]
    if leaves[0].device.type != "cuda":
        return plain_tile_bytes(n, dim)
    return max((sketch_geometry(n, x.numel() // n, dim).chunks + 1)
               * n * dim * 4 for x in leaves)


def memory_fields(tree, dim: int) -> dict:
    """A sweep cell's memory numbers (MB): the largest leaf, the sketch's
    working buffer, and the sketched and exact estimators' peaks above
    their inputs."""
    return {"max_leaf_mb": max_leaf_bytes(tree) / 2**20,
            "working_mb": working_bytes(tree, dim) / 2**20,
            "sketch_peak_mb": peak_bytes(_sketch_fn(dim), tree) / 2**20,
            "exact_peak_mb": peak_bytes(REL.grad_cosine, tree) / 2**20}


def _sketch_fn(dim: int, seed: int = 0):
    return lambda t: REL.sketch_cosine(t, dim, seed)


# ---------------------------------------------------------------------
# one sweep cell
# ---------------------------------------------------------------------
def bench_row(n: int, scale: int, dim: int, repeats: int,
              device="cpu") -> dict:
    """One sweep cell: sketched + exact estimator time and peak above the
    inputs at this parameter count."""
    tree = bench_grads(n, scale, device=device)
    P = tree_params(tree)
    sk_fn = _sketch_fn(dim)
    ex_fn = REL.grad_cosine
    row = {
        "n": n, "scale": scale, "params": P, "dim": dim,
        **memory_fields(tree, dim),
        "sketch_ms": best_ms(lambda: sk_fn(tree), device, repeats),
        "exact_ms": best_ms(lambda: ex_fn(tree), device, repeats),
        # cross-mesh relevance traffic of each estimator (what the
        # pod-dispatched trainer moves per share step)
        "rel_xchg_sketch_mb":
            relevance_exchange_bytes(n, P, dim) / 2**20,
        "rel_xchg_exact_mb":
            relevance_exchange_bytes(n, P, 0) / 2**20,
    }
    err = (sk_fn(tree) - ex_fn(tree)).abs().cpu().numpy()
    row["cos_err_max"] = float(err[~np.eye(n, dtype=bool)].max())
    return row


# ---------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------
def gate_memory(rows, n: int, dim: int, device="cpu") -> dict:
    """Nothing (n, P)-shaped: sketched and exact peaks stay within the
    largest leaf or the sketch's working buffer (+ the (n, d) / (n, n)
    tail); every sketch peak is below the concat; the flatten oracle
    reaches the concat (so the method would catch a regression)."""
    tree_big = bench_grads(n, rows[-1]["scale"], device=device)
    concat_mb = (n * tree_params(tree_big) * 4) / 2**20
    oracle_peak = peak_bytes(REL.flatten_cosine, tree_big) / 2**20
    del tree_big
    ok = True
    for r in rows:
        allow = (max(r["max_leaf_mb"], r["working_mb"])
                 + (n * max(dim, n) * 4) / 2**20)
        r["allow_mb"] = allow
        ok &= r["sketch_peak_mb"] <= allow
        ok &= r["exact_peak_mb"] <= allow
        ok &= r["sketch_peak_mb"] < (n * r["params"] * 4) / 2**20
    sane = oracle_peak >= concat_mb * 0.99
    return {"pass": bool(ok and sane),
            "oracle_concat_mb": concat_mb,
            "oracle_peak_mb": oracle_peak,
            "allow_mb": [r["allow_mb"] for r in rows],
            "detail": "peak above the inputs ≤ max(leaf, sketch working "
                      "buffer) + tail, < the (n, P) concat; flatten "
                      "oracle ≥ the concat"}


def exchange_report(rows) -> dict:
    """Cross-mesh relevance traffic (``pod_dispatch.
    relevance_exchange_bytes``), reported rather than gated: both
    columns come from the same analytic accounting function."""
    return {"sketch_mb": sorted({r["rel_xchg_sketch_mb"]
                                 for r in rows}),
            "exact_mb": [r["rel_xchg_exact_mb"] for r in rows]}


def gate_time(rows, slack: float = 2.5) -> dict:
    """Per-parameter sketched-estimator time must not grow with
    |params| beyond the streaming pass, compared between the two
    largest sizes (a quadratic regression shows as ≥ 4× per-param at a
    4× size step, far beyond the slack)."""
    lo, hi = rows[-2], rows[-1]
    ratio = (hi["sketch_ms"] / hi["params"]) / \
        (lo["sketch_ms"] / lo["params"])
    return {"pass": bool(ratio <= slack), "per_param_ratio": ratio,
            "slack": slack,
            "detail": f"t/param at {hi['params']:,} vs "
                      f"{lo['params']:,} params"}


def gate_error(n: int, scale: int, dim: int, device="cpu") -> dict:
    """Sketched vs exact cosine max abs error at the gate dim, plus the
    reported d-sweep (deterministic: fixed seeds)."""
    tree = bench_grads(n, scale, device=device)
    exact = REL.grad_cosine(tree).cpu().numpy()
    off = ~np.eye(n, dtype=bool)
    sweep = {}
    for d in (64, dim, 4 * dim):
        sk = REL.sketch_cosine(tree, d, 0).cpu().numpy()
        e = np.abs(sk - exact)[off]
        sweep[d] = {"max": float(e.max()), "mean": float(e.mean())}
    return {"pass": bool(sweep[dim]["max"] <= 0.15),
            "bound": 0.15, "dim": dim, "sweep": sweep}


def gate_equivalence(n: int, device="cpu") -> dict:
    """sketch_dim = 0 ≡ the flatten oracle: bitwise on the single-leaf
    bench model, ≤ 2e-6 on the multi-leaf one."""
    rel0 = REL.init_relevance(n, device)
    single = bench_grads(n, 2, single_leaf=True, device=device)
    multi = bench_grads(n, 2, device=device)

    def new(tree):
        return REL.update_relevance(rel0, tree, "grad_cos", 0.5,
                                    sketch_dim=0).cpu().numpy()

    def old(tree):
        return REL.ema_update(rel0, REL.to_relevance(
            REL.flatten_cosine(tree)), 0.5).cpu().numpy()

    bitwise = bool(np.array_equal(new(single), old(single)))
    multi_err = float(np.abs(new(multi) - old(multi)).max())
    return {"pass": bool(bitwise and multi_err <= 2e-6),
            "single_leaf_bitwise": bitwise,
            "multi_leaf_max_err": multi_err}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="CI fast path: smaller parameter sweep")
    p.add_argument("--agents", type=int, default=8)
    p.add_argument("--dim", type=int, default=256,
                   help="sketch dimension d the gates run at")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=_DEFAULT_JSON,
                   help="machine-readable results path")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    n, dim = args.agents, args.dim
    scales = SMOKE_SCALES if args.smoke else FULL_SCALES
    rows = []
    print(f"sketched relevance sweep (n={n}, d={dim}, on {dev.type}):")
    print(f"{'params':>12} {'sketch ms':>10} {'exact ms':>9} "
          f"{'sk peak MB':>11} {'ex peak MB':>11} {'err max':>8}")
    for s in scales:
        r = bench_row(n, s, dim, args.repeats, dev)
        rows.append(r)
        print(f"{r['params']:12,} {r['sketch_ms']:10.2f} "
              f"{r['exact_ms']:9.2f} {r['sketch_peak_mb']:11.2f} "
              f"{r['exact_peak_mb']:11.2f} {r['cos_err_max']:8.4f}")

    gates = {
        "memory": gate_memory(rows, n, dim, dev),
        "time": gate_time(rows),
        "error": gate_error(n, scales[-1], dim, dev),
        "equivalence": gate_equivalence(n, dev),
    }
    exchange = exchange_report(rows)
    print()
    for name, g in gates.items():
        print(f"gate {name}: {'PASS' if g['pass'] else 'FAIL'} "
              f"({ {k: v for k, v in g.items() if k != 'pass'} })")
    print(f"relevance exchange (analytic, per share step): "
          f"sketch {exchange['sketch_mb']} MB flat vs exact "
          f"{exchange['exact_mb']} MB")

    payload = {"bench": "relevance_sketch", "n_agents": n, "dim": dim,
               **device_info(dev), "rows": rows, "exchange": exchange,
               "gates": gates}
    write_json(args.json, payload)

    if not all(g["pass"] for g in gates.values()):
        raise SystemExit("relevance sketch gate FAILED")
    return payload


if __name__ == "__main__":
    main()
