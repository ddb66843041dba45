"""eq. 4 fused share-step kernel gates + roofline bench on the torch path
— the twin of ``benchmarks/bench_wavg_kernel.py``.

The share step's value is memory traffic: the historical multi-op path
(``eq4_weights`` → ``common.pytree.tree_weighted_sum``) reads the fp32
plane stack and re-reads the accumulator per piece; the fused CUDA
kernel (``repro_torch.kernels.ddal_wavg``) streams the arrival-slot
planes once, rebuilds the eq. 4 weights in-kernel and emits (ḡ, Σw)
directly, and the int8 block-quantized variant reads ~N bytes instead
of 4N. A run over m pieces of n parameters is one agent's store, a
(1, m, n) stack. This bench FAILS (non-zero exit) unless:

1. **correctness** — the share step (the kernel on the card, its plain
   version on the host) matches the multi-op oracle within 2e-5 at
   fp32 and on int8 planes, Σw within 1e-6; on the card each kernel is
   also bitwise its plain version (as ``chip_smoke.py`` holds it);
2. **bitwise** — the plain fused step is bit-identical to the
   multi-op path at quantization off, on flat rows and on a two-leaf
   tree flattened by its ``PlaneLayout``; on the card the kernel too;
3. **one pass** — the reference counts one ``pallas_call`` in the
   jaxpr and bounds the XLA int8 path's largest intermediate by ½ of
   an fp32 dequant of the stack (m·n·4 bytes). The port restates it as
   the card can observe it: one launch of ``fused_wavg`` and one of
   ``fused_wavg_q`` per share step (``<wrapper>.launches``), and the
   int8 step's ``torch.cuda.max_memory_allocated`` above its inputs
   ≤ ½·m·n·4. On the host, where no kernel runs, the int8 plain
   version's peak live bytes above its inputs, counted on ``meta``
   tensors by ``roofline.trace.StepCounter``, ≤ the same ½·m·n·4;
4. **quantization accuracy** — |ḡ_int8 − ḡ_fp32|∞ ≤ ½·max(scale) and
   relative L2 ≤ 1e-2 at every block size of ``Q_BLOCKS``;
5. **bytes** — an int8 delay line holds ≥ 3.5× fewer bytes than fp32
   (``make_sparse_inflight`` on ``meta``: nothing allocated), and
   ``pod_dispatch._edge_cost`` shows the same saving.

The roofline record and the sweep give each size's least time at the
H100's memory rate (``roofline.constants.HBM_BW``: keys
``h100_bound_*``) beside the kernels' CUDA-event times on the card
(``card_*_us``); the reference's v5e numbers are not carried over. On
the host the record has the bounds and the plain version's host-clock
time (``host_plain_*``), which is no card fact. The record's
``hlo_bytes`` are the bytes the plain fused step accesses, counted on
``meta`` (``StepCounter``), the counterpart of the reference's
``cost_analysis``.

Inputs are drawn from ``torch.Generator`` seeds on the host, so they
are not the reference's; every gate function also takes the arrays
(the parity tests feed both sides the same draws). Every run writes
``BENCH_wavg_kernel_torch.json`` next to this file (override with
``--json``).

    python -m repro_torch.benchmarks.bench_wavg_kernel [--smoke]
        [--device cuda|cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch

from repro_torch.benchmarks.common import (best_ms, device_info,
                                           synchronize, wall_s, write_json)
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (BlockLayout, PlaneLayout,
                                       tree_leaves_with_paths,
                                       tree_weighted_sum)
from repro_torch.core.weighting import eq4_weights, sequential_sum
from repro_torch.kernels.ddal_wavg import ops, ref
from repro_torch.roofline.constants import HBM_BW

_DEFAULT_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_wavg_kernel_torch.json")

SIZES = [(4, 1_000_000), (8, 10_000_000),
         (16, 10_000_000), (8, 100_000_000)]
SMOKE_SIZES = [(4, 1_000_000), (8, 2_000_000)]
Q_BLOCKS = (128, 512, 2048, 8192)      # multiples of 128 dividing 8192

REL_L2_BOUND = 1e-2                    # pinned int8-vs-fp32 eq. 4 error


def _as(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x, device=device, dtype=dtype)


def _meta(m: int, seed: int = 0, device="cpu"):
    """(T, R, valid) with one invalid piece — the masked regime."""
    gen = torch.Generator().manual_seed(seed)
    T = torch.abs(torch.randn((m,), generator=gen)) + 0.1
    R = torch.abs(torch.randn((m,), generator=gen)) + 0.1
    valid = torch.arange(m) != 1
    return T.to(device), R.to(device), valid.to(device)


def _normal(m: int, n: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1000 + seed)
    return torch.randn((m, n), generator=gen).to(device)


def _inputs(m, n, seed, device, G=None, meta=None):
    """The gate's (G, T, R, valid): drawn from ``seed``, or the arrays
    given (numpy or torch), on ``device``."""
    G = (_normal(m, n, seed, device) if G is None
         else _as(G, device, torch.float32))
    T, R, valid = (_meta(m, seed, device) if meta is None else
                   (_as(meta[0], device, torch.float32),
                    _as(meta[1], device, torch.float32),
                    _as(meta[2], device, torch.bool)))
    return G, T, R, valid


def _legacy(G, T, R, valid):
    """The historical multi-op share step, spelled at the call site; Σw
    is added left to right, as every eq. 4 sum of the port is
    (``weighting.sequential_sum``)."""
    w = eq4_weights(T, R, valid)
    return tree_weighted_sum(G, w), sequential_sum(w)


def _one(G, T, R, valid):
    """One agent's store as the share step takes it: (1, m, n)."""
    return G[None], T[None], R[None], valid[None]


@functools.lru_cache(maxsize=8)
def _single_leaf(n: int, q_block: int) -> BlockLayout:
    """The block layout of a one-leaf row, built once (its index maps
    are uploaded once per device, as a trainer's layout is)."""
    return BlockLayout((0,), (n,), q_block)


def _fused(G, T, R, valid):
    g, w = ops.fused_wavg(*_one(G, T, R, valid))
    return g[0], w[0]


def _quantize(G, q_block):
    """(Q, S) of one leaf's rows, Q contiguous as the kernel takes it
    (``quantize_rows`` returns a view when the last block is short)."""
    Q, S = ref.quantize_rows(G, q_block)
    return Q.contiguous(), S


def _fused_q(Q, S, T, R, valid, q_block):
    g, w = ops.fused_wavg_q(Q[None], S[None], T[None], R[None], valid[None],
                            _single_leaf(Q.shape[-1], q_block))
    return g[0], w[0]


def _plain_q(Q, S, T, R, valid, q_block):
    g, w = ref.fused_wavg_q(Q[None], S[None], T[None], R[None],
                            valid[None], _single_leaf(Q.shape[-1], q_block))
    return g[0], w[0]


def _max_abs(a, b) -> float:
    return float(torch.max(torch.abs(a - b)))


# ---------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------
def gate_correctness(m: int = 6, n: int = 262_144, device="cpu",
                     G=None, meta=None) -> dict:
    """The share step (kernel on the card, plain on the host) vs the
    multi-op oracle, fp32 + int8 planes; on the card each kernel also
    bitwise against its plain version."""
    G, T, R, valid = _inputs(m, n, 0, device, G, meta)
    want_g, want_w = _legacy(G, T, R, valid)
    got_g, got_w = _fused(G, T, R, valid)
    err_fp32 = _max_abs(got_g, want_g)
    err_w = float(torch.abs(got_w - want_w))

    Q, S = _quantize(G, 512)
    oq_g, oq_w = _plain_q(Q, S, T, R, valid, 512)
    kq_g, kq_w = _fused_q(Q, S, T, R, valid, 512)
    err_q = _max_abs(kq_g, oq_g)
    err_qw = float(torch.abs(kq_w - oq_w))
    tol = 2e-5
    out = {"tol": tol, "fp32_max_err": err_fp32,
           "quant_kernel_vs_oracle_max_err": err_q,
           "wsum_err": max(err_w, err_qw)}
    ok = max(err_fp32, err_q) <= tol and max(err_w, err_qw) <= 1e-6
    if G.is_cuda:
        pg, pw = ref.fused_wavg(*_one(G, T, R, valid))
        out["kernel_vs_plain_bitwise"] = bool(
            torch.equal(got_g, pg[0]) and torch.equal(got_w, pw[0])
            and torch.equal(kq_g, oq_g) and torch.equal(kq_w, oq_w))
        ok = ok and out["kernel_vs_plain_bitwise"]
    return {"pass": bool(ok), **out,
            "detail": "share step vs multi-op oracle, fp32 + int8 "
                      "planes" + ("; kernels bitwise their plain "
                                  "versions" if G.is_cuda else "")}


def gate_bitwise(m: int = 6, n: int = 262_144, device="cpu",
                 G=None, meta=None) -> dict:
    """The plain fused step must be bit-identical to the multi-op path
    at quant-off, on flat rows and on a tree through its layout; on the
    card the kernel too."""
    G, T, R, valid = _inputs(m, n, 1, device, G, meta)
    want_g, want_w = _legacy(G, T, R, valid)
    pg, pw = ref.fused_wavg(*_one(G, T, R, valid))
    flat_ok = bool(torch.equal(pg[0], want_g) and torch.equal(pw[0], want_w))

    tree = {"emb": G[:, :65_536].reshape(m, 512, 128),
            "head": G[:, 65_536:65_543]}          # a small leaf too
    layout = PlaneLayout.from_tree(tree, lead=1)
    want_t, want_tw = (tree_weighted_sum(tree, eq4_weights(T, R, valid)),
                       want_w)
    rows = layout.flatten(tree)                    # (m, P) in tree order
    tg, tw = ref.fused_wavg(*_one(rows, T, R, valid))
    got_t = layout.unflatten(tg[0])
    tree_ok = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_paths(got_t), tree_leaves_with_paths(want_t)))
    tree_ok = tree_ok and bool(torch.equal(tw[0], want_tw))
    out = {"flat_bitwise": flat_ok, "tree_bitwise": tree_ok}
    ok = flat_ok and tree_ok
    if G.is_cuda:
        kg, kw = _fused(G, T, R, valid)
        kt, ktw = ops.fused_wavg(*_one(rows, T, R, valid))
        out["kernel_bitwise"] = bool(
            torch.equal(kg, want_g) and torch.equal(kw, want_w)
            and torch.equal(kt, tg) and torch.equal(ktw, tw))
        ok = ok and out["kernel_bitwise"]
    return {"pass": bool(ok), **out,
            "detail": "plain fused (and the kernel on the card) vs "
                      "eq4_weights + tree_weighted_sum"}


def plain_q_peak_bytes(m: int, n: int, q_block: int = 512) -> int:
    """Peak live bytes above its inputs of the int8 plain share step at
    (1, m, n), counted by ``StepCounter`` on ``meta`` tensors (nothing
    allocated)."""
    from repro_torch.roofline.trace import StepCounter
    blocks = _single_leaf(n, q_block)
    blocks.on("meta")                  # the layout's index maps: inputs
    Q = torch.empty((1, m, n), dtype=torch.int8, device="meta")
    S = torch.empty((1, m, blocks.n_blocks), device="meta")
    T = torch.empty((1, m), device="meta")
    R = torch.empty((1, m), device="meta")
    valid = torch.empty((1, m), dtype=torch.bool, device="meta")
    with StepCounter() as counter:
        out = ref.fused_wavg_q(Q, S, T, R, valid, blocks)
        del out
    return counter.peak


def gate_one_pass(m: int = 8, n: int = 1_048_576, device="cpu") -> dict:
    """One launch per share step (card), and the int8 step's peak above
    its inputs ≤ ½ of a full fp32 dequant of the stack: the kernel's
    ``max_memory_allocated`` on the card, the plain version's counted
    peak on the host."""
    full_dequant = m * n * 4               # what a naive path builds
    qb = 512
    plain_peak = plain_q_peak_bytes(m, n, qb)
    out = {"full_dequant_mb": full_dequant / 2**20,
           "plain_quant_peak_mb": plain_peak / 2**20}
    if torch.device(device).type == "cuda":
        G = torch.zeros((m, n), dtype=torch.float32, device=device)
        T, R, valid = _meta(m, 0, device)
        Q, S = _quantize(G, qb)
        _fused_q(Q, S, T, R, valid, qb)  # warm-up: the layout's index
        synchronize(device)              # maps are uploaded once (inputs)
        before = (ops.fused_wavg.launches, ops.fused_wavg_q.launches)
        _fused(G, T, R, valid)
        synchronize(device)
        torch.cuda.empty_cache()         # fresh segments (as the sketch
        base = torch.cuda.memory_allocated(device)   # bench's peak_bytes)
        torch.cuda.reset_peak_memory_stats(device)
        _fused_q(Q, S, T, R, valid, qb)
        synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
        calls = (ops.fused_wavg.launches - before[0],
                 ops.fused_wavg_q.launches - before[1])
        out.update(launches_fp32=calls[0], launches_int8=calls[1],
                   card_quant_peak_mb=peak / 2**20)
        ok = calls == (1, 1) and peak <= 0.5 * full_dequant
        detail = ("1 launch per share step (fp32 and int8); the int8 "
                  "kernel's max_memory_allocated above its inputs < ½ of "
                  "a full fp32 dequant")
    else:
        ok = plain_peak <= 0.5 * full_dequant
        detail = ("the int8 plain version's counted peak above its "
                  "inputs < ½ of a full fp32 dequant (no kernel runs on "
                  "the host)")
    return {"pass": bool(ok), **out, "detail": detail}


def gate_quant_error(m: int = 8, n: int = 1_000_000, device="cpu",
                     G=None, meta=None) -> dict:
    """int8 eq. 4 vs fp32 eq. 4, per supported block size: the analytic
    ∞-bound (weights are convex, so error ≤ ½·max scale) and the pinned
    relative-L2 tolerance."""
    G, T, R, valid = _inputs(m, n, 2, device, G, meta)
    g32, _ = _legacy(G, T, R, valid)
    ok = True
    per_block = {}
    for qb in Q_BLOCKS:
        Q, S = _quantize(G, qb)
        gq, _ = _fused_q(Q, S, T, R, valid, qb)
        inf_err = _max_abs(gq, g32)
        inf_bound = float(torch.max(S)) / 2.0 + 1e-7
        rel = float(torch.linalg.vector_norm(gq - g32)
                    / torch.linalg.vector_norm(g32))
        per_block[qb] = {"inf_err": inf_err, "inf_bound": inf_bound,
                         "rel_l2": rel}
        ok &= inf_err <= inf_bound and rel <= REL_L2_BOUND
    return {"pass": bool(ok), "rel_l2_bound": REL_L2_BOUND,
            "per_block": per_block,
            "detail": "|ḡ_q − ḡ|∞ ≤ ½·max(scale) and rel-L2 ≤ bound"}


def gate_bytes(qb: int = 512) -> dict:
    """Structure-level accounting: the int8 delay line ≥ 3.5× lighter
    (built on ``meta``: nothing allocated), and the analytic cross-pod
    accounting agrees."""
    from repro_torch.core.knowledge import make_sparse_inflight
    from repro_torch.core.pod_dispatch import _edge_cost
    from repro_torch.core.topology import full

    params_like = {"w": torch.empty((1024, 256), device="meta"),
                   "b": torch.empty((1024,), device="meta")}
    layout = PlaneLayout.from_tree(params_like)
    topo = full(8)
    n, k = topo.n_agents, topo.degree

    def nbytes(*xs) -> int:
        return sum(x.numel() * x.element_size() for x in xs)

    fp = make_sparse_inflight(n, k, 2, layout.size, "meta")
    q8 = make_sparse_inflight(n, k, 2, layout.size, "meta",
                              layout.blocks(qb))
    # the payload planes (grads + scales); T / R / valid are the same
    fp_b = nbytes(fp.grads)
    q8_b = nbytes(q8.grads, q8.scale)
    ratio = fp_b / q8_b

    n_params = 10_000_000
    pod_ratio = (_edge_cost(n_params, 4)
                 / _edge_cost(n_params, 4, quant_block=qb))
    return {"pass": bool(ratio >= 3.5 and pod_ratio >= 3.5),
            "delay_line_ratio": ratio, "cross_pod_ratio": pod_ratio,
            "fp32_mb": fp_b / 2**20, "int8_mb": q8_b / 2**20,
            "detail": "int8 planes ≥ 3.5× lighter, structure + "
                      "analytic accounting"}


# ---------------------------------------------------------------------
# roofline record and sweep (H100 bounds; card times on the card)
# ---------------------------------------------------------------------
def bounds_us(m: int, n: int, q_block: int = 512) -> dict:
    """The least time at the H100's memory rate of the fused fp32 and
    int8 share steps (each input read once, ḡ written once) and of the
    unfused multi-op path (the stack read, the accumulator re-read and
    re-written per piece)."""
    fused = 4.0 * n * (m + 1) + 12.0 * m
    fused_q = 1.0 * n * m + 4.0 * (-(-n // q_block)) * m + 4.0 * n + 12.0 * m
    unfused = 4.0 * n * 2 * m
    return {"fused_fp32_us": fused / HBM_BW * 1e6,
            "fused_int8_us": fused_q / HBM_BW * 1e6,
            "unfused_fp32_us": unfused / HBM_BW * 1e6}


def _kernel_us(m: int, n: int, device, q_block: int = 512,
               repeats: int = 5):
    """CUDA-event µs of the fused fp32 and int8 kernels at (1, m, n)."""
    G = torch.zeros((m, n), dtype=torch.float32, device=device)
    T, R, valid = _meta(m, 0, device)
    fp = best_ms(lambda: _fused(G, T, R, valid), device, repeats) * 1e3
    Q = torch.zeros((m, n), dtype=torch.int8, device=device)
    S = torch.zeros((m, -(-n // q_block)), dtype=torch.float32,
                    device=device)
    del G
    q8 = best_ms(lambda: _fused_q(Q, S, T, R, valid, q_block), device,
                 repeats) * 1e3
    return fp, q8


def roofline_record(m: int = 8, n: int = 10_000_000, device="cpu") -> dict:
    """The fused share step's ``Roofline`` record: the bytes its plain
    version accesses and its matmul FLOPs, counted on ``meta``
    (``roofline.trace.traced``), the H100 bounds beside them, and the
    kernels' card times on the card (the plain version's host time on
    the host)."""
    from repro_torch.roofline.report import Roofline
    from repro_torch.roofline.trace import traced
    with traced() as tr:
        G = torch.empty((1, m, n), device="meta")
        T = torch.empty((1, m), device="meta")
        R = torch.empty((1, m), device="meta")
        valid = torch.empty((1, m), dtype=torch.bool, device="meta")
        ref.fused_wavg(G, T, R, valid)
    roof = Roofline(
        arch="ddal_wavg_fused", shape=f"m{m}_n{n}",
        mesh=torch.device(device).type, chips=1,
        hlo_flops=float(tr.flops),
        hlo_bytes=float(tr.counter.bytes_accessed),
        coll_bytes=0.0, coll_breakdown={},        # single-device op
        model_flops=2.0 * m * n)
    rec = roof.to_dict()
    rec["h100_bound"] = bounds_us(m, n)
    if torch.device(device).type == "cuda":
        fp, q8 = _kernel_us(m, n, device)
        rec["card_kernel"] = {"fused_fp32_us": fp, "fused_int8_us": q8}
    else:
        Gh = torch.zeros((m, n), dtype=torch.float32)
        Th, Rh, vh = _meta(m)
        rec["host_plain"] = {"fused_fp32_ms": wall_s(
            lambda: _fused(Gh, Th, Rh, vh), "cpu") * 1e3}
    return rec


def sweep_rows(smoke: bool, device="cpu") -> list:
    rows = []
    for m, n_params in (SMOKE_SIZES if smoke else SIZES):
        b = bounds_us(m, n_params)
        row = {
            "m": m, "n_params": n_params,
            "h100_bound_fused_us": b["fused_fp32_us"],
            "h100_bound_fused_int8_us": b["fused_int8_us"],
            "h100_bound_unfused_us": b["unfused_fp32_us"],
            "traffic_saving": b["unfused_fp32_us"] / b["fused_fp32_us"],
            "traffic_saving_int8":
                b["unfused_fp32_us"] / b["fused_int8_us"],
        }
        if torch.device(device).type == "cuda":
            fp, q8 = _kernel_us(m, n_params, device)
            row.update(card_fused_us=fp, card_fused_int8_us=q8,
                       card_fused_share_of_bound=b["fused_fp32_us"] / fp,
                       card_int8_share_of_bound=b["fused_int8_us"] / q8)
        else:
            G = torch.zeros((m, n_params), dtype=torch.float32)
            T, R, valid = _meta(m)
            _fused(G, T, R, valid)
            row["host_plain_fused_ms"] = wall_s(
                lambda: _fused(G, T, R, valid), "cpu") * 1e3
        rows.append(row)
    return rows


def main(argv=None, verbose: bool = True):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="CI fast path: reduced sizes only")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=_DEFAULT_JSON,
                   help="machine-readable results path")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    gates = {
        "correctness": gate_correctness(device=dev),
        "bitwise": gate_bitwise(device=dev),
        "one_pass": gate_one_pass(device=dev),
        "quant_error": gate_quant_error(device=dev),
        "bytes": gate_bytes(),
    }
    roof = roofline_record(*(SMOKE_SIZES[-1] if args.smoke
                             else SIZES[1]), device=dev)
    rows = sweep_rows(args.smoke, dev)
    card = dev.type == "cuda"

    if verbose:
        for name, g in gates.items():
            print(f"gate {name}: {'PASS' if g['pass'] else 'FAIL'} "
                  f"({ {k: v for k, v in g.items() if k != 'pass'} })")
        b = roof["h100_bound"]
        timed = (f"card fused fp32 {roof['card_kernel']['fused_fp32_us']:.1f}"
                 f"µs / int8 {roof['card_kernel']['fused_int8_us']:.1f}µs"
                 if card else
                 f"host plain fused fp32 "
                 f"{roof['host_plain']['fused_fp32_ms']:.1f}ms")
        print(f"\nroofline ({roof['arch']}, {roof['shape']}, on "
              f"{roof['mesh']}): plain bytes={roof['hlo_bytes']:.3g} "
              f"dominant={roof['dominant']} H100 bound fused fp32 "
              f"{b['fused_fp32_us']:.1f}µs / int8 {b['fused_int8_us']:.1f}µs"
              f"; {timed}")
        last = "card µs" if card else "host ms"
        print(f"\n{'m':>3} {'N':>12} {'bound µs':>9} {'int8 bd':>8} "
              f"{'unfused':>8} {'saving':>7} {'int8 sv':>8} {last:>9}"
              + (f" {'int8 µs':>8}" if card else ""))
        for r in rows:
            t = (f"{r['card_fused_us']:9.1f} {r['card_fused_int8_us']:8.1f}"
                 if card else f"{r['host_plain_fused_ms']:9.2f}")
            print(f"{r['m']:3d} {r['n_params']:12,} "
                  f"{r['h100_bound_fused_us']:9.1f} "
                  f"{r['h100_bound_fused_int8_us']:8.1f} "
                  f"{r['h100_bound_unfused_us']:8.1f} "
                  f"{r['traffic_saving']:6.2f}x "
                  f"{r['traffic_saving_int8']:7.2f}x {t}")

    payload = {"bench": "wavg_kernel", **device_info(dev),
               "gates": gates, "roofline": roof, "rows": rows}
    write_json(args.json, payload)

    if not all(g["pass"] for g in gates.values()):
        raise SystemExit("wavg kernel gate FAILED")
    return payload


if __name__ == "__main__":
    main()
