#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    PYTHONPATH=src python3 chip_smoke.py        # src/ is also found alone

Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build every CUDA kernel of the main path from the sources in this
   checkout (one ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path and at edge cases, with its time beside the
   plain version's, a one-call PyTorch yardstick's and the least time
   the card could take: the fp32 eq. 4 share step (both entries), the
   gradient sketch (signs through the kernel bitwise, sketches within
   their gate, two launches bitwise equal) and the int8 share step
   (bitwise);
4. the main path, through the entry points a user calls: DDA3C groups
   at the paper's width (A2C, hidden 64, CartPole-v0) trained for a few
   hundred epochs, the fourth with learned sketched relevance and int8
   knowledge planes, each run with the kernels' launch counts zeroed
   just before it and read just after;
5. the card against the port's CPU path on small groups with seeded
   gradients, fp32 and int8 + learned relevance;
6. a profile of a few main-path epochs of the quickstart group and of
   the fourth run's configuration: the device's busy share, the ops
   that take the time and the host-clock split of an epoch.

It prints one JSON line of per-kernel numbers (``launches`` is the
count of the first path that drives the kernel, ``launches_by_path``
each such path's own count) and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero, as
does a machine with no CUDA card.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM fp32 outside the tensor cores
G_TOL = dict(rtol=2e-5, atol=2e-5)     # ḡ, as the Pallas kernel is held
W_RTOL = 1e-6                          # Σw
EPOCHS = 300                           # of each main-path run

SKETCH_DIM, QUANT_BLOCK = 256, 128      # the fourth main-path run's
SOURCES = ("ddal_wavg", "grad_sketch")

KERNELS = {
    "ddal_fused_wavg": dict(
        route="cuda",
        source="src/repro_torch/kernels/ddal_wavg/csrc/ddal_wavg.cu",
        replaces="src/repro/kernels/ddal_wavg/kernel.py:164"),
    "ddal_wavg": dict(
        route="cuda",
        source="src/repro_torch/kernels/ddal_wavg/csrc/ddal_wavg.cu",
        replaces="src/repro/kernels/ddal_wavg/kernel.py:58"),
    "ddal_fused_wavg_q": dict(
        route="cuda",
        source="src/repro_torch/kernels/ddal_wavg/csrc/ddal_wavg.cu",
        replaces="src/repro/kernels/ddal_wavg/kernel.py:185"),
    "grad_sketch": dict(
        route="cuda",
        source="src/repro_torch/kernels/grad_sketch/csrc/grad_sketch.cu",
        replaces="src/repro/kernels/grad_sketch/kernel.py:116"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"devices {torch.cuda.device_count()} "
          f"name {torch.cuda.get_device_name(0)} "
          f"matmul_precision {torch.get_float32_matmul_precision()}")
    return card


def build_phase():
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(cuda_build.load, SOURCES)))
    secs = time.perf_counter() - t0
    for name in SOURCES:
        src = cuda_build.source_of(name).relative_to(ROOT)
        print(f"[build] {src} -> "
              f"{cuda_build.BUILD_DIR.relative_to(ROOT)}/{name}.so")
        for ln in libs[name][1].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"[build]   ptxas {ln.strip()}")
    print(f"[build] {len(SOURCES)} sources built in parallel and loaded "
          f"in {secs:.2f} s")
    return secs


def time_ms(torch, fn, iters):
    """(device ms, host ms) of one call. The device time comes from
    CUDA events around ``iters`` back-to-back calls that the host
    queued while the card was held busy by a spin kernel, so it is the
    card's time and not the host's launch rate; the host time is the
    wall time of queueing one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin 1.5× the queueing time at 2 GHz (the card's clock is at most
    # 1.98 GHz, so the spin lasts at least that long)
    torch.cuda._sleep(int(host_s * iters * 1.5 * 2e9) + 1_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3


def bound(n, m, p, fused):
    """Least time (ms) for the same work: each input read once, each
    output written once, over the HBM rate; and 2·n·m·P fp32 operations
    over the fp32 peak. The larger of the two, and which one it is."""
    meta = n * m * (4 + 4 + 1) if fused else n * m * 4
    out = n * p * 4 + (n * 4 if fused else 0)
    bytes_ms = (n * m * p * 4 + meta + out) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * m * p / FP32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def make_case(torch, n, m, p, seed, invalid="some"):
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn((n, m, p), generator=g, device="cuda")
    T = torch.rand((n, m), generator=g, device="cuda") * 100 + 1
    R = torch.rand((n, m), generator=g, device="cuda") + 0.1
    if invalid == "none":
        valid = torch.ones((n, m), dtype=torch.bool, device="cuda")
    elif invalid == "all":
        valid = torch.zeros((n, m), dtype=torch.bool, device="cuda")
    else:
        valid = torch.rand((n, m), generator=g, device="cuda") > 0.3
    return G, T, R, valid


def errors(torch, got, want):
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    return float(diff.max()), float(rel.max())


def kernel_phase(torch):
    """Kernel vs plain at the main path's share-step shapes and at edge
    cases; returns the per-kernel numbers of the first shape."""
    from repro_torch.kernels.ddal_wavg import ops, ref
    cases = [("quickstart share step", 2, 32, 9155, "none"),
             ("ring n=8 share step", 8, 32, 9155, "some"),
             ("big ragged plane", 16, 8, 2 ** 20 + 37, "some"),
             ("single element", 1, 1, 1, "none"),
             ("some pieces invalid", 3, 32, 9155, "some"),
             ("every piece invalid", 2, 32, 9155, "all")]
    table = {}
    for label, n, m, p, invalid in cases:
        G, T, R, valid = make_case(torch, n, m, p, seed=n * 31 + m,
                                   invalid=invalid)
        got_g, got_w = ops.fused_wavg(G, T, R, valid)
        want_g, want_w = ref.fused_wavg(G, T, R, valid)
        w = ref.eq4_weights(T, R, valid)
        got_u = ops.wavg(G, w)
        want_u = ref.wavg(G, w)
        torch.cuda.synchronize()
        errs = {"ddal_fused_wavg": errors(torch, got_g, want_g),
                "ddal_wavg": errors(torch, got_u, want_u)}
        w_err = float(((got_w - want_w).abs()
                       / want_w.abs().clamp_min(1e-30)).max())
        ok = (torch.allclose(got_g, want_g, **G_TOL)
              and torch.allclose(got_u, want_u, **G_TOL)
              and torch.allclose(got_w, want_w, rtol=W_RTOL, atol=0.0))
        if invalid == "all":
            ok = ok and not bool(got_g.any()) and not bool(got_w.any())
        print(f"[kernel] {label} (n, m, P) = ({n}, {m}, {p}): "
              f"fused max abs {errs['ddal_fused_wavg'][0]:.3e} "
              f"rel {errs['ddal_fused_wavg'][1]:.3e}, Σw rel {w_err:.3e}; "
              f"wavg max abs {errs['ddal_wavg'][0]:.3e} "
              f"rel {errs['ddal_wavg'][1]:.3e}; tolerance ḡ rtol=atol=2e-5, "
              f"Σw rtol 1e-6 -> {'ok' if ok else 'FAIL'}")
        check(ok, f"kernel disagrees with its plain version: {label}")
        iters = 200 if n * m * p < 1e8 else 20
        rows = {
            "ddal_fused_wavg": (
                lambda: ops.fused_wavg(G, T, R, valid),
                lambda: ref.fused_wavg(G, T, R, valid), True),
            "ddal_wavg": (lambda: ops.wavg(G, w),
                          lambda: ref.wavg(G, w), False),
        }
        lib_ms, lib_host = time_ms(
            torch, lambda: torch.einsum("nm,nmp->np", w, G), iters)
        for name, (kern, plain, fused) in rows.items():
            ms, host = time_ms(torch, kern, iters)
            plain_ms, plain_host = time_ms(torch, plain,
                                           max(iters // 10, 5))
            b_ms, b_by = bound(n, m, p, fused)
            print(f"[kernel] {label} {name}: device {ms:.5f} ms "
                  f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, "
                  f"{b_by}), plain {plain_ms:.5f} ms, einsum "
                  f"{lib_ms:.5f} ms; host per call: kernel {host:.5f} "
                  f"ms, plain {plain_host:.5f} ms, einsum "
                  f"{lib_host:.5f} ms")
            if label == "quickstart share step":
                table[name] = dict(max_abs_err=errs[name][0], ms=ms,
                                   plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=lib_ms)
    return table


def _a2c_layout(torch):
    """The paper's A2C (hidden 64) leaf table: P = 9155 in 12 leaves."""
    from repro_torch.common.pytree import PlaneLayout
    from repro_torch.rl import networks
    tree = networks.init_policy_value(torch.Generator().manual_seed(0), 1,
                                      4, 2, 64)
    return PlaneLayout.from_tree(tree, lead=1)


def sketch_phase(torch):
    """The gradient-sketch kernel against its plain version: signs
    through the kernel (one-hot rows of G give exact rows of S) bitwise,
    sketches within |got − want| ≤ 1e-5·Σ_p |G[r, p]| (and the
    reference's own rtol 1e-4 / atol 1e-3 at its test shapes), two
    launches bitwise equal. Returns the numbers at the main path's
    shape (8, 9155, 256)."""
    from repro_torch.core.relevance import fold_seed
    from repro_torch.kernels.grad_sketch import ops, ref

    p = 9155
    pos = [0, 1, 255, 256, 8191, p - 1]
    G = torch.zeros((len(pos), p), device="cuda")
    G[torch.arange(len(pos)), torch.tensor(pos)] = 1.0
    for offset in (0, 2 ** 31 - 3, 2 ** 32 - 4000):
        for d in (SKETCH_DIM, 100):
            got = ops.sketch_flat(G, 12345, d, offset=offset)
            want = torch.cat([ref.sign_block(12345, offset + q, 1, d, "cuda")
                              for q in pos])
            check(torch.equal(got, want),
                  f"sketch kernel signs differ at offset {offset}, d {d}")
    print(f"[kernel] grad_sketch signs through the kernel at positions "
          f"{pos} + offsets 0, 2^31-3, 2^32-4000 (wrapping), d 256 and "
          f"100: bitwise -> ok")

    seed = fold_seed(0, 100)
    cases = [("main path: n=8 agents' rows", 8, p, SKETCH_DIM, 0, seed,
              False),
             ("reference test shape", 8, 1024, 128, 11, 7, True),
             ("reference test shape", 3, 4097, 256, 11, 7, True),
             ("reference test shape", 8, 1000, 128, 11, 7, True),
             ("reference test shape", 16, 2048, 384, 11, 7, True),
             ("unaligned width", 8, p, 100, 0, seed, False),
             ("LLM-scale plane", 16, 2 ** 22 + 37, SKETCH_DIM, 0, seed,
              False)]
    row = {}
    for label, n, p_, d, offset, sd, ref_gate in cases:
        g = torch.Generator(device="cuda").manual_seed(n * 7 + d)
        G = torch.randn((n, p_), generator=g, device="cuda")
        got = ops.sketch_flat(G, sd, d, offset=offset)
        again = ops.sketch_flat(G, sd, d, offset=offset)
        want = ref.sketch_flat(G, sd, d, offset=offset)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        gate = 1e-5 * G.abs().sum(dim=1, keepdim=True)
        ok = bool((diff <= gate).all()) and torch.equal(got, again)
        if ref_gate:
            ok = ok and torch.allclose(got, want, rtol=1e-4, atol=1e-3)
        err = float(diff.max())
        print(f"[kernel] grad_sketch {label} (n, P, d) = ({n}, {p_}, {d}), "
              f"offset {offset}: max abs {err:.3e}, worst share of the "
              f"1e-5·Σ|G| gate {float((diff / gate).max()):.3f}"
              f"{', reference gate rtol 1e-4 atol 1e-3' if ref_gate else ''}"
              f", two launches bitwise {torch.equal(got, again)} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"sketch kernel disagrees with its plain version: {label}")
        big = n * p_ > 1e7
        iters = 20 if big else 200
        ms, host = time_ms(
            torch, lambda: ops.sketch_flat(G, sd, d, offset=offset), iters)
        plain_ms, plain_host = time_ms(
            torch, lambda: ref.sketch_flat(G, sd, d, offset=offset),
            3 if big else 20)
        S = ref.sign_block(sd, offset, p_, d, "cuda")  # outside the timing
        lib_ms, lib_host = time_ms(torch, lambda: torch.matmul(G, S), iters)
        del S
        bytes_ms = (4 * n * p_ + 4 * n * d) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * p_ * d / FP32_FLOP_PER_S * 1e3
        b_ms, b_by = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                      else (ops_ms, "operations"))
        print(f"[kernel] grad_sketch {label}: device {ms:.5f} ms "
              f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, {b_by}: "
              f"2·n·P·d fp32 flops at 67 TFLOP/s vs 4·n·P bytes at "
              f"3.35 TB/s; the hash work is not in it), plain "
              f"{plain_ms:.5f} ms, torch.matmul(G, S) with S built "
              f"outside the timing (not the same function: S is read, "
              f"not regenerated) {lib_ms:.5f} ms; host per call: kernel "
              f"{host:.5f} ms, plain {plain_host:.5f} ms, matmul "
              f"{lib_host:.5f} ms")
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    return row


def wavg_q_phase(torch):
    """The int8 share-step kernel against its plain version, bitwise for
    ḡ and Σw. Returns the numbers at the main path's shape: n = 8 stores
    of 32 pieces over the A2C's blocks at q_block 128."""
    from repro_torch.common.pytree import PlaneLayout
    from repro_torch.kernels.ddal_wavg import ops, ref

    a2c = _a2c_layout(torch)
    ragged = PlaneLayout(None, [()], [(2 ** 20 + 37,)])
    cases = [("main path: n=8 ring share step, q_block 128", a2c, 8, 32,
              128, "some"),
             ("q_block 1024", a2c, 8, 32, 1024, "some"),
             ("every piece invalid", a2c, 8, 32, 128, "all"),
             ("big ragged plane, q_block 128", ragged, 16, 8, 128, "some")]
    row = {}
    for label, layout, n, m, qb, invalid in cases:
        G, T, R, valid = make_case(torch, n, m, layout.size, seed=n + qb,
                                   invalid=invalid)
        blocks = layout.blocks(qb)
        Q, S = ref.quantize_flat(G, blocks)
        del G
        got_g, got_w = ops.fused_wavg_q(Q, S, T, R, valid, blocks)
        want_g, want_w = ref.fused_wavg_q(Q, S, T, R, valid, blocks)
        torch.cuda.synchronize()
        ok = torch.equal(got_g, want_g) and torch.equal(got_w, want_w)
        if invalid == "all":
            ok = ok and not bool(got_g.any()) and not bool(got_w.any())
        err = float((got_g - want_g).abs().max())
        print(f"[kernel] ddal_fused_wavg_q {label} (n, m, P) = ({n}, {m}, "
              f"{layout.size}), {blocks.n_blocks} scale columns: max abs "
              f"{err:.3e}, ḡ and Σw bitwise {ok} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"int8 kernel disagrees with its plain version: {label}")
        big = n * m * layout.size > 1e8
        iters = 20 if big else 200
        w = ref.eq4_weights(T, R, valid)
        deq = ref.dequantize_flat(Q, S, blocks)        # outside the timing
        ms, host = time_ms(
            torch, lambda: ops.fused_wavg_q(Q, S, T, R, valid, blocks), iters)
        plain_ms, plain_host = time_ms(
            torch, lambda: ref.fused_wavg_q(Q, S, T, R, valid, blocks),
            max(iters // 10, 5))
        lib_ms, lib_host = time_ms(
            torch, lambda: torch.einsum("nm,nmp->np", w, deq), iters)
        del deq
        nb = blocks.n_blocks
        b_ms = ((n * m * layout.size + n * m * nb * 4 + n * layout.size * 4
                 + n * m * 9 + n * 4) / HBM_BYTES_PER_S * 1e3)
        print(f"[kernel] ddal_fused_wavg_q {label}: device {ms:.5f} ms "
              f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, bytes: "
              f"n·m·P int8 + n·m·nb·4 scales + n·P·4 out + metadata at "
              f"3.35 TB/s), plain {plain_ms:.5f} ms, torch.einsum over "
              f"planes dequantised outside the timing (no single torch "
              f"call dequantises and reduces) {lib_ms:.5f} ms; host per "
              f"call: kernel {host:.5f} ms, plain {plain_host:.5f} ms, "
              f"einsum {lib_host:.5f} ms")
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by="bytes", library_ms=lib_ms)
    return row


def _mean(x):
    return float(x.float().mean()) if x.numel() else float("nan")


SLICE2_SPEC = dict(relevance_mode="grad_cos", relevance_ema=0.9,
                   relevance_sketch_dim=SKETCH_DIM,
                   knowledge_quant_block=QUANT_BLOCK)


def main_path_phase(torch, epochs=EPOCHS):
    """The DDA3C main path at the paper's width, through the entry
    points a user calls. Each path's launch counts are zeroed just
    before its run and read just after; returns {kernel: {path:
    launches}} over the paths that drive each kernel."""
    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.ddal import DDAL
    from repro_torch.kernels.ddal_wavg import ops
    from repro_torch.kernels.grad_sketch import ops as sketch_ops
    from repro_torch.rl.a2c import init_a2c, make_a2c_callbacks, \
        make_a2c_group
    from repro_torch.rl.envs import CartPole

    env = CartPole()
    ring = dict(n_agents=8, threshold=epochs // 3, minibatch=50,
                m_pieces=32, topology="ring", exchange_delay="uniform",
                max_delay=2)
    runs = [
        ("n=2 full", GroupSpec(
            n_agents=2, threshold=epochs // 3, minibatch=50, m_pieces=32,
            topology="full"), epochs, False),
        ("n=8 ring, uniform delay 2", GroupSpec(**ring), epochs, False),
        ("n=2 full, legacy wavg", GroupSpec(
            n_agents=2, threshold=epochs // 6, minibatch=25, m_pieces=32,
            topology="full"), epochs // 2, True),
        ("n=8 ring, uniform delay 2, sketch 256, int8 128",
         GroupSpec(**ring, **SLICE2_SPEC), epochs, False),
    ]
    by_path = {name: {} for name in KERNELS}
    for label, spec, n_epochs, legacy in runs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        opt = optim.adamw(3e-3)
        if legacy:
            astates, layout = init_a2c(gen, spec.n_agents, env, opt)
            cbs = make_a2c_callbacks(env, opt, layout)
            ddal = DDAL(spec, *cbs, use_wavg_kernel=True)
            gs = ddal.init(astates)
        else:
            ddal, gs = make_a2c_group(env, opt, spec, gen)
        torch.cuda.synchronize()
        ops.reset_launches()
        sketch_ops.reset_launches()
        t0 = time.perf_counter()
        gs, metrics = ddal.run(gs, gen, n_epochs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {"ddal_fused_wavg": ops.fused_wavg.launches,
                    "ddal_wavg": ops.wavg.launches,
                    "ddal_fused_wavg_q": ops.fused_wavg_q.launches,
                    "grad_sketch": sketch_ops.sketch_flat.launches}
        shares = sum(1 for e in range(spec.threshold, n_epochs)
                     if e % spec.minibatch == 0)
        # the estimator skips warm-up epochs (the reference computes and
        # discards them), so it sketches once per sharing epoch
        sharing = n_epochs - spec.threshold
        ret = metrics["return"]
        params = gs.agent_states.params
        pre, post = ret[:spec.threshold], ret[spec.threshold:]
        print(f"[main] {label}: {n_epochs} epochs in {secs:.2f} s "
              f"({n_epochs / secs:.2f} epochs/s), share steps {shares}, "
              f"sharing epochs {sharing}, launches "
              + ", ".join(f"{k} {v}" for k, v in launched.items())
              + f", mean return {_mean(pre):.2f} before sharing -> "
              f"{_mean(post):.2f} after (last 100: {_mean(ret[-100:]):.2f})"
              f", params {tuple(params.shape)}")
        if legacy:
            want = {"ddal_wavg": shares}
        elif spec.knowledge_quant_block:
            want = {"ddal_fused_wavg_q": shares, "grad_sketch": sharing}
        else:
            want = {"ddal_fused_wavg": shares}
        want = {name: want.get(name, 0) for name in KERNELS}
        check(shares > 0 and launched == want,
              f"{label}: launches {launched} != {want} for {shares} "
              f"share steps and {sharing} sharing epochs")
        check(bool(torch.isfinite(ret).all())
              and bool(torch.isfinite(params).all())
              and params.shape == (spec.n_agents, 9155),
              f"{label}: non-finite returns / params or wrong shape")
        if spec.relevance_sketch_dim:
            rel = gs.relevance
            off = rel[~torch.eye(spec.n_agents, dtype=torch.bool,
                                 device=rel.device)]
            print(f"[main] {label}: learned relevance off the diagonal "
                  f"min {float(off.min()):.4f} max {float(off.max()):.4f}, "
                  f"stores {gs.stores.grads.dtype} with "
                  f"{gs.stores.scale.shape[-1]} scale columns")
            check(bool(torch.isfinite(rel).all())
                  and bool((rel >= 1e-3).all()) and bool((rel <= 1).all())
                  and bool((off < 1).any()),
                  f"{label}: learned relevance not finite, outside "
                  f"[1e-3, 1], or never learned")
        for name, count in want.items():
            if count:
                by_path[name][label] = launched[name]
    return by_path


def equivalence_phase(torch):
    """The card against the port's CPU path on small groups with seeded
    gradients, so both see the same inputs: every delay-line write,
    delivery, kernel share step and AdamW update, with the parameters
    held at rtol 1e-5 (the card's fp32 transcendentals may round
    differently). fp32: stores bitwise. Learned sketched relevance and
    int8 planes: int8 stores and scales bitwise, the relevance (sketch
    kernel on the card, plain projection on the CPU, summed in another
    order) within atol 1e-6."""
    import numpy as np
    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.ddal import DDAL
    from repro_torch.rl.a2c import init_a2c, make_a2c_callbacks
    from repro_torch.rl.envs import CartPole

    base = dict(n_agents=4, threshold=2, minibatch=2, m_pieces=4,
                topology="ring", exchange_delay="uniform", max_delay=1)
    rng = np.random.default_rng(0)
    grads = rng.normal(size=(12, 4, 9155)).astype(np.float32)
    for label, spec in (
            ("ring n=4, delay 1", GroupSpec(**base)),
            ("ring n=4, delay 1, sketch 256, int8 128",
             GroupSpec(**base, **SLICE2_SPEC))):
        results = {}
        for dev in ("cpu", "cuda"):
            opt = optim.adamw(3e-3)
            astates, layout = init_a2c(torch.Generator().manual_seed(0), 4,
                                       CartPole(), opt)
            astates = type(astates)(
                astates.params.to(dev),
                {k: v.to(dev) for k, v in astates.opt_state.items()},
                astates.step.to(dev))
            _, apply_grads, params_of = make_a2c_callbacks(CartPole(), opt,
                                                           layout)
            calls = []

            def gen_grads(state, gen, dev=dev, calls=calls):
                g = torch.from_numpy(grads[len(calls) % 12]).to(dev)
                calls.append(1)
                return g, {"return": g.sum(-1)}, state

            ddal = DDAL(spec, gen_grads, apply_grads, params_of,
                        device=dev, layout=layout)
            gs = ddal.init(astates)
            gs, _ = ddal.run(gs, None, 9)
            results[dev] = [gs.agent_states.params.cpu(),
                            gs.stores.grads.cpu(), gs.relevance.cpu()]
            if spec.knowledge_quant_block:
                results[dev].append(gs.stores.scale.cpu())
        (p_gpu, s_gpu, r_gpu, *sc_gpu), (p_cpu, s_cpu, r_cpu, *sc_cpu) = (
            results["cuda"], results["cpu"])
        err = float((p_gpu - p_cpu).abs().max())
        r_err = float((r_gpu - r_cpu).abs().max())
        stores_eq = torch.equal(s_gpu, s_cpu) and all(
            torch.equal(a, b) for a, b in zip(sc_gpu, sc_cpu))
        ok = (torch.allclose(p_gpu, p_cpu, rtol=1e-5, atol=1e-6)
              and stores_eq and r_err <= 1e-6)
        print(f"[equiv] {label}, 9 epochs, card vs CPU: params max abs "
              f"{err:.3e} (rtol 1e-5), relevance max abs {r_err:.3e} "
              f"(atol 1e-6), stores {s_gpu.dtype} bitwise {stores_eq} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"card and CPU paths disagree on a small group: {label}")


def profile_phase(torch):
    """Device busy share and time by op over a few main-path epochs, for
    the quickstart group and for the fourth main-path run's
    configuration (learned sketched relevance, int8 planes)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.rl.a2c import make_a2c_group
    from repro_torch.rl.envs import CartPole

    configs = [
        ("n=2 full", GroupSpec(n_agents=2, threshold=2, minibatch=2,
                               m_pieces=32)),
        ("n=8 ring, delay 2, sketch 256, int8 128", GroupSpec(
            n_agents=8, threshold=2, minibatch=2, m_pieces=32,
            topology="ring", exchange_delay="uniform", max_delay=2,
            **SLICE2_SPEC)),
    ]
    for label, spec in configs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        ddal, gs = make_a2c_group(CartPole(), optim.adamw(3e-3), spec, gen)
        gs, _ = ddal.run(gs, gen, 4)                   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gs, _ = ddal.run(gs, gen, 6)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            rows.append((ev.key, ev.count, dev_us, ev.cpu_time_total))
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        rows.sort(key=lambda r: -r[2])
        ours = [(r[0][:40], r[1], round(r[2]), round(r[3])) for r in rows
                if "wavg_kernel" in r[0] or "wavg_q_kernel" in r[0]
                or "sketch_" in r[0]]

        def wall_of(fn, reps=10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps

        # host-clock split of an epoch (profiler off): the agents'
        # episode, loss and backward (gen_grads) against the rest
        state = {"gs": gs}

        def epoch():
            state["gs"], _ = ddal.epoch_step(state["gs"], gen)

        epoch_s = wall_of(epoch)
        gen_s = wall_of(lambda: ddal.gen_grads(state["gs"].agent_states,
                                               gen))
        print(f"[profile] {label}, 6 sharing epochs: wall {wall:.3f} s, "
              f"device busy {busy_us / 1e3:.2f} ms "
              f"({busy_us / (wall * 1e6):.1%}), {len(kernels)} device "
              f"kernels; the port's kernels (name, calls, device us, "
              f"host us) {ours}")
        print(f"[profile] {label}: epoch {epoch_s * 1e3:.2f} ms on the "
              f"host clock (profiler off), of which gen_grads (episode + "
              f"loss + backward) {gen_s * 1e3:.2f} ms")
        host_rows = sorted((r for r in rows if r[3] > 0),
                           key=lambda r: -r[3])
        for key, count, dev_us, cpu_us in host_rows[:10]:
            print(f"[profile]   {key[:60]}: {count} calls, device "
                  f"{dev_us:.0f} us, host {cpu_us:.0f} us")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); the port's smoke run needs one", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing next to this "
              f"script ({exc}); run it from a checkout of the repo",
              file=sys.stderr)
        return 1
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    try:
        device_phase(torch)
        build_phase()
        table = kernel_phase(torch)
        table["grad_sketch"] = sketch_phase(torch)
        table["ddal_fused_wavg_q"] = wavg_q_phase(torch)
        launches = main_path_phase(torch)
        equivalence_phase(torch)
        profile_phase(torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    # "launches" is the count of the kernel's first path; every path
    # that drives it, each zeroed just before its run, is listed beside
    for name, row in table.items():
        first = next(iter(launches[name].values()))
        row.update(KERNELS[name], launches=first,
                   launches_by_path=launches[name])
    kernels = [dict(name=name, **{k: table[name][k] for k in (
        "route", "source", "replaces", "launches", "launches_by_path",
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")})
        for name in KERNELS]
    check_finite = all(math.isfinite(k["ms"]) for k in kernels)
    if not check_finite:
        print("chip_smoke: FAILED: non-finite kernel time", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
