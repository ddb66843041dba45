#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    PYTHONPATH=src python3 chip_smoke.py        # src/ is also found alone

Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build every CUDA kernel of the main path from the sources in this
   checkout (one ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths and at edge cases, with its time beside the
   plain version's, a one-call PyTorch yardstick's and the least time
   the card could take: the fp32 eq. 4 share step (both entries), the
   gradient sketch (signs through the kernel bitwise, sketches within
   their gate, two launches bitwise equal), the int8 share step
   (bitwise) and the SSD intra-chunk dual form (within its gate, two
   launches bitwise equal);
4. the main paths, through the entry points a user calls, each run with
   the kernels' launch counts zeroed just before it and read just
   after: DDA3C groups at the paper's width (A2C, hidden 64,
   CartPole-v0) trained for a few hundred epochs, the fourth with
   learned sketched relevance and int8 knowledge planes; then
   (``[serve]``) mamba2-780m at its published widths and depth served
   by ``repro_torch.launch.serve``: 4 requests of up to 1023 prompt
   tokens, prefill and 32 greedy tokens each;
5. the card against the port's CPU path: small DDA3C groups with seeded
   gradients, fp32 and int8 + learned relevance; and the serving path
   at mamba2-780m's widths cut to 2 layers with fp32 compute;
6. a profile of a few main-path epochs of the quickstart group and of
   the fourth run's configuration (the device's busy share, the ops
   that take the time and the host-clock split of an epoch), and of
   one full-width prefill and 4 decode steps.

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
BF16_FLOP_PER_S = 989e12           # H100 SXM bf16 tensor cores, dense
G_TOL = dict(rtol=2e-5, atol=2e-5)     # ḡ, as the Pallas kernel is held
W_RTOL = 1e-6                          # Σw
EPOCHS = 300                           # of each main-path run

SKETCH_DIM, QUANT_BLOCK = 256, 128      # the fourth main-path run's
SOURCES = ("ddal_wavg", "grad_sketch", "ssd_scan")
SSD_GATE = 1e-5        # × Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp|, per element
# the serving path: mamba2-780m at its published widths and depth
SERVE_ARGV = ["--arch", "mamba2-780m", "--full", "--serve", "engine=batch",
              "--serve", "slots=2", "--requests", "4", "--prompt-len",
              "1024", "--serve", "max_new_tokens=32"]
SERVE_LABEL = "[serve] mamba2-780m"

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
    "ssd_intra_chunk": dict(
        route="cuda",
        source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:48"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def _counted():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from repro_torch.kernels.ddal_wavg import ops
    from repro_torch.kernels.grad_sketch import ops as sketch_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"ddal_fused_wavg": ops.fused_wavg, "ddal_wavg": ops.wavg,
            "ddal_fused_wavg_q": ops.fused_wavg_q,
            "grad_sketch": sketch_ops.sketch_flat,
            "ssd_intra_chunk": ssd_ops.ssd_intra_chunk}


def reset_launches():
    for fn in _counted().values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in _counted().items()}


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


def _ssd_case(torch, seed, b, nc, l, h, p, n, g, dtype, pad=0):
    """Chunked SSD inputs on the card, drawn as the reference's kernel
    test draws them (x, B, C normal, dt = softplus(normal), A =
    −exp(normal), cs the cumsum of dt·A); x, B, C in ``dtype``. The
    last ``pad`` steps of every chunk are ``ssd_chunked``'s padding:
    dt = 0 and x, B, C zero."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xc, dtc = normal(b, nc, l, h, p), torch.nn.functional.softplus(
        normal(b, nc, l, h))
    A = -torch.exp(normal(h))
    Bc, Cc = normal(b, nc, l, g, n), normal(b, nc, l, g, n)
    if pad:
        for t in (xc, dtc, Bc, Cc):
            t[:, :, l - pad:] = 0
    cs = torch.cumsum(dtc * A, dim=2)
    return [xc.to(dtype), dtc, cs, Bc.to(dtype), Cc.to(dtype)]


def ssd_bound(bn, l, h, p, n, g, esize):
    """Least time (ms), the larger of operations and bytes, and which
    one it is. Over the l(l+1)/2 causal (i, j) pairs of a chunk: the
    score C_i·B_j, 2n operations once per (chunk, group), since B and C
    are shared by the heads of a group; per (chunk, head) the decay
    exp(cs_i − cs_j) and its product with the score (3) and the product
    with x_j (2p), plus l·p to fold dt_j into x_j. With bf16 B and C the
    score runs at the bf16 tensor-core rate (bf16 products are exact in
    fp32, and the sums stay fp32), with fp32 ones at the fp32 rate (tf32
    would round them); the rest is fp32 at the fp32 rate, since S·x
    takes fp32 scores. Bytes: each input read once, the fp32 output
    written once, at the HBM rate."""
    pairs = l * (l + 1) // 2
    score = bn * g * pairs * 2 * n
    rest = bn * h * (pairs * (3 + 2 * p) + l * p)
    score_rate = BF16_FLOP_PER_S if esize == 2 else FP32_FLOP_PER_S
    nbytes = (bn * l * h * p * esize + 2 * bn * l * g * n * esize
              + 2 * bn * l * h * 4 + bn * l * h * p * 4)
    ops_ms = (score / score_rate + rest / FP32_FLOP_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def ssd_kernel_phase(torch):
    """The SSD intra-chunk kernel against its plain version: the
    reference's three test shapes within its rtol = atol = 2e-5; the
    main path's shape in fp32 and bf16, ragged shapes and a dt = 0
    padded chunk within SSD_GATE · Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp|
    per element (the plain version on |x|, |B|, |C|: the sum of the
    absolute values of the terms both add, in other orders); every case
    launched twice, bitwise equal. Returns the numbers at the main
    path's (bn, h, l, p, n) = (8, 48, 256, 64, 128) in bf16."""
    from repro_torch.kernels.ssd_scan import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, (b, nc, l, h, p, n, g), dtype, pad, reference gate, timed)
    cases = [("reference test shape", (2, 2, 32, 3, 16, 16, 3), f32, 0,
              True, False),
             ("reference test shape", (1, 4, 64, 2, 32, 64, 2), f32, 0,
              True, False),
             ("reference test shape", (2, 1, 128, 4, 64, 128, 4), f32, 0,
              True, False),
             ("main path, bf16", (2, 4, 256, 48, 64, 128, 1), bf16, 0,
              False, True),
             ("main path, fp32", (2, 4, 256, 48, 64, 128, 1), f32, 0,
              False, True),
             ("dt = 0 padding (70 of 256 steps)", (1, 2, 256, 48, 64, 128,
                                                   1), bf16, 70, False,
              False),
             ("ragged l, p, n; 3 groups", (1, 3, 100, 6, 40, 48, 3), f32,
              0, False, False)]
    row = {}
    for seed, (label, shape, dtype, pad, ref_gate, timed) in enumerate(
            cases):
        b, nc, l, h, p, n, g = shape
        args = _ssd_case(torch, seed, b, nc, l, h, p, n, g, dtype, pad)
        got = ops.ssd_intra_chunk(*args)
        again = ops.ssd_intra_chunk(*args)
        want = ref.ssd_intra_chunk(*args)
        xc, dtc, cs, Bc, Cc = args
        scale = ref.ssd_intra_chunk(xc.abs(), dtc, cs, Bc.abs(), Cc.abs())
        torch.cuda.synchronize()
        diff = (got - want).abs()
        share = float((diff / (SSD_GATE * scale).clamp_min(1e-30)).max())
        bitwise = torch.equal(got, again)
        ok = bool((diff <= SSD_GATE * scale).all()) and bitwise
        if ref_gate:
            ok = ok and torch.allclose(got, want, rtol=2e-5, atol=2e-5)
        if pad:
            ok = ok and not bool(got[:, :, l - pad:].any())
        err = float(diff.max())
        print(f"[kernel] ssd_intra_chunk {label} (b·nc, h, l, p, n, g) = "
              f"({b * nc}, {h}, {l}, {p}, {n}, {g}) {str(dtype)[6:]}: max "
              f"abs {err:.3e}, worst share of the {SSD_GATE:g}·Σ|terms| "
              f"gate {share:.4f}"
              f"{', reference gate rtol=atol=2e-5' if ref_gate else ''}"
              f"{', padded rows exactly 0' if pad else ''}, two launches "
              f"bitwise {bitwise} -> {'ok' if ok else 'FAIL'}")
        check(ok, f"ssd kernel disagrees with its plain version: {label} "
                  f"{shape} {dtype}")
        if not timed:
            continue
        bn = b * nc
        ms, host = time_ms(torch, lambda: ops.ssd_intra_chunk(*args), 50)
        plain_ms, plain_host = time_ms(
            torch, lambda: ref.ssd_intra_chunk(*args), 10)
        # the plain version's two matmuls, per head as it computes them,
        # with the operands laid out and the mask L·dt built outside
        heads = [ref.heads_of(t, h).float().movedim(3, 2).reshape(
            bn, h, l, n) for t in (Cc, Bc)]
        Ch, BhT = heads[0].contiguous(), heads[1].transpose(-1, -2) \
            .contiguous()
        Xh = xc.float().movedim(3, 2).reshape(bn, h, l, p).contiguous()
        csh = cs.movedim(3, 2).reshape(bn, h, l)
        L = torch.where(torch.ones(l, l, dtype=torch.bool, device="cuda")
                        .tril(), torch.exp(csh[..., :, None]
                                           - csh[..., None, :]), 0.0)
        M = L * dtc.movedim(3, 2).reshape(bn, h, l)[..., None, :]
        del L
        lib_ms, lib_host = time_ms(
            torch, lambda: torch.matmul(torch.matmul(Ch, BhT) * M, Xh), 50)
        del Ch, BhT, Xh, M
        b_ms, b_by = ssd_bound(bn, l, h, p, n, g, xc.element_size())
        score_rate = ("989 TFLOP/s bf16" if xc.element_size() == 2
                      else "67 TFLOP/s fp32")
        print(f"[kernel] ssd_intra_chunk {label}: device {ms:.5f} ms "
              f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, {b_by}: on the "
              f"causal half, C·Bᵀ once per (chunk, group) at "
              f"{score_rate}, decay and S·x per (chunk, head) at 67 "
              f"TFLOP/s fp32), plain {plain_ms:.5f} ms, the plain "
              f"version's two torch.matmuls per head, fp32, mask built "
              f"outside the timing {lib_ms:.5f} ms; host per call: kernel "
              f"{host:.5f} ms, plain {plain_host:.5f} ms, matmuls "
              f"{lib_host:.5f} ms")
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
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
        reset_launches()
        t0 = time.perf_counter()
        gs, metrics = ddal.run(gs, gen, n_epochs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = launch_counts()
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
                or "sketch_" in r[0] or "ssd_chunk_kernel" in r[0]]

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


def serve_phase(torch):
    """The serving path at mamba2-780m's published widths and depth,
    through ``repro_torch.launch.serve`` called as a function (4
    requests of up to 1023 prompt tokens, 2 slots, 32 greedy tokens),
    with every kernel's launch count zeroed just before the call and
    read just after. Returns ({kernel: {path: launches}}, prompts)."""
    import contextlib
    import io

    from repro_torch.configs import get_arch_config
    from repro_torch.launch import serve

    cfg = get_arch_config("mamba2-780m")
    s = cfg.ssm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out):
        report = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # the launcher's per-slot lines print ~1000-id prompts: summarise
    for (toks, lens), outs in zip(report["batches"], report["outputs"]):
        for row in range(outs.shape[0]):
            print(f"[serve]   prompt of {int(lens[row])} ids -> "
                  f"{outs[row].tolist()}")
    for ln in out.getvalue().splitlines()[-2:]:
        print(f"[serve]   {ln}")
    calls = report["prefill_calls"]
    want = {name: 0 for name in KERNELS}
    want["ssd_intra_chunk"] = cfg.n_layers * calls
    lens = [len(pr) for pr in report["prompts"]]
    print(f"[serve] mamba2-780m: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {s.expand * cfg.d_model // s.head_dim} SSD heads "
          f"of {s.head_dim}, d_state {s.d_state}, chunk {s.chunk}, vocab "
          f"{cfg.vocab_size}, {cfg.compute_dtype} compute; {len(lens)} "
          f"requests, prompt lengths {lens}, {calls} prefill calls; prefill "
          f"ms per batch "
          + ", ".join(f"{ms:.2f}" for ms in report["prefill_ms"])
          + f" (the first includes the card's warm-up); decode "
          f"{report['decode_tok_s']:.1f} tok/s over "
          f"{sum(report['decode_s']):.3f} s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items()))
    check(launched == want, f"[serve]: launches {launched} != {want} "
                            f"({cfg.n_layers} layers x {calls} prefills)")
    outs = report["outputs"]
    check(calls == 2 and len(outs) == 2
          and all(o.shape == (2, 32) and o.dtype == torch.int32
                  and bool(((o >= 0) & (o < cfg.vocab_size)).all())
                  for o in outs),
          "[serve]: not 4 requests x 32 tokens in the vocabulary")
    check(all(lg.shape == (2, cfg.vocab_size)
              and bool(torch.isfinite(lg.float()).all())
              for lg in report["first_logits"]),
          "[serve]: non-finite or misshapen prefill logits")
    return ({"ssd_intra_chunk": {SERVE_LABEL: launched["ssd_intra_chunk"]}},
            report["prompts"])


def equiv_serve_phase(torch, prompts):
    """The card against the port's CPU path on the [serve] prompts, at
    mamba2-780m's widths cut to 2 layers with fp32 compute, on the same
    weights (drawn on the host, copied to the card): prefill logits
    within rtol = atol = 1e-4 (matmuls and the SSD kernel sum in
    another fp32 order than the CPU), the 32 greedy tokens of every
    request equal."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_arch_config
    from repro_torch.models import get_model
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    cfg = get_arch_config("mamba2-780m").with_(n_layers=2,
                                               compute_dtype="float32")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    serve = ServeConfig(max_len=128, max_new_tokens=32)
    results, launched, secs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        engine = ServeEngine(cfg, tree_map(lambda t: t.to(dev), params),
                             serve)
        reset_launches()
        t0 = time.perf_counter()
        results[dev] = []
        for toks, lens in serve_batches(prompts, 2, device=dev):
            logits, cache = engine.prefill(toks, lens)
            out = engine.decode(logits, cache, lens)
            results[dev].append((logits.cpu(), out.cpu()))
        secs[dev] = time.perf_counter() - t0
        launched[dev] = launch_counts()["ssd_intra_chunk"]
    errs, rels, same = [], [], True
    for (lg_c, out_c), (lg_g, out_g) in zip(results["cpu"], results["cuda"]):
        d = (lg_g - lg_c).abs()
        errs.append(float(d.max()))
        rels.append(float((d / lg_c.abs().clamp_min(1e-30)).max()))
        same = same and torch.equal(out_g, out_c)
    ok = (all(torch.allclose(g[0], c[0], rtol=1e-4, atol=1e-4) for g, c in
              zip(results["cuda"], results["cpu"])) and same
          and launched == {"cpu": 0, "cuda": cfg.n_layers * len(errs)})
    print(f"[equiv] serve mamba2-780m widths, 2 layers, fp32, {len(prompts)} "
          f"requests x 32 greedy tokens, card vs CPU: prefill logits max abs "
          f"{max(errs):.3e} (max rel {max(rels):.3e}; rtol=atol=1e-4), "
          f"greedy tokens equal {same}, ssd_intra_chunk launches "
          f"{launched}; CPU {secs['cpu']:.1f} s, card {secs['cuda']:.1f} s "
          f"-> {'ok' if ok else 'FAIL'}")
    check(ok, "card and CPU serving paths disagree")


def profile_serve_phase(torch, prompts):
    """The device's busy share and the ops that take the time at full
    width, after a warm-up: one prefill of the first [serve] batch in
    one profiler window, 4 decode steps in another; then the same split
    on the host clock with the profiler off."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch_config
    from repro_torch.models import get_model
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    cfg = get_arch_config("mamba2-780m")
    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    engine = ServeEngine(cfg, params, ServeConfig(max_len=128,
                                                  max_new_tokens=5))
    toks, lens = serve_batches(prompts[:2], 2, device="cuda")[0]
    engine.generate(toks, lens)                       # warm-up
    torch.cuda.synchronize()
    state = {}

    def prefill():
        state["prefill"] = engine.prefill(toks, lens)

    def decode():
        engine.decode(*state["prefill"], lens)

    for label, fn in (("prefill", prefill), ("4 decode steps", decode)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        rows = [(ev.key, ev.count,
                 getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0)),
                 getattr(ev, "self_cpu_time_total", 0.0))
                for ev in prof.key_averages()]
        ssd_us = sum(r[2] for r in rows if "ssd_chunk_kernel" in r[0])
        print(f"[profile] serve mamba2-780m {label}, batch of "
              f"{toks.shape[0]} x {toks.shape[1]} prompt tokens: wall "
              f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms "
              f"({busy_us / (wall * 1e6):.1%}), {len(kernels)} device "
              f"kernels, ssd_chunk_kernel {ssd_us / 1e3:.3f} ms")
        for what, col in (("device", 2), ("self host", 3)):
            for key, count, dev_us, cpu_us in sorted(
                    rows, key=lambda r: -r[col])[:6]:
                print(f"[profile]   by {what} time: {key[:60]}: {count} "
                      f"calls, device {dev_us:.0f} us, self host "
                      f"{cpu_us:.0f} us")
    times = {"prefill": [], "decode step": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        times["prefill"].append((t1 - t0) * 1e3)
        times["decode step"].append((time.perf_counter() - t1) * 1e3 / 4)
    print("[profile] serve, host clock, profiler off, 3 repetitions (ms): "
          + "; ".join(f"{k} " + ", ".join(f"{v:.2f}" for v in vs)
                      for k, vs in times.items()))


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
        card = device_phase(torch)
        build_phase()
        table = kernel_phase(torch)
        table["grad_sketch"] = sketch_phase(torch)
        table["ddal_fused_wavg_q"] = wavg_q_phase(torch)
        table["ssd_intra_chunk"] = ssd_kernel_phase(torch)
        launches = main_path_phase(torch)
        serve_launches, prompts = serve_phase(torch)
        for name, paths in serve_launches.items():
            launches[name].update(paths)
        equivalence_phase(torch)
        equiv_serve_phase(torch, prompts)
        profile_phase(torch)
        profile_serve_phase(torch, prompts)
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
    print(card)                                  # name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
