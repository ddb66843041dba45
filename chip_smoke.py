#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    PYTHONPATH=src python3 chip_smoke.py        # src/ is also found alone

Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. build every CUDA kernel of the main paths from the sources in this
   checkout (one ``nvcc`` per source, all started together), with the
   registers and spills ptxas reports for each kernel instance (a
   flash, SSD or fp32 share-step instance that spills fails the run);
3. each kernel against its plain PyTorch version on the card, at the
   shapes of the main paths and at edge cases, with its time beside the
   plain version's, a one-call PyTorch yardstick's and the least time
   the card could take: the fp32 eq. 4 share step (both entries,
   bitwise, also at m = 1, 5, 33, 4096, n = 1 and in each instance), the
   gradient sketch (signs through the kernel bitwise, sketches within
   their gate, two launches bitwise equal, also at the row-block and
   chunk edges), the int8 share step (bitwise, also at m = 1, 5, 33,
   4096 and n = 1), the SSD intra-chunk dual form (bf16 on the tensor
   cores at the tile, group and window edges, fp32 on the CUDA cores;
   each within its gate, two launches bitwise equal, both kernels run;
   inputs that require grad refused) and the flash attention
   (bf16 on the tensor cores, fp32 on the CUDA cores; each within its
   gate, two launches bitwise equal, with its TFLOP/s over the tiles
   it visits and the blocks per SM of every flash instance); and both
   share steps on the robustness paths' inputs (T and R discounted by
   0.95**age, pieces past the staleness cutoff, quarantined pieces,
   an agent with no valid piece), bitwise;
4. the main paths, through the entry points a user calls, each run with
   the kernels' launch counts zeroed just before it and read just
   after: DDA3C groups at the paper's width (A2C, hidden 64,
   CartPole-v0) trained for a few hundred epochs, the fourth with
   learned sketched relevance and int8 knowledge planes; DDADQN groups
   (dueling double DQN, hidden 64, P = 8835) through ``make_dqn_group``,
   n = 2 ``full`` and n = 8 ``ring`` with sketches and int8 planes, each
   ending with every replay ring above one minibatch; the robustness
   paths: (a) DDA3C n = 8 on ``relevance_topk`` gossip (k = 4, every 10
   epochs, ε 0.1) with sketched relevance and int8 planes, (b) DDA3C
   n = 8 ring with elastic membership on a ``chaos_schedule`` over a
   faulty transport (loss, corruption, retransmit, jitter, duplicates)
   with ``max_staleness`` 8 and decay 0.95, (c) DDADQN n = 4 with
   ``obs_stats`` relevance on ``dynamic`` gossip; mamba2-780m
   and llama3.2-3b at their published widths and depth served by
   ``repro_torch.launch.serve`` (``[serve]``: 4 requests of up to 1023
   prompt tokens, prefill and 32 greedy tokens each); llama3.2-3b
   scoring 2 x 4096 ids through ``get_model(cfg).forward`` / ``.loss``
   without a cache (``[score]``: the flash kernel in every layer), with
   a profile of one scoring pass, and its ``ServeEngine.decode`` under
   ``torch.cuda.set_sync_debug_mode("error")`` (``[nosync]``); the slot
   engines at full width and depth: ``[continuous] mamba2-780m`` (8
   requests through 2 slots), ``[group] mamba2-780m`` (4 agents, 4
   slots, 16 requests, a hot swap after 8) and ``[group] llama3.2-3b``
   (2 agents, 2 slots, 4 requests), each request's first token against
   the fixed-batch engine on its admitted planes and one synchronizing
   call per step, ``[exact]`` the same engines in fp32 compute with
   every token equal, and ``[load] mamba2-780m``, the load bench's twin
   (open-loop Poisson arrivals, a hot swap, its three gates);
5. the card against the port's CPU path: small DDA3C groups with seeded
   gradients, fp32 and int8 + learned relevance; a small DDADQN group
   with seeded gradients (target syncs included) and ``dqn_loss`` with
   its gradient on one seeded batch; the robustness paths (a) and (b)
   cut to n = 6 on seeded gradients, and a checkpoint written on the
   card restored on the CPU; the serving paths at
   mamba2-780m's and llama3.2-3b's widths cut to 2 layers with fp32
   compute; the llama scoring pass at the same cut; the continuous and
   group engines at both cuts (step logits within 1e-4, tokens equal);
6. a profile of a few main-path epochs of the quickstart group, of
   the fourth run's configuration and of the DDADQN n = 2 group (the
   device's busy share, the ops that take the time and the host-clock
   split of an epoch), and of
   one full-width mamba2-780m prefill and 4 decode steps (the SSD
   library's kernels' share of the prefill).

It prints one JSON line of per-kernel numbers (``launches`` is the
count of the first path that drives the kernel, ``launches_by_path``
each such path's own count) and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero, as
does a machine with no CUDA card.
"""
from __future__ import annotations

import gc
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
DQN_EPS_DECAY = 500                     # the DDADQN runs' ε anneal
SOURCES = ("ddal_wavg", "grad_sketch", "ssd_scan", "flash_attention")
SSD_GATE = 1e-5        # × Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp|, per element
# bf16 SSD cases at the edges of the kernel's 64-row tiles, its windows of
# 4 column tiles for dt and cs (l > 256), its 16-byte copies (p, n not
# multiples of 8), and its head sets (g > 1 with several sets per group;
# every instance, 1, 2 and 3 heads a block): (label, (b, nc, l, h, p, n, g))
SSD_BF16_EDGES = [
    ("l = 1", (1, 2, 1, 4, 64, 128, 1)),
    ("l = 63", (1, 2, 63, 4, 64, 128, 1)),
    ("l = 65", (1, 2, 65, 4, 64, 128, 1)),
    ("l = 100, p = 40, n = 48, 3 groups", (1, 3, 100, 6, 40, 48, 3)),
    ("p = 1, n = 16", (1, 2, 256, 4, 1, 16, 1)),
    ("n = 100, p = 40, 2 groups", (1, 2, 256, 4, 40, 100, 2)),
    ("l = 129, p = 33, n = 24, 3 groups", (1, 1, 129, 18, 33, 24, 3)),
    ("l = 300: two windows, 2 groups", (1, 1, 300, 4, 64, 128, 2)),
    ("l = 600: three windows", (1, 1, 600, 2, 64, 64, 1)),
    ("2 groups of 6 heads", (4, 8, 256, 12, 64, 128, 2)),
    ("3 groups of 12 heads", (2, 8, 256, 36, 64, 128, 3)),
    ("3 groups of 4 heads", (8, 8, 256, 12, 64, 128, 3)),
    ("48 heads, two waves", (4, 16, 256, 48, 64, 128, 1)),
    ("l = 300, 3 heads a block: two windows", (16, 8, 300, 6, 64, 128, 2)),
    ("l = 600, 2 heads a block: three windows", (16, 8, 600, 4, 64, 64, 1))]
# the serving path: mamba2-780m at its published widths and depth
SERVE_ARGV = ["--arch", "mamba2-780m", "--full", "--serve", "engine=batch",
              "--serve", "slots=2", "--requests", "4", "--prompt-len",
              "1024", "--serve", "max_new_tokens=32"]
SERVE_LABEL = "[serve] mamba2-780m"
# the scoring path: llama3.2-3b at its published widths and depth, B
# rows of the repo's train_4k sequence length
LLAMA = "llama3.2-3b"
SCORE_B, SCORE_S, SCORE_PASSES = 2, 4096, 3
SCORE_LABEL = "[score] llama3.2-3b"
LLAMA_SERVE_ARGV = ["--arch", LLAMA, "--full", "--serve", "engine=batch",
                    "--serve", "slots=2", "--requests", "4", "--prompt-len",
                    "1024", "--serve", "max_new_tokens=32", "--serve",
                    "max_len=1056"]
LLAMA_SERVE_LABEL = "[serve] llama3.2-3b"
FA_TOL = dict(rtol=2e-5, atol=2e-5)    # fp32, as the Pallas kernel is held

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
    "flash_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:93"),
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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"ddal_fused_wavg": ops.fused_wavg, "ddal_wavg": ops.wavg,
            "ddal_fused_wavg_q": ops.fused_wavg_q,
            "grad_sketch": sketch_ops.sketch_flat,
            "ssd_intra_chunk": ssd_ops.ssd_intra_chunk,
            "flash_attention": fa_ops.flash_attention}


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
    """Builds every source and prints each kernel instance's registers
    and spills; returns {source: the instances' names}."""
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = dict(zip(SOURCES, pool.map(cuda_build.load, SOURCES)))
    secs = time.perf_counter() - t0
    instances = {}
    for name in SOURCES:
        src = cuda_build.source_of(name).relative_to(ROOT)
        print(f"[build] {src} -> "
              f"{cuda_build.BUILD_DIR.relative_to(ROOT)}/{name}.so")
        report = cuda_build.ptxas_report(libs[name][1])
        instances[name] = {kernel for kernel, *_ in report}
        for kernel, regs, stores, loads in report:
            print(f"[build]   ptxas {kernel}: {regs} registers, spill "
                  f"stores {stores} B, spill loads {loads} B")
        if name == "ddal_wavg":
            fp32 = [r for r in report if "wavg_kernel" in r[0]]
            check(len(fp32) == 10 and all(st == ld == 0 for _, _, st, ld
                                          in fp32),
                  f"ddal_wavg: ptxas reports spills or not the 10 fp32 "
                  f"instances (fused / wavg x 5 geometries): {fp32}")
        if name == "ssd_scan":
            check(len(report) == 4 and all(st == ld == 0 for _, _, st, ld
                                           in report),
                  f"ssd_scan: ptxas reports spills or not the 4 instances "
                  f"(fp32 CUDA cores, bf16 tensor cores x 1, 2, 3 heads a "
                  f"block): {report}")
        if name == "flash_attention":
            check(len(report) == 8 and all(st == ld == 0 for _, _, st, ld
                                           in report),
                  f"flash_attention: ptxas reports spills or not the 8 "
                  f"instances (fp32 / bf16 x D = 16, 32, 64, 128): {report}")
    print(f"[build] {len(SOURCES)} sources built in parallel and loaded "
          f"in {secs:.2f} s")
    return instances


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


def time_cold_ms(torch, fn, iters):
    """Device ms of one call that finds the L2 cache cold: a 256 MiB
    write (five times the H100's 50 MB L2) before each call, and CUDA
    events around the call alone, averaged over ``iters`` calls."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    del flush
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


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
    """Both fp32 share-step kernels against their plain versions,
    bitwise for ḡ and Σw (and within the Pallas kernel's bounds), at the
    main path's shapes and at edge cases: the batch edges m = 1, 5, 33
    and MAX_PIECES, one agent, and each kernel instance. Returns the
    per-kernel numbers of the first shape."""
    from repro_torch.kernels.ddal_wavg import ops, ref
    # (label, n, m, P, invalid pieces, timed)
    cases = [("quickstart share step", 2, 32, 9155, "none", True),
             ("DDADQN share step", 2, 32, 8835, "none", True),
             ("ring n=8 share step", 8, 32, 9155, "some", True),
             ("big ragged plane", 16, 8, 2 ** 20 + 37, "some", True),
             ("single element", 1, 1, 1, "none", False),
             ("some pieces invalid", 3, 32, 9155, "some", False),
             ("every piece invalid", 2, 32, 9155, "all", False),
             # across the kernel's batches, one agent, each instance
             ("one piece", 8, 1, 9155, "some", False),
             ("5 pieces", 8, 5, 9155, "some", False),
             ("33 pieces", 8, 33, 9155, "some", False),
             (f"{ops.MAX_PIECES} pieces (the most)", 1, ops.MAX_PIECES,
              9155, "some", False),
             ("one agent", 1, 32, 9155, "some", False),
             ("12 pieces, two agents", 2, 12, 9155, "some", False),
             ("12 pieces", 8, 12, 9155, "some", False),
             ("12 pieces, big ragged plane", 4, 12, 2 ** 20 + 37, "some",
              False)]
    table, instances = {}, set()
    for label, n, m, p, invalid, timed in cases:
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
        bitwise = (torch.equal(got_g, want_g) and torch.equal(got_w, want_w)
                   and torch.equal(got_u, want_u))
        ok = (bitwise and torch.allclose(got_g, want_g, **G_TOL)
              and torch.allclose(got_u, want_u, **G_TOL)
              and torch.allclose(got_w, want_w, rtol=W_RTOL, atol=0.0))
        if invalid == "all":
            ok = ok and not bool(got_g.any()) and not bool(got_w.any())
        geo = ops.wavg_geometry(n, m, p)
        instances.add((geo.batch, geo.items))
        print(f"[kernel] {label} (n, m, P) = ({n}, {m}, {p}), grid "
              f"{geo.blocks} x {n} = {geo.blocks * n} blocks of "
              f"{ops.F32_THREADS} folding threads x {geo.items} positions "
              f"(the fused entry's blocks add a weighing warp), "
              f"{geo.batch}-piece batches: "
              f"fused max abs {errs['ddal_fused_wavg'][0]:.3e} "
              f"rel {errs['ddal_fused_wavg'][1]:.3e}, Σw rel {w_err:.3e}; "
              f"wavg max abs {errs['ddal_wavg'][0]:.3e} "
              f"rel {errs['ddal_wavg'][1]:.3e}; ḡ and Σw bitwise {bitwise}, "
              f"tolerance ḡ rtol=atol=2e-5, Σw rtol 1e-6 -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"kernel disagrees with its plain version: {label}")
        if not timed:
            continue
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
                  f"{lib_ms:.5f} ms ({ms / lib_ms:.2f}x); host per call: "
                  f"kernel {host:.5f} ms, plain {plain_host:.5f} ms, "
                  f"einsum {lib_host:.5f} ms")
            if label == "quickstart share step":
                table[name] = dict(max_abs_err=errs[name][0], ms=ms,
                                   plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=lib_ms)
    want = {(32, 1), (16, 1), (16, 2), (8, 1), (8, 4)}
    print(f"[kernel] ddal_fused_wavg / ddal_wavg instances (batch, "
          f"positions per thread) run: {sorted(instances)} of "
          f"{sorted(want)}")
    check(instances == want, "not every fp32 kernel instance was held "
                             "against the plain version")
    return table


def _a2c_layout(torch):
    """The paper's A2C (hidden 64) leaf table: P = 9155 in 12 leaves."""
    from repro_torch.common.pytree import PlaneLayout
    from repro_torch.rl import networks
    tree = networks.init_policy_value(torch.Generator().manual_seed(0), 1,
                                      4, 2, 64)
    return PlaneLayout.from_tree(tree, lead=1)


def _dueling_layout(torch):
    """DDADQN's dueling network on CartPole (hidden 64): P = 8835 in 10
    leaves."""
    from repro_torch.common.pytree import PlaneLayout
    from repro_torch.rl import networks
    tree = networks.init_dueling_q(torch.Generator().manual_seed(0), 1, 4,
                                   2, 64)
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
    # (label, n, P, d, offset, seed, reference gate, timed)
    cases = [("main path: n=8 agents' rows", 8, p, SKETCH_DIM, 0, seed,
              False, True),
             ("DDADQN main path: n=8 agents' dueling rows", 8, 8835,
              SKETCH_DIM, 0, seed, False, True),
             ("reference test shape", 8, 1024, 128, 11, 7, True, True),
             ("reference test shape", 3, 4097, 256, 11, 7, True, True),
             ("reference test shape", 8, 1000, 128, 11, 7, True, True),
             ("reference test shape", 16, 2048, 384, 11, 7, True, True),
             ("unaligned width", 8, p, 100, 0, seed, False, True),
             ("LLM-scale plane", 16, 2 ** 22 + 37, SKETCH_DIM, 0, seed,
              False, True),
             # the row-block instances' edges and the chunk's
             ("one row", 1, p, SKETCH_DIM, 5, seed, False, False),
             ("9 rows in a 16-row block", 9, p, SKETCH_DIM, 5, seed, False,
              False),
             ("17 rows in two 16-row blocks", 17, p, SKETCH_DIM, 5, seed,
              False, False),
             ("P shorter than one chunk", 8, ops.MIN_CHUNK - 12, SKETCH_DIM,
              3, seed, False, False),
             ("P one chunk + 1", 8, ops.MIN_CHUNK + 1, SKETCH_DIM, 3, seed,
              False, False)]
    row = {}
    for label, n, p_, d, offset, sd, ref_gate, timed in cases:
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
        geo = ops.sketch_geometry(n, p_, d)
        x, y, z = geo.grid(n, d)
        print(f"[kernel] grad_sketch {label} (n, P, d) = ({n}, {p_}, {d}), "
              f"offset {offset}, {geo.rows}-row blocks, {geo.chunks} chunks "
              f"of {geo.chunk} (grid {x} x {y} x {z} = {x * y * z} blocks, "
              f"second pass {geo.reduce_blocks} blocks): max abs "
              f"{err:.3e}, worst share of the "
              f"1e-5·Σ|G| gate {float((diff / gate).max()):.3f}"
              f"{', reference gate rtol 1e-4 atol 1e-3' if ref_gate else ''}"
              f", two launches bitwise {torch.equal(got, again)} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"sketch kernel disagrees with its plain version: {label}")
        if not timed:
            continue
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
    # (label, layout, n, m, q_block, invalid pieces, timed)
    cases = [("main path: n=8 ring share step, q_block 128", a2c, 8, 32,
              128, "some", True),
             ("DDADQN main path: n=8 ring share step over the dueling "
              "layout, q_block 128", _dueling_layout(torch), 8, 32, 128,
              "some", True),
             ("q_block 1024", a2c, 8, 32, 1024, "some", True),
             ("every piece invalid", a2c, 8, 32, 128, "all", True),
             ("big ragged plane, q_block 128", ragged, 16, 8, 128, "some",
              True),
             # across the kernel's 32-piece batches, and one agent
             ("one piece", a2c, 8, 1, 128, "some", False),
             ("5 pieces", a2c, 8, 5, 128, "some", False),
             ("33 pieces", a2c, 8, 33, 128, "some", False),
             (f"{ops.MAX_PIECES} pieces (the most)", a2c, 1, ops.MAX_PIECES,
              128, "some", False),
             ("one agent", a2c, 1, 32, 128, "some", False),
             ("12 pieces", a2c, 8, 12, 128, "some", False),
             ("12 pieces, two agents", a2c, 2, 12, 128, "some", False),
             ("12 pieces, big ragged plane", ragged, 4, 12, 128, "some",
              False)]
    row, instances = {}, set()
    for label, layout, n, m, qb, invalid, timed in cases:
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
        geo = ops.wavg_q_geometry(n, m, layout.size)
        instances.add((geo.batch, geo.items))
        print(f"[kernel] ddal_fused_wavg_q {label} (n, m, P) = ({n}, {m}, "
              f"{layout.size}), {blocks.n_blocks} scale columns, grid "
              f"{geo.blocks} x {n} = {geo.blocks * n} blocks of "
              f"{ops.Q_THREADS} threads x {geo.items} positions, "
              f"{geo.batch}-piece batches: "
              f"max abs {err:.3e}, ḡ and Σw bitwise {ok} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"int8 kernel disagrees with its plain version: {label}")
        if not timed:
            continue
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
    want = {(32, 1), (16, 1), (16, 2), (8, 1), (8, 4)}
    print(f"[kernel] ddal_fused_wavg_q instances (batch, positions per "
          f"thread) run: {sorted(instances)} of {sorted(want)}")
    check(instances == want, "not every int8 kernel instance was held "
                             "against the plain version")
    return row


def stale_kernel_phase(torch):
    """The fused fp32 and int8 share steps on the inputs the robustness
    paths give them, bitwise against their plain versions: T and R
    discounted by 0.95**age (ages 0–8) with pieces past max_staleness 6
    cut (``combiners.age_gate``), quarantined pieces (int8: payload and
    scales zeroed, valid cleared), and agents whose every piece is
    invalid (Σw = 0)."""
    from repro_torch.core import knowledge as K
    from repro_torch.core.exchange.combiners import age_gate
    from repro_torch.kernels.ddal_wavg import ops, ref

    a2c = _a2c_layout(torch)
    n, m, p = 8, 32, a2c.size
    for label in ("fp32", "int8"):
        G, T, R, valid = make_case(torch, n, m, p, seed=71)
        g = torch.Generator(device="cuda").manual_seed(72)
        born = 100 - torch.randint(0, 9, (n, m), generator=g, device="cuda",
                                   dtype=torch.int32)
        quar = torch.rand((n, m), generator=g, device="cuda") < 0.1
        valid = valid & ~quar
        valid[3] = False                                 # an empty store
        scale, blocks = None, None
        if label == "int8":
            blocks = a2c.blocks(QUANT_BLOCK)
            G, scale = ref.quantize_flat(G, blocks)
            scale = torch.where(quar[..., None], 0.0, scale)
        G = torch.where(quar[..., None], torch.zeros((), dtype=G.dtype,
                                                     device="cuda"), G)
        st = K.KnowledgeStore(G, T, R, valid, torch.zeros(
            (n,), dtype=torch.int32, device="cuda"), scale, blocks, born)
        gated = age_gate(st, 100, 6, 0.95)
        cut = int((st.valid & ~gated.valid).sum())
        if label == "int8":
            got = ops.fused_wavg_q(gated.grads, gated.scale, gated.T,
                                   gated.R, gated.valid, blocks)
            want = ref.fused_wavg_q(gated.grads, gated.scale, gated.T,
                                    gated.R, gated.valid, blocks)
        else:
            got = ops.fused_wavg(gated.grads, gated.T, gated.R, gated.valid)
            want = ref.fused_wavg(gated.grads, gated.T, gated.R, gated.valid)
        torch.cuda.synchronize()
        ok = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and not bool(got[0][3].any()) and float(got[1][3]) == 0.0)
        print(f"[kernel] stale {label} share step (n, m, P) = ({n}, {m}, "
              f"{p}): T, R × 0.95**age (ages 0–8), {cut} pieces past "
              f"max_staleness 6 cut, {int(quar.sum())} quarantined, agent "
              f"3 all invalid: ḡ and Σw bitwise against the plain version "
              f"{ok}, Σw of the empty store {float(got[1][3])} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label} share step disagrees with its plain version on "
                  f"discounted / quarantined / empty stores")


def ssd_instance(dtype, heads):
    """The name ptxas reports for the SSD kernel instance that takes
    ``dtype`` inputs with ``heads`` heads per block."""
    if str(dtype) == "torch.float32":
        return "fp32::ssd_chunk_fp32_kernel"
    return f"tc::ssd_chunk_bf16_mma_kernel<{heads}>"


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


def ssd_bound(bn, l, h, p, n, g, esize, split_sx=True):
    """Least time (ms), the larger of operations and bytes, and which
    one it is. Over the l(l+1)/2 causal (i, j) pairs of a chunk: the
    score C_i·B_j, 2n operations once per (chunk, group), since B and C
    are shared by the heads of a group; per (chunk, head) the product
    with x_j (2p), and the decay exp(cs_i − cs_j) and its products (3),
    plus l·p to fold dt_j into x_j. With bf16 inputs the score is one
    bf16 product (bf16 products are exact in fp32, the sums stay fp32)
    and S·x two, S_hi·x + S_lo·x (S is fp32 in the reference, and one
    bf16 S leaves the gate), at the bf16 tensor-core rate; the decay at
    the fp32 rate. ``split_sx=False`` prices a bf16 S·x at the fp32
    rate instead, the pricing of an S·x on the CUDA cores. With fp32
    inputs everything runs at the fp32 rate (TF32 would round them).
    Bytes: each input read once, the fp32 output written once, at the
    HBM rate."""
    pairs = l * (l + 1) // 2
    score = bn * g * pairs * 2 * n
    sx = bn * h * pairs * 2 * p
    decay = bn * h * (pairs * 3 + l * p)
    nbytes = (bn * l * h * p * esize + 2 * bn * l * g * n * esize
              + 2 * bn * l * h * 4 + bn * l * h * p * 4)
    if esize == 2 and split_sx:
        ops_ms = ((score + 2 * sx) / BF16_FLOP_PER_S
                  + decay / FP32_FLOP_PER_S) * 1e3
    elif esize == 2:
        ops_ms = (score / BF16_FLOP_PER_S
                  + (sx + decay) / FP32_FLOP_PER_S) * 1e3
    else:
        ops_ms = (score + sx + decay) / FP32_FLOP_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def ssd_kernel_phase(torch, built):
    """The SSD intra-chunk kernels against their plain version: the
    reference's three test shapes within its rtol = atol = 2e-5; the
    main path's shape in fp32 and bf16, ragged shapes, a dt = 0 padded
    chunk and the bf16 kernel's edges (SSD_BF16_EDGES) within SSD_GATE ·
    Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp| per element (the plain version on
    |x|, |B|, |C|: the sum of the absolute values of the terms both add,
    in other orders); every case launched twice, bitwise equal; every
    kernel instance ptxas reported (``built``) run. Returns the numbers
    at the main path's (bn, h, l, p, n) = (8, 48, 256, 64, 128) in
    bf16."""
    from repro_torch.configs.base import NotPortedError
    from repro_torch.kernels.ssd_scan import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    # no backward on the card: a call autograd would record raises
    # rather than drop the gradient of the intra-chunk term
    outcomes = []
    for which in range(5):
        args = _ssd_case(torch, 99, 1, 1, 32, 2, 16, 16, 2, f32)
        args[which].requires_grad_(True)
        launches = ops.ssd_intra_chunk.launches
        try:
            ops.ssd_intra_chunk(*args)
            raised = False
        except NotPortedError:
            raised = True
        refused = raised and ops.ssd_intra_chunk.launches == launches
        with torch.no_grad():
            ran = ops.ssd_intra_chunk(*args)
        outcomes.append(refused and ops.ssd_intra_chunk.launches
                        == launches + 1 and bool(torch.isfinite(ran).all()))
    ok = all(outcomes)
    print(f"[kernel] ssd_intra_chunk with x, dt, cs, B or C requiring grad "
          f"under grad mode: NotPortedError and no launch in "
          f"{sum(outcomes)} of 5, and each call runs under "
          f"torch.no_grad() -> {'ok' if ok else 'FAIL'}")
    check(ok, "ssd_intra_chunk ran with an input that requires grad, which "
              "would drop that input's gradient")
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
              0, False, False),
             ("dt = 0 padding at the main path's shape", (2, 4, 256, 48, 64,
                                                         128, 1), bf16, 70,
              False, False),
             ("the slot engines' B = 1 prefill, nc = 1", (1, 1, 256, 48, 64,
                                                         128, 1), bf16, 0,
              False, False),
             ("the slot engines' B = 1 prefill, nc = 4", (1, 4, 256, 48, 64,
                                                         128, 1), bf16, 0,
              False, False)] + [
        (f"bf16 {label}", shape, bf16, 0, False, False)
        for label, shape in SSD_BF16_EDGES]
    row, instances_run = {}, set()
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
        geo = ops.ssd_geometry(b * nc, l, h, g, dtype)
        instances_run.add(ssd_instance(dtype, geo.heads))
        gx, gy, gz = geo.grid
        print(f"[kernel] ssd_intra_chunk {label} (b·nc, h, l, p, n, g) = "
              f"({b * nc}, {h}, {l}, {p}, {n}, {g}) {str(dtype)[6:]}, "
              f"{ssd_instance(dtype, geo.heads)} grid {gx} x {gy} x {gz}: "
              f"max abs {err:.3e}, worst share of the "
              f"{SSD_GATE:g}·Σ|terms| gate {share:.4f}"
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
        esize = xc.element_size()
        b_ms, b_by = ssd_bound(bn, l, h, p, n, g, esize)
        if esize == 2:
            cold = time_cold_ms(torch, lambda: ops.ssd_intra_chunk(*args),
                                50)
            old_ms, old_by = ssd_bound(bn, l, h, p, n, g, esize,
                                       split_sx=False)
            pricing = (f"C·Bᵀ once per (chunk, group) and S_hi·x + S_lo·x "
                       f"at 989 TFLOP/s bf16, the decay at 67 TFLOP/s "
                       f"fp32; priced with S·x at the fp32 rate, as for the "
                       f"CUDA-core kernel: {old_ms:.5f} ms, {old_by}); with "
                       f"the L2 flushed before each launch {cold:.5f} ms "
                       f"({b_ms / cold:.1%} of the bound")
        else:
            pricing = "every product at 67 TFLOP/s fp32"
        print(f"[kernel] ssd_intra_chunk {label}: device {ms:.5f} ms "
              f"({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, {b_by}: on the "
              f"causal half, {pricing}), plain {plain_ms:.5f} ms, the plain "
              f"version's two torch.matmuls per head, fp32, mask built "
              f"outside the timing {lib_ms:.5f} ms ({ms / lib_ms:.2f}x); "
              f"host per call: kernel {host:.5f} ms, plain "
              f"{plain_host:.5f} ms, matmuls {lib_host:.5f} ms")
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    per_sm = {k: ops.blocks_per_sm(k) for k in range(1, ops.MAX_HEADS + 1)}
    print(f"[kernel] ssd_intra_chunk instances run: "
          f"{sorted(instances_run)}; bf16 blocks one SM holds, by heads a "
          f"block: {per_sm}")
    check(instances_run == built,
          f"not every SSD kernel instance was held against the plain "
          f"version: ran {sorted(instances_run)}, built {sorted(built)}")
    check(all(per_sm[k] >= ops.BLOCKS_PER_SM[k] for k in per_sm),
          f"an SM holds fewer bf16 SSD blocks than ssd_geometry plans "
          f"({ops.BLOCKS_PER_SM}): {per_sm}")
    return row


def flash_bound(B, S, H, K, D, window, esize):
    """Least time (ms), the larger of operations and bytes, and which one
    it is. Over the (i, j) pairs the mask keeps (Σ_i min(i + 1, window)
    per (b, h)), each product is 2·D operations per pair. bf16 inputs:
    q·kᵀ as one bf16 product (bf16 products are exact in fp32) and p·v as
    two, p_hi·v + p_lo·v (p is fp32 in the reference and one bf16 p
    leaves the one-unit gate; one TF32 product at half the rate costs the
    same), all at the bf16 tensor-core rate. fp32 inputs: both products
    at the fp32 rate (TF32 would round the inputs). Bytes: q, k and v
    read once, o written once, at the HBM rate."""
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    flops = 2 * D * pairs * B * H                 # one product
    if esize == 2:
        ops_ms = 3 * flops / BF16_FLOP_PER_S * 1e3
    else:
        ops_ms = 2 * flops / FP32_FLOP_PER_S * 1e3
    bytes_ms = (2 * B * S * H * D + 2 * B * S * K * D) * esize \
        / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def flash_mma_flops(B, S, H, D, window, dtype_is_bf16):
    """The operations the kernel runs over the tiles it visits, as
    ``csrc/flash_attention.cu`` walks them: per query tile the key tiles
    from the window's first to the diagonal; bf16 (128 x 64 tiles,
    three products) skips a tile per warp of 16 rows when it is wholly
    masked for them, fp32 (64 x 64, two products) runs every visited
    tile whole."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    bq, bk = ops.TILES[torch.bfloat16 if dtype_is_bf16 else torch.float32]
    rows, products = (16, 3) if dtype_is_bf16 else (bq, 2)
    units = 0                          # (rows x bk) blocks of work
    for i0 in range(0, S, bq):
        last = min(i0 + bq, S) - 1
        lo = max(0, i0 - window + 1) if window else 0
        for j0 in range(lo // bk * bk, last + 1, bk):
            for w0 in range(i0, i0 + bq, rows):
                skip = j0 > w0 + rows - 1 or (
                    window and j0 + bk - 1 <= w0 - window)
                units += not skip
    return units * rows * bk * D * 2 * products * B * H


def _fa_within_gate(torch, got, want):
    """fp32: the reference's rtol = atol = 2e-5. bf16: kernel and plain
    version both compute in fp32 and round the output once, so they may
    land one bf16 unit apart where the fp32 values straddle a rounding
    boundary: |got − want| ≤ 2^-7·|want| + 2e-5."""
    if got.dtype == torch.float32:
        return torch.allclose(got, want, **FA_TOL)
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 2e-5).all())


def flash_kernel_phase(torch):
    """The flash-attention kernels against their plain version: the
    scoring path's shape in bf16 (the tensor-core kernel) and fp32 (the
    CUDA-core kernel), a window of 512 at S = 4096, windows smaller than
    a tile and across 128-row tiles, ragged S, MQA, D = 16, 32 and 64,
    each within its gate and launched twice, bitwise equal; then the
    blocks per SM of every instance. Returns the numbers at the scoring
    path's (B, S, H, K, D) = (2, 4096, 24, 8, 128) in bf16."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops, ref
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, (B, S, H, K, D), window, dtype, timed)
    path = (SCORE_B, SCORE_S, 24, 8, 128)
    cases = [("scoring path", path, None, bf16, True),
             ("scoring path", path, None, f32, True),
             ("window 512", path, 512, bf16, True),
             ("window 512", (1, SCORE_S, 24, 8, 128), 512, f32, False),
             ("window 5, smaller than a tile", (1, 300, 4, 2, 128), 5, f32,
              False),
             ("window 40", (2, 300, 4, 2, 64), 40, bf16, False),
             ("ragged S = 4000", (1, 4000, 24, 8, 128), None, bf16, False),
             ("ragged S = 80", (2, 80, 4, 4, 32), None, f32, False),
             ("MQA, D = 64", (2, 513, 8, 1, 64), None, f32, False),
             ("MQA, D = 64", (2, 513, 8, 1, 64), None, bf16, False),
             ("D = 16, one token", (1, 1, 2, 1, 16), None, f32, False),
             ("S = 129, one row past a 128-row tile", (1, 129, 4, 2, 128),
              None, bf16, False),
             ("window 127 across 128-row tiles", (1, 700, 4, 2, 128), 127,
              bf16, False),
             ("D = 16", (2, 333, 6, 3, 16), None, bf16, False),
             ("D = 32, window 100", (2, 333, 6, 3, 32), 100, bf16, False)]
    row = {}
    for seed, (label, (B, S, H, K, D), window, dtype, timed) in enumerate(
            cases):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
        got = ops.flash_attention(q, k, v, window=window)
        again = ops.flash_attention(q, k, v, window=window)
        want = ref.attention(q, k, v, window=window)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, again)
        ok = _fa_within_gate(torch, got, want) and bitwise
        err = float((got.float() - want.float()).abs().max())
        gate = ("rtol=atol=2e-5" if dtype == f32
                else "2^-7·|want| + 2e-5 (one bf16 unit)")
        print(f"[kernel] flash_attention {label} (B, S, H, K, D) = "
              f"({B}, {S}, {H}, {K}, {D}) {str(dtype)[6:]}: max abs "
              f"{err:.3e}, gate {gate}, two launches bitwise {bitwise} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash kernel disagrees with its plain version: {label} "
                  f"{(B, S, H, K, D)} {dtype}")
        del want
        if not timed:
            continue
        ms, host = time_ms(torch, lambda: ops.flash_attention(
            q, k, v, window=window), 20)
        plain_ms, plain_host = time_ms(torch, lambda: ref.attention(
            q, k, v, window=window), 3)
        # the yardstick in the (B, H, S, D) layout it takes, GQA by its
        # own flag (torch >= 2.5), the window as a boolean mask built
        # outside the timing
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(S, device="cuda")[:, None]
            j = torch.arange(S, device="cuda")[None, :]
            mask = (j <= i) & (i - j < window)
        lib_ms, lib_host = time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True), 20)
        del qt, kt, vt, mask
        b_ms, b_by = flash_bound(B, S, H, K, D, window, q.element_size())
        mma = flash_mma_flops(B, S, H, D, window, dtype == bf16)
        work = ("q·kᵀ + p_hi·v + p_lo·v at 989 TFLOP/s bf16" if dtype == bf16
                else "q·kᵀ + p·v at 67 TFLOP/s fp32")
        print(f"[kernel] flash_attention {label} {str(dtype)[6:]}: device "
              f"{ms:.5f} ms ({b_ms / ms:.1%} of the {b_ms:.5f} ms bound, "
              f"{b_by}: {work} over the kept pairs), "
              f"{mma / ms / 1e9:.1f} TFLOP/s over the {mma / 1e9:.1f} GFLOP "
              f"of the tiles it visits, plain {plain_ms:.5f} ms, "
              f"scaled_dot_product_attention ({str(dtype)[6:]}, enable_gqa"
              f"{', window as a mask' if window else ', is_causal'}) "
              f"{lib_ms:.5f} ms; host per call: kernel {host:.5f} ms, "
              f"plain {plain_host:.5f} ms, sdpa {lib_host:.5f} ms")
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    print("[kernel] flash_attention blocks per SM (256 threads each): "
          + ", ".join(f"{str(dt)[6:]} D = {D} {ops.blocks_per_sm(dt, D)}"
                      for dt in (f32, bf16) for D in ops.HEAD_DIMS))
    return row


def _mean(x):
    return float(x.float().mean()) if x.numel() else float("nan")


SLICE2_SPEC = dict(relevance_mode="grad_cos", relevance_ema=0.9,
                   relevance_sketch_dim=SKETCH_DIM,
                   knowledge_quant_block=QUANT_BLOCK)
# the robustness paths: relevance-aware gossip; elastic membership over a
# faulty transport with a staleness cutoff; DDADQN with obs_stats
# relevance on resampled gossip
TOPK_SPEC = dict(topology="random_k", degree=4, resample_every=10,
                 exchange_schedule="relevance_topk", explore_eps=0.1,
                 **SLICE2_SPEC)
FAULTY_SPEC = dict(topology="ring", elastic=True, transport_loss=0.2,
                   transport_corrupt=0.05, transport_retransmit=2,
                   transport_jitter=1, transport_dup=0.05, max_staleness=8,
                   transport_decay=0.95)
CHAOS = dict(kill_prob=0.05, revive_after=3)
OBS_SPEC = dict(topology="random_k", degree=3, resample_every=10,
                exchange_estimator="obs_stats")


def _dqn_config():
    from repro_torch.rl.dqn import DQNConfig
    return DQNConfig(eps_decay=DQN_EPS_DECAY)


def _watch_combine(torch, ddal):
    """Counts, on the device, the agents of each update epoch whose
    store weighed nothing (Σw = 0: the local fallback, or a hold),
    alive agents only; returns the counters."""
    seen = {"updates": 0, "local": torch.zeros((), dtype=torch.int64,
                                               device="cuda")}
    combine = ddal.exchange.combine

    def watched(stores, rel, step):
        gbar, wsum = combine(stores, rel, step)
        alive = ddal._alive_dev[1] if ddal.elastic else None
        empty = wsum <= 0
        if alive is not None:
            empty = empty & alive
        seen["updates"] += int(wsum.numel() if alive is None
                               else ddal._alive_dev[0].sum())
        seen["local"] += empty.sum()
        return gbar, wsum

    ddal.exchange.combine = watched
    return seen


def _run_chaos(ddal, gs, gen, epochs, plan):
    """``epochs`` epochs with the membership events of ``plan`` applied
    between them; returns (gs, {"return": (epochs, n)})."""
    import torch
    from repro_torch.core.chaos import membership_events
    events = {e: (k, r) for e, k, r in membership_events(plan[:epochs])}
    rets = []
    for e in range(epochs):
        if e in events:
            kill, revive = events[e]
            if kill.any():
                gs = ddal.kill(gs, kill)
            if revive.any():
                gs = ddal.revive(gs, revive)
        gs, m = ddal.epoch_step(gs, gen)
        rets.append(m["return"])
    return gs, {"return": torch.stack(rets)}


def main_path_phase(torch, epochs=EPOCHS):
    """The main path at the paper's width, through the entry points a
    user calls: DDA3C (A2C) and DDADQN (dueling double DQN) groups on
    CartPole-v0. Each path's launch counts are zeroed just before its
    run and read just after; returns {kernel: {path: launches}} over the
    paths that drive each kernel."""
    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core import transport
    from repro_torch.core.chaos import chaos_schedule
    from repro_torch.core.ddal import DDAL
    from repro_torch.rl.a2c import init_a2c, make_a2c_callbacks, \
        make_a2c_group
    from repro_torch.rl.dqn import make_dqn_group
    from repro_torch.rl.envs import CartPole

    env = CartPole()
    ring = dict(n_agents=8, threshold=epochs // 3, minibatch=50,
                m_pieces=32, topology="ring", exchange_delay="uniform",
                max_delay=2)
    robust = dict(threshold=epochs // 3, minibatch=50, m_pieces=32)
    plan = chaos_schedule(1, 8, epochs, **CHAOS)
    full2 = dict(n_agents=2, threshold=epochs // 3, minibatch=50,
                 m_pieces=32, topology="full")
    cfg = _dqn_config()

    def a2c(spec, gen):
        return make_a2c_group(env, optim.adamw(3e-3), spec, gen)

    def legacy(spec, gen):
        opt = optim.adamw(3e-3)
        astates, layout = init_a2c(gen, spec.n_agents, env, opt)
        ddal = DDAL(spec, *make_a2c_callbacks(env, opt, layout),
                    use_wavg_kernel=True)
        return ddal, ddal.init(astates)

    def dqn(spec, gen):
        return make_dqn_group(env, optim.adamw(1e-3), spec, gen, cfg)

    # (label, spec, epochs, group constructor, P, membership plan)
    runs = [
        ("n=2 full", GroupSpec(**full2), epochs, a2c, 9155, None),
        ("n=8 ring, uniform delay 2", GroupSpec(**ring), epochs, a2c, 9155,
         None),
        ("n=2 full, legacy wavg", GroupSpec(
            n_agents=2, threshold=epochs // 6, minibatch=25, m_pieces=32,
            topology="full"), epochs // 2, legacy, 9155, None),
        ("n=8 ring, uniform delay 2, sketch 256, int8 128",
         GroupSpec(**ring, **SLICE2_SPEC), epochs, a2c, 9155, None),
        ("dqn n=2 full", GroupSpec(**full2), epochs, dqn, 8835, None),
        ("dqn n=8 ring, uniform delay 2, sketch 256, int8 128",
         GroupSpec(**ring, **SLICE2_SPEC), epochs, dqn, 8835, None),
        ("(a) n=8 relevance_topk k=4 every 10, eps 0.1, sketch 256, "
         "int8 128", GroupSpec(n_agents=8, **robust, **TOPK_SPEC), epochs,
         a2c, 9155, None),
        ("(b) n=8 ring, elastic (chaos 0.05, back after 3), faulty "
         "transport, max_staleness 8, decay 0.95",
         GroupSpec(n_agents=8, **robust, **FAULTY_SPEC), epochs, a2c, 9155,
         plan),
        ("(c) dqn n=4 obs_stats, dynamic k=3 every 10",
         GroupSpec(n_agents=4, **robust, **OBS_SPEC), epochs, dqn, 8835,
         None),
    ]
    by_path = {name: {} for name in KERNELS}
    for label, spec, n_epochs, build, p, chaos in runs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        ddal, gs = build(spec, gen)
        seen = _watch_combine(torch, ddal)
        mismatches = torch.zeros((), dtype=torch.int64, device="cuda")
        checksum_ok = transport.checksum_ok

        def counted_ok(carried, recomputed):
            nonlocal mismatches
            ok = checksum_ok(carried, recomputed)
            mismatches = mismatches + (~ok).sum()
            return ok

        transport.checksum_ok = counted_ok
        tables = set()
        table_of = ddal.exchange.schedule.refresh

        def refresh(step, nbr, rel, alive=None):
            out = table_of(step, nbr, rel, alive)
            tables.add(out.tobytes())
            return out

        ddal.exchange.schedule.refresh = refresh
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            if chaos is None:
                gs, metrics = ddal.run(gs, gen, n_epochs)
            else:
                gs, metrics = _run_chaos(ddal, gs, gen, n_epochs, chaos)
            torch.cuda.synchronize()
        finally:
            transport.checksum_ok = checksum_ok
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
              f", params {tuple(params.shape)}; update epochs whose store "
              f"weighed nothing (alive agents): {int(seen['local'])} of "
              f"{seen['updates']} agent updates "
              f"({int(seen['local']) / max(seen['updates'], 1):.1%}, "
              f"{'local fallback' if ddal.local_fallback else 'held'})")
        if build is legacy:
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
              and params.shape == (spec.n_agents, p),
              f"{label}: non-finite returns / params or wrong shape")
        if build is dqn:
            st = gs.agent_states
            size = st.replay.size
            print(f"[main] {label}: replay sizes {size.tolist()} "
                  f"(minibatch {cfg.batch}), updates {st.step.tolist()}, "
                  f"ε {float(metrics['epsilon'][-1, 0]):.4f} at the end, "
                  f"target params finite "
                  f"{bool(torch.isfinite(st.target_params).all())}")
            check(bool(torch.isfinite(st.target_params).all())
                  and bool((size >= cfg.batch).all()),
                  f"{label}: non-finite target params, or a replay ring "
                  f"below one minibatch (no real gradient)")
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
        if ddal.exchange.schedule.resamples:
            nbr = gs.nbr
            rows_ok = all(len(set(r)) == len(r) for r in nbr.tolist())
            rounds = -(-n_epochs // spec.resample_every)
            print(f"[main] {label}: {len(tables)} distinct gossip tables "
                  f"over {rounds} resample rounds; last table "
                  f"{nbr.tolist()}")
            check(rows_ok and bool((nbr[:, 0] == range(len(nbr))).all())
                  and len(tables) > 1,
                  f"{label}: a gossip table repeats a source, loses its "
                  f"self-loop, or never moved")
        if spec.exchange_estimator == "obs_stats":
            st = gs.relevance
            rel = st.rel
            off = rel[~torch.eye(spec.n_agents, dtype=torch.bool,
                                 device=rel.device)]
            print(f"[main] {label}: obs_stats relevance off the diagonal "
                  f"min {float(off.min()):.4f} max {float(off.max()):.4f}, "
                  f"observations per agent {st.count.tolist()}")
            check(bool(torch.isfinite(rel).all()) and bool((off > 0).all())
                  and bool((off <= 1).all())
                  and bool((st.count > 0).all()),
                  f"{label}: obs_stats relevance not finite or outside "
                  f"(0, 1], or no observation counted")
        if ddal.transport is not None:
            from repro_torch.core.transport import CORRUPT_BIAS
            tp = ddal.transport
            import numpy as np
            foreign = gs.nbr != np.arange(spec.n_agents)[:, None]
            corrupt = sum(int((tp.at(e).corrupt & foreign).sum())
                          for e in range(spec.threshold, n_epochs))
            kills = int((chaos[:-1] & ~chaos[1:]).sum())
            revives = int((~chaos[:-1] & chaos[1:]).sum())
            big = float(gs.stores.grads.abs().max())
            print(f"[main] {label}: {kills} kills and {revives} revivals "
                  f"({int((~chaos).sum())} dead agent-epochs), "
                  f"{corrupt} corrupted sends planned over the sharing "
                  f"epochs (self-loops exempt, dead agents' included), "
                  f"{int(mismatches)} checksum mismatches at delivery "
                  f"(quarantined), delay line of {tp.extra_delay} extra "
                  f"planes; largest |piece| in a store {big:.3e}; alive "
                  f"at the end {gs.alive.astype(int).tolist()}")
            check(big < CORRUPT_BIAS / 2 and int(mismatches) > 0
                  and bool((gs.alive == chaos[n_epochs - 1]).all()),
                  f"{label}: a corrupted piece reached a store, nothing "
                  f"was quarantined, or membership drifted from the plan")
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
            reset_launches()
            gs, _ = ddal.run(gs, None, 9)
            check(launch_counts()["flash_attention"] == 0,
                  f"{label} on {dev}: the DDA3C path launched "
                  f"flash_attention")
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


def robust_equivalence_phase(torch):
    """The robustness paths, the card against the port's CPU path on
    seeded gradients (the same table on both): (a) relevance-aware
    gossip with sketched relevance and int8 planes, and (b) elastic
    membership (a kill at epoch 3, the revival at 6) over the faulty
    transport with staleness. Stores (payloads, scales, T, valid, ptr,
    send epochs) and gossip tables bitwise, parameters rtol 1e-5. Then
    a checkpoint of (b) written on the card is restored into the CPU
    state and both continue 3 epochs: equal again."""
    import os
    import tempfile

    import numpy as np
    from repro_torch import optim
    from repro_torch.checkpoint import npz
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.ddal import DDAL
    from repro_torch.rl.a2c import init_a2c, make_a2c_callbacks
    from repro_torch.rl.envs import CartPole

    n = 6
    base = dict(n_agents=n, threshold=2, minibatch=2, m_pieces=6)
    rng = np.random.default_rng(2)
    grads = rng.normal(size=(12, n, 9155)).astype(np.float32)
    cases = [
        ("(a) n=6 relevance_topk k=3 every 2, eps 0.3, sketch 256, int8 "
         "128", GroupSpec(**base, **dict(TOPK_SPEC, degree=3,
                                         resample_every=2,
                                         explore_eps=0.3)), None),
        ("(b) n=6 ring, elastic, faulty transport, max_staleness 8, decay "
         "0.95", GroupSpec(**base, **dict(FAULTY_SPEC, transport_seed=4,
                                          transport_corrupt=0.2)),
         {3: (np.eye(n, dtype=bool)[1], None),
          6: (None, np.eye(n, dtype=bool)[1])}),
    ]
    for label, spec, events in cases:
        out = {}
        for dev in ("cpu", "cuda"):
            opt = optim.adamw(3e-3)
            astates, layout = init_a2c(torch.Generator().manual_seed(0), n,
                                       CartPole(), opt)
            astates = _to(astates, dev)
            _, apply_grads, params_of = make_a2c_callbacks(CartPole(), opt,
                                                           layout)

            def gen_grads(state, e, dev=dev):
                g = torch.from_numpy(grads[e % 12]).to(dev)
                return g, {"return": g.sum(-1)}, state

            ddal = DDAL(spec, gen_grads, apply_grads, params_of, device=dev,
                        layout=layout)
            gs = ddal.init(astates)
            for e in range(9):
                kill, revive = (events or {}).get(e, (None, None))
                if kill is not None:
                    gs = ddal.kill(gs, kill)
                if revive is not None:
                    gs = ddal.revive(gs, revive)
                gs, _ = ddal.epoch_step(gs, e)
            out[dev] = (ddal, gs, layout)
        (_, g_cpu, layout), (d_gpu, g_gpu, _) = out["cpu"], out["cuda"]

        def same(a, b):
            names = ("grads", "scale", "T", "valid", "ptr", "born")
            st = all(getattr(a.stores, k) is None or torch.equal(
                getattr(a.stores, k).cpu(), getattr(b.stores, k))
                for k in names)
            return (st and np.array_equal(a.nbr, b.nbr)
                    and torch.allclose(a.agent_states.params.cpu(),
                                       b.agent_states.params, rtol=1e-5,
                                       atol=1e-6))

        err = float((g_gpu.agent_states.params.cpu()
                     - g_cpu.agent_states.params).abs().max())
        ok = same(g_gpu, g_cpu)
        print(f"[equiv] {label}, 9 epochs, card vs CPU: stores and gossip "
              f"tables bitwise, params max abs {err:.3e} (rtol 1e-5) -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"card and CPU paths disagree: {label}")
        if events is None:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "group.npz")
            npz.save_group(path, g_gpu, layout, step=9)
            back = npz.restore_group(path, g_cpu, layout)
        d_cpu = out["cpu"][0]
        for e in range(9, 12):
            back, _ = d_cpu.epoch_step(back, e)
            g_gpu, _ = d_gpu.epoch_step(g_gpu, e)
        ok = back.epoch == 12 and same(g_gpu, back)
        err = float((g_gpu.agent_states.params.cpu()
                     - back.agent_states.params).abs().max())
        print(f"[equiv] {label}: checkpoint written on the card at epoch 9, "
              f"restored on the CPU, both continued 3 epochs: stores "
              f"bitwise, params max abs {err:.3e} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "a checkpoint written on the card does not continue "
                  "equal on the CPU")


def _to(x, dev):
    """A nest of tensors, dicts and NamedTuples moved to ``dev``."""
    if hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x.to(dev)


def dqn_equivalence_phase(torch):
    """DDADQN, the card against the port's CPU path on the same inputs:
    a small ring group (n = 4, delay 1, ``target_period=2``, 9 epochs)
    fed seeded gradients through DQN's ``apply_grads`` and DDAL, with
    parameters and target parameters within rtol 1e-5 and the stores
    bitwise; and ``dqn_loss`` with its gradient on one seeded replay
    batch within rtol 1e-5."""
    import numpy as np
    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.core.ddal import DDAL
    from repro_torch.rl import dqn
    from repro_torch.rl.envs import CartPole

    spec = GroupSpec(n_agents=4, threshold=2, minibatch=2, m_pieces=4,
                     topology="ring", exchange_delay="uniform", max_delay=1)
    cfg = dqn.DQNConfig(capacity=256, target_period=2)
    env = CartPole()
    rng = np.random.default_rng(1)
    grads = rng.normal(size=(12, 4, 8835)).astype(np.float32)
    astates, layout = dqn.init_dqn(torch.Generator().manual_seed(0), 4, env,
                                   optim.adamw(1e-3), cfg)
    results = {}
    for dev in ("cpu", "cuda"):
        _, apply_grads, params_of = dqn.make_dqn_callbacks(
            env, optim.adamw(1e-3), cfg, layout)
        calls = []

        def gen_grads(state, gen, dev=dev, calls=calls):
            g = torch.from_numpy(grads[len(calls) % 12]).to(dev)
            calls.append(1)
            return g, {"return": g.sum(-1)}, state

        ddal = DDAL(spec, gen_grads, apply_grads, params_of, device=dev,
                    layout=layout)
        gs, _ = ddal.run(ddal.init(_to(astates, dev)), None, 9)
        st = gs.agent_states
        results[dev] = [st.params.cpu(), st.target_params.cpu(),
                        gs.stores.grads.cpu(), st.step.cpu()]
    (p_g, t_g, s_g, n_g), (p_c, t_c, s_c, n_c) = results["cuda"], \
        results["cpu"]
    err = max(float((p_g - p_c).abs().max()), float((t_g - t_c).abs().max()))
    ok = (torch.allclose(p_g, p_c, rtol=1e-5, atol=1e-6)
          and torch.allclose(t_g, t_c, rtol=1e-5, atol=1e-6)
          and torch.equal(s_g, s_c) and torch.equal(n_g, n_c)
          and not torch.equal(t_c, astates.target_params))
    print(f"[equiv] dqn ring n=4, delay 1, target period 2, 9 epochs, card "
          f"vs CPU: params and target params max abs {err:.3e} (rtol 1e-5), "
          f"updates {n_c.tolist()}, stores bitwise {torch.equal(s_g, s_c)} "
          f"-> {'ok' if ok else 'FAIL'}")
    check(ok, "card and CPU paths disagree on a small DDADQN group")

    # dqn_loss and its gradient on one seeded batch
    B = 64
    batch = (rng.normal(size=(4, B, 4)).astype(np.float32),
             rng.integers(0, 2, (4, B)),
             rng.normal(size=(4, B)).astype(np.float32),
             rng.normal(size=(4, B, 4)).astype(np.float32),
             rng.random((4, B)) < 0.2)
    target = astates.params + 0.01 * torch.from_numpy(
        rng.normal(size=astates.params.shape).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        flat = astates.params.to(dev).requires_grad_(True)
        loss = dqn.dqn_loss(layout.unflatten(flat),
                            layout.unflatten(target.to(dev)),
                            tuple(torch.from_numpy(np.asarray(x)).to(dev)
                                  for x in batch), cfg.gamma)
        (g,) = torch.autograd.grad(loss.sum(), flat)
        out[dev] = (loss.detach().cpu(), g.cpu())
    (l_g, g_g), (l_c, g_c) = out["cuda"], out["cpu"]
    scale = float(g_c.abs().max())
    ok = (torch.allclose(l_g, l_c, rtol=1e-5, atol=1e-6)
          and torch.allclose(g_g, g_c, rtol=1e-5, atol=1e-6 * scale))
    print(f"[equiv] dqn_loss, 4 agents x {B} steps, card vs CPU: loss max "
          f"abs {float((l_g - l_c).abs().max()):.3e}, gradient max abs "
          f"{float((g_g - g_c).abs().max()):.3e} of max {scale:.3e} "
          f"(rtol 1e-5, atol 1e-6 of the max) -> {'ok' if ok else 'FAIL'}")
    check(ok, "card and CPU disagree on dqn_loss or its gradient")


def profile_phase(torch):
    """Device busy share and time by op over a few main-path epochs, for
    the quickstart group, for the fourth main-path run's configuration
    (learned sketched relevance, int8 planes) and for the DDADQN n = 2
    group."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim
    from repro_torch.configs.base import GroupSpec
    from repro_torch.rl.a2c import make_a2c_group
    from repro_torch.rl.dqn import make_dqn_group
    from repro_torch.rl.envs import CartPole

    def a2c(spec, gen):
        return make_a2c_group(CartPole(), optim.adamw(3e-3), spec, gen)

    def dqn(spec, gen):
        return make_dqn_group(CartPole(), optim.adamw(1e-3), spec, gen,
                              _dqn_config())

    configs = [
        ("n=2 full", GroupSpec(n_agents=2, threshold=2, minibatch=2,
                               m_pieces=32), a2c),
        ("n=8 ring, delay 2, sketch 256, int8 128", GroupSpec(
            n_agents=8, threshold=2, minibatch=2, m_pieces=32,
            topology="ring", exchange_delay="uniform", max_delay=2,
            **SLICE2_SPEC), a2c),
        ("dqn n=2 full", GroupSpec(n_agents=2, threshold=2, minibatch=2,
                                   m_pieces=32), dqn),
        ("(b) n=8 ring, elastic, faulty transport, max_staleness 8",
         GroupSpec(n_agents=8, threshold=2, minibatch=2, m_pieces=32,
                   **FAULTY_SPEC), a2c),
    ]
    for label, spec, build in configs:
        gen = torch.Generator(device="cuda").manual_seed(0)
        ddal, gs = build(spec, gen)
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
                or "sketch_" in r[0] or "ssd_chunk_" in r[0]]

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
        for key, count, dev_us, cpu_us in [r for r in rows if r[2] > 0][:8]:
            print(f"[profile]   by device time: {key[:60]}: {count} calls, "
                  f"device {dev_us:.0f} us, host {cpu_us:.0f} us")


def _llama_batch(torch, cfg, B, S, seed=0):
    """B rows of S ids drawn by ``np.random.default_rng(seed)`` over the
    vocabulary, the next ids as labels, positions 0..S−1, on the card."""
    import numpy as np
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                               (B, S + 1), dtype=np.int32)
    pos = torch.arange(S, dtype=torch.int32, device="cuda").expand(B, S)
    return {"tokens": torch.from_numpy(ids[:, :-1].copy()).cuda(),
            "labels": torch.from_numpy(ids[:, 1:].copy()).cuda(),
            "positions": pos}


def score_phase(torch, cfg, params):
    """The scoring path: llama3.2-3b at its published widths and depth
    (fp32 weights drawn from seed 0, bf16 compute) scores B = 2 rows of
    S = 4096 ids through ``get_model(cfg).forward(..., None)`` and
    ``.loss`` under ``torch.no_grad()``: one warm-up pass, then, with
    the launch counts zeroed, one forward (logits checked) and
    SCORE_PASSES timed loss passes. Returns {kernel: {path: launches}}."""
    from repro_torch.models import get_model

    model = get_model(cfg)
    batch = _llama_batch(torch, cfg, SCORE_B, SCORE_S)
    with torch.no_grad():
        model.loss(cfg, params, batch)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        logits, cache = model.forward(cfg, params, batch, None)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        del logits
        times, losses = [], []
        for _ in range(SCORE_PASSES):
            t0 = time.perf_counter()
            loss = model.loss(cfg, params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    passes = 1 + SCORE_PASSES
    ms = [t * 1e3 for t in times]
    tokens = SCORE_B * SCORE_S
    best = min(ms)
    print(f"{SCORE_LABEL}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, fp32 "
          f"weights, {cfg.compute_dtype} compute; {SCORE_B} x {SCORE_S} "
          f"tokens; loss passes ms " + ", ".join(f"{t:.2f}" for t in ms)
          + f" (best {best:.2f}: {tokens / best * 1e3:,.0f} tokens/s); "
          f"loss " + ", ".join(f"{x:.5f}" for x in losses)
          + f" (ln V = {math.log(cfg.vocab_size):.5f}, ln V + "
          f"d_model·0.02²/2 = "
          f"{math.log(cfg.vocab_size) + cfg.d_model * 2e-4:.5f}); logits "
          f"{shape} "
          f"finite {finite}; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"{passes} passes, launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items()))
    want = {name: 0 for name in KERNELS}
    want["flash_attention"] = cfg.n_layers * passes
    check(launched == want, f"{SCORE_LABEL}: launches {launched} != {want} "
                            f"({cfg.n_layers} layers x {passes} passes)")
    check(cache is None and finite
          and shape == (SCORE_B, SCORE_S, cfg.vocab_size),
          f"{SCORE_LABEL}: non-finite or misshapen logits, or a cache")
    # random weights: after the final norm the logits have variance
    # d_model·0.02² (1.23), so the loss sits near ln V + 0.61 = 12.38
    ln_v = math.log(cfg.vocab_size)
    check(all(math.isfinite(x) and ln_v - 0.5 < x < ln_v + 1.5
              for x in losses) and max(losses) - min(losses) < 1e-3,
          f"{SCORE_LABEL}: loss {losses} not within (ln V − 0.5, ln V + "
          f"1.5) or not repeatable")
    return {"flash_attention": {SCORE_LABEL: launched["flash_attention"]}}


def serve_phase(torch, argv, label):
    """A serving path at its arch's published widths and depth, through
    ``repro_torch.launch.serve`` called as a function with ``argv`` (4
    requests of up to 1023 prompt tokens, 2 slots, 32 greedy tokens),
    with every kernel's launch count zeroed just before the call and
    read just after: mamba2-780m's prefill runs the SSD kernel in every
    layer, llama3.2-3b's none (prefill passes a cache, as in the
    reference). Returns ({kernel: {path: launches}}, prompts)."""
    import contextlib
    import io

    from repro_torch.configs import get_arch_config
    from repro_torch.launch import serve

    cfg = get_arch_config(argv[argv.index("--arch") + 1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out):
        report = serve.main(argv)
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
    if cfg.family == "ssm":
        s = cfg.ssm
        want["ssd_intra_chunk"] = cfg.n_layers * calls
        widths = (f"{s.expand * cfg.d_model // s.head_dim} SSD heads of "
                  f"{s.head_dim}, d_state {s.d_state}, chunk {s.chunk}")
    else:
        widths = (f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads of "
                  f"{cfg.head_dim}, d_ff {cfg.d_ff}")
    lens = [len(pr) for pr in report["prompts"]]
    print(f"{label}: {cfg.n_layers} layers, d_model {cfg.d_model}, {widths}"
          f", vocab {cfg.vocab_size}, {cfg.compute_dtype} compute; "
          f"{len(lens)} requests, prompt lengths {lens}, {calls} prefill "
          f"calls; prefill ms per batch "
          + ", ".join(f"{ms:.2f}" for ms in report["prefill_ms"])
          + f" (the first includes the card's warm-up); decode "
          f"{report['decode_tok_s']:.1f} tok/s over "
          f"{sum(report['decode_s']):.3f} s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items()))
    check(launched == want, f"{label}: launches {launched} != {want} "
                            f"({cfg.n_layers} layers x {calls} prefills)")
    outs = report["outputs"]
    check(calls == 2 and len(outs) == 2
          and all(o.shape == (2, 32) and o.dtype == torch.int32
                  and bool(((o >= 0) & (o < cfg.vocab_size)).all())
                  for o in outs),
          f"{label}: not 4 requests x 32 tokens in the vocabulary")
    check(all(lg.shape == (2, cfg.vocab_size)
              and bool(torch.isfinite(lg.float()).all())
              for lg in report["first_logits"]),
          f"{label}: non-finite or misshapen prefill logits")
    return ({name: {label: launched[name]} for name, n in want.items() if n},
            report["prompts"])


def _cut_to_two_layers(torch, arch):
    """``arch`` at its published widths cut to 2 layers with fp32
    compute, and its weights drawn on the host from seed 0."""
    from repro_torch.configs import get_arch_config
    from repro_torch.models import get_model

    cfg = get_arch_config(arch).with_(n_layers=2, compute_dtype="float32")
    return cfg, get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                    "cpu")


def equiv_serve_phase(torch, arch, prompts, cut=None):
    """The card against the port's CPU path on the [serve] prompts, at
    ``arch``'s widths cut to 2 layers with fp32 compute, on the same
    weights (drawn on the host, copied to the card): prefill logits
    within rtol = atol = 1e-4 (matmuls and, for mamba2-780m, the SSD
    kernel sum in another fp32 order than the CPU), the 32 greedy
    tokens of every request equal; the SSD kernel launched once per
    layer per prefill on the card for mamba2-780m, no kernel for
    llama3.2-3b (its prefill passes a cache), none on the CPU."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    cfg, params = cut or _cut_to_two_layers(torch, arch)
    serve = ServeConfig(max_len=1056, max_new_tokens=32)
    results, launched, secs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        engine = ServeEngine(cfg, tree_map(lambda t: t.to(dev), params),
                             serve)
        reset_launches()
        t0 = time.perf_counter()
        results[dev] = []
        for toks, lens in serve_batches(prompts, 2, device="cpu"):
            logits, cache = engine.prefill(toks.to(dev), lens)
            out = engine.decode(logits, cache, lens)
            results[dev].append((logits.cpu(), out.cpu()))
        secs[dev] = time.perf_counter() - t0
        launched[dev] = launch_counts()
    errs, rels, same = [], [], True
    for (lg_c, out_c), (lg_g, out_g) in zip(results["cpu"], results["cuda"]):
        d = (lg_g - lg_c).abs()
        errs.append(float(d.max()))
        rels.append(float((d / lg_c.abs().clamp_min(1e-30)).max()))
        same = same and torch.equal(out_g, out_c)
    want = {name: 0 for name in KERNELS}
    want_cuda = dict(want)
    if cfg.family == "ssm":
        want_cuda["ssd_intra_chunk"] = cfg.n_layers * len(errs)
    ok = (all(torch.allclose(g[0], c[0], rtol=1e-4, atol=1e-4) for g, c in
              zip(results["cuda"], results["cpu"])) and same
          and launched == {"cpu": want, "cuda": want_cuda})
    print(f"[equiv] serve {arch} widths, 2 layers, fp32, {len(prompts)} "
          f"requests x 32 greedy tokens, card vs CPU: prefill logits max abs "
          f"{max(errs):.3e} (max rel {max(rels):.3e}; rtol=atol=1e-4), "
          f"greedy tokens equal {same}, card launches "
          + ", ".join(f"{k} {v}" for k, v in launched["cuda"].items())
          + f"; CPU {secs['cpu']:.1f} s, card {secs['cuda']:.1f} s "
          f"-> {'ok' if ok else 'FAIL'}")
    check(ok, f"card and CPU serving paths disagree: {arch}")


def equiv_score_phase(torch, cut):
    """The scoring path on the card against the port's CPU path at
    llama3.2-3b's widths cut to 2 layers with fp32 compute, on the same
    weights, 2 rows of 320 ids: logits within rtol = atol = 1e-4 and
    the loss within 1e-5 (the flash kernel, on the card, against its
    plain version, on the CPU, and matmuls summed in other orders); the
    kernel launched once per layer on the card, never on the CPU."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import get_model

    cfg, params = cut
    model = get_model(cfg)
    batch = {k: t.cpu() for k, t in _llama_batch(torch, cfg, 2, 320,
                                                 seed=1).items()}
    out, launched = {}, {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            b = {k: t.to(dev) for k, t in batch.items()}
            reset_launches()
            logits, _ = model.forward(cfg, p, b, None)
            out[dev] = (logits.cpu(), float(model.loss(cfg, p, b)))
            launched[dev] = launch_counts()["flash_attention"]
    d = (out["cuda"][0] - out["cpu"][0]).abs()
    loss_err = abs(out["cuda"][1] - out["cpu"][1])
    ok = (torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
          and loss_err <= 1e-5 * abs(out["cpu"][1])
          and launched == {"cpu": 0, "cuda": 2 * cfg.n_layers})
    print(f"[equiv] score {LLAMA} widths, 2 layers, fp32, 2 x 320 ids, card "
          f"vs CPU: logits max abs {float(d.max()):.3e} (rtol=atol=1e-4), "
          f"loss {out['cuda'][1]:.6f} vs {out['cpu'][1]:.6f} (rel 1e-5), "
          f"flash_attention launches {launched} (forward + loss) -> "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "card and CPU scoring paths disagree")


def profile_serve_phase(torch, prompts, ssd_kernels):
    """The device's busy share and the ops that take the time at full
    width, after a warm-up: one prefill of the first [serve] batch in
    one profiler window, with the time of every kernel of the SSD
    library (``ssd_kernels``: the instances ptxas reported when it was
    built), 4 decode steps in another; then the same split on the host
    clock with the profiler off."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch_config
    from repro_torch.kernels.cuda_build import short_name
    from repro_torch.models import get_model
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    cfg = get_arch_config("mamba2-780m")
    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    engine = ServeEngine(cfg, params, ServeConfig(max_len=128,
                                                  max_new_tokens=5))
    toks, lens = serve_batches(prompts[:2], 2, device="cpu")[0]
    toks = toks.to("cuda")
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
        ssd = [r for r in rows if short_name(r[0]) in ssd_kernels]
        ssd_us = sum(r[2] for r in ssd)
        print(f"[profile] serve mamba2-780m {label}, batch of "
              f"{toks.shape[0]} x {toks.shape[1]} prompt tokens: wall "
              f"{wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms "
              f"({busy_us / (wall * 1e6):.1%}), {len(kernels)} device "
              f"kernels, the SSD library's kernels {ssd_us / 1e3:.3f} ms "
              f"({ssd_us / max(busy_us, 1e-9):.1%} of the busy time) in "
              f"{sum(r[1] for r in ssd)} calls of "
              f"{sorted(short_name(r[0]) for r in ssd)}")
        if label == "prefill":
            check(bool(ssd), f"no kernel of the SSD library in the prefill "
                             f"profile (its kernels: {sorted(ssd_kernels)})")
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


def profile_score_phase(torch, cfg, params, flash_kernels):
    """The device's busy share and the ops that take the time over one
    full-width scoring pass (the loss of SCORE_B x SCORE_S ids), after
    the warm-up of the [score] phase, with the share of the busy time of
    every kernel of the flash library (``flash_kernels``: the instances
    ptxas reported when it was built, whatever they are named)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cuda_build import short_name
    from repro_torch.models import get_model

    model = get_model(cfg)
    batch = _llama_batch(torch, cfg, SCORE_B, SCORE_S)
    with torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.loss(cfg, params, batch)
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
    fa = [r for r in rows if short_name(r[0]) in flash_kernels]
    fa_us = sum(r[2] for r in fa)
    print(f"[profile] score {LLAMA}, one loss pass over {SCORE_B} x "
          f"{SCORE_S} ids: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / (wall * 1e6):.1%}), "
          f"{len(kernels)} device kernels, the flash library's kernels "
          f"{fa_us / 1e3:.3f} ms ({fa_us / max(busy_us, 1e-9):.1%} of the "
          f"busy time) in {sum(r[1] for r in fa)} calls of "
          f"{sorted(short_name(r[0]) for r in fa)}")
    check(bool(fa), f"{SCORE_LABEL}: no kernel of the flash library in the "
                    f"profile (its kernels: {sorted(flash_kernels)})")
    for what, col in (("device", 2), ("self host", 3)):
        for key, count, dev_us, cpu_us in sorted(rows,
                                                 key=lambda r: -r[col])[:8]:
            print(f"[profile]   by {what} time: {key[:60]}: {count} calls, "
                  f"device {dev_us:.0f} us, self host {cpu_us:.0f} us")


# ---------------------------------------------------------------------
# continuous batching and multi-tenant group serving
# ---------------------------------------------------------------------
SLOT_ARCH = "mamba2-780m"


class _StepClock:
    """Host ms of every ``SlotBatch.step`` while installed: each step
    ends with its one device→host copy, so its host time is the step's
    time."""

    def __init__(self):
        from repro_torch.serving import continuous
        self._cls, self.ms = continuous.SlotBatch, []
        self._orig = self._cls.step

    def __enter__(self):
        orig, ms = self._orig, self.ms

        def timed(slots, *args, **kw):
            t0 = time.perf_counter()
            out = orig(slots, *args, **kw)
            ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self._cls.step = timed
        return self

    def __exit__(self, *exc):
        self._cls.step = self._orig

    def summary(self) -> str:
        ms = sorted(self.ms)
        return (f"{len(ms)} steps, ms per step median "
                f"{ms[len(ms) // 2]:.2f}, min {ms[0]:.2f}, max {ms[-1]:.2f}")


def _padded_prompt(torch, cfg, prompt, prompt_pad, max_len):
    """(1, W) ids on the card and host lengths of ``prompt`` padded to
    the width the slot engines prefill it at."""
    from repro_torch.serving.continuous import prefill_width
    toks = torch.zeros((1, prefill_width(cfg, prompt_pad, len(prompt),
                                         max_len)), dtype=torch.int32)
    toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    return toks.to("cuda"), [len(prompt)]


def _alone(torch, cfg, params, serve, prompt, prompt_pad):
    """The fixed-batch ServeEngine's greedy tokens for ``prompt`` alone
    (B = 1), padded as the slot engines pad it, and the logits (V,) of
    each decode step, on the host."""
    import dataclasses

    from repro_torch.serving import ServeEngine
    toks, lens = _padded_prompt(torch, cfg, prompt, prompt_pad,
                                serve.max_len)
    engine = ServeEngine(cfg, params, serve)
    rows = []

    def decode(*args):
        logits, cache = model_decode(*args)
        rows.append(logits[0, -1].float().clone())
        return logits, cache

    model_decode = engine.model.decode
    engine.model = dataclasses.replace(engine.model, decode=decode)
    logits, cache = engine.prefill(toks, lens)
    out = engine.decode(logits, cache, lens)[0].tolist()
    return out, [r.cpu() for r in rows]


class _SlotLogits:
    """Each request's decode-step logits (V,) in a slot engine: wraps
    the engine's decode (``attr``) and keeps the rows on the card until
    :meth:`rows` (no copy inside a step)."""

    def __init__(self, engine, attr, slots_of):
        self.engine, self.attr, self._slots_of = engine, attr, slots_of
        self._orig = getattr(engine, attr)
        self._steps = []
        assert attr not in vars(engine)        # a method of the class

        def wrapped(*args):
            live = {i: s.request_id for i, s in
                    enumerate(self._slots_of()) if not s.done}
            logits, cache = self._orig(*args)
            self._steps.append((live, logits[:, -1].float().clone()))
            return logits, cache

        setattr(engine, attr, wrapped)

    def remove(self):
        # back to the class's method: no engine → wrapper → engine cycle
        # keeps the engine's planes alive past the phase
        delattr(self.engine, self.attr)

    def rows(self):
        out = {}
        for live, logits in self._steps:
            host = logits.cpu()
            for i, rid in live.items():
                out.setdefault(rid, []).append(host[i])
        self._steps = []
        return out


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


FP32_LOGITS = 1e-3     # × max|logit|, full depth in fp32 compute


def _agree(got, want, got_rows, want_rows, gate=None):
    """Whether a slot engine's greedy tokens agree with the fixed-batch
    engine's on the same prompt and weights. The first token comes from
    the same B = 1 prefill and must be equal. The slot engines' decode
    products run other cuBLAS kernels (per-slot weights as a batched
    product, B rows instead of 1), which sum in other orders; with
    ``gate`` (× max|logit|) every decode step's logits up to the first
    token that differs must lie within it of the fixed-batch engine's,
    and a differing token must be a near tie: the fixed-batch engine's
    logit for the slot engine's token within twice that step's largest
    logit difference of its best. Returns (ok, what, the largest step
    difference over max|logit| before the tokens part)."""
    t = _first_diff(got, want)
    n = len(want) - 1 if t is None else t
    if t == 0 or len(got_rows) < n or len(want_rows) < n:
        return False, f"first token or step count differs (at {t})", 1.0
    share = 0.0
    for s in range(n):
        d = float((got_rows[s] - want_rows[s]).abs().max())
        share = max(share, d / float(want_rows[s].abs().max()))
        if gate is not None and share > gate:
            return False, f"step {s + 1} logits apart by {d:.3e}", share
    if t is None:
        return True, "equal", share
    w = want_rows[t - 1]
    gap = float(w[want[t]] - w[got[t]])
    d = float((got_rows[t - 1] - w).abs().max())
    return (gate is None or gap <= 2 * d,
            f"from token {t} (gap {gap:.3e}, logits apart by {d:.3e})",
            share)


def _agreement(results, rows, alone, gate=None):
    """``_agree`` for every request ({rid: (tokens, rows)} of the
    fixed-batch engine in ``alone``) → (summary, the requests that
    disagree)."""
    verdicts = {rid: _agree(results.get(rid, []), alone[rid][0],
                            rows.get(rid, []), alone[rid][1], gate)
                for rid in alone}
    equal = sum(v[1] == "equal" for v in verdicts.values())
    apart = {rid: v[1] for rid, v in verdicts.items()
             if v[0] and v[1] != "equal"}
    bad = {rid: v[1] for rid, v in verdicts.items() if not v[0]}
    text = (f"first tokens equal in {len(alone) - len(bad)} of "
            f"{len(alone)}, all tokens in {equal}"
            + (f", apart {apart}" if apart else "")
            + f"; step logits apart by at most "
              f"{max(v[2] for v in verdicts.values()):.2e} of max|logit| "
              f"before the tokens part"
            + ("" if gate is None else f" (gate {gate:g})"))
    return text, bad


def continuous_phase(torch):
    """[continuous] mamba2-780m at its published widths and depth:
    8 requests drawn as the launcher draws them (seed 0, prompt-len
    1024) through 2 slots (prompt_pad 16, max_len 1056, 32 greedy
    tokens), kernel counts zeroed just before and read just after: every
    request completes, each one's first token equals the fixed-batch
    ServeEngine's on that prompt alone (the same B = 1 prefill; how many
    requests agree in every token and how far the step logits drift in
    bf16 is printed, ``_agree``), and the SSD kernel runs 48 times per
    admission (one B = 1 prefill each)."""
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.models import get_model
    from repro_torch.serving import ContinuousBatcher, ServeConfig

    label = f"[continuous] {SLOT_ARCH}"
    cfg = get_arch_config(SLOT_ARCH)
    params = get_model(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = draw_prompts(cfg.vocab_size, 8, 1024, 0)
    serve = ServeConfig(max_len=1056, max_new_tokens=32)
    batcher = ContinuousBatcher(cfg, params, serve, batch_size=2,
                                prompt_pad=16)
    recorder = _SlotLogits(batcher, "_decode", lambda: batcher.slots)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _StepClock() as clock:
        t0 = time.perf_counter()
        out = batcher.run(prompts)
        secs = time.perf_counter() - t0
    recorder.remove()
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in KERNELS}
    want["ssd_intra_chunk"] = cfg.n_layers * len(prompts)
    alone = {rid: _alone(torch, cfg, params, serve, pr, 16)
             for rid, pr in enumerate(prompts)}
    text, bad = _agreement(out, recorder.rows(), alone)
    print(f"{label}: {len(prompts)} requests (prompt lengths "
          f"{[len(p) for p in prompts]}) through 2 slots, 32 greedy tokens, "
          f"in {secs:.2f} s; decode {clock.summary()}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f"; {text}")
    check(sorted(out) == list(range(len(prompts)))
          and all(len(v) == 32 for v in out.values()),
          f"{label}: not every request completed with 32 tokens")
    check(launched == want, f"{label}: launches {launched} != {want} "
                            f"({cfg.n_layers} layers x {len(prompts)} "
                            f"admissions)")
    check(not bad, f"{label}: first tokens differ from the fixed-batch "
                   f"engine's: {bad}")
    return {"ssd_intra_chunk": {label: launched["ssd_intra_chunk"]}}


def _single_agent_steps(torch, cfg, params, serve, prompts, slots):
    """Decode-step times of the single-tenant ContinuousBatcher at
    ``slots`` slots on ``prompts``."""
    from repro_torch.serving import ContinuousBatcher
    with _StepClock() as clock:
        ContinuousBatcher(cfg, params, serve, batch_size=slots,
                          prompt_pad=16).run(prompts)
    return clock


def _product_probe(torch, cfg, planes, slots):
    """Whether cuBLAS gives a row the same sums in the group step's
    per-slot batched product, (slots, 1, K) @ (slots, K, N), as in the
    fixed-batch engine's (slots, K) @ (K, N), for each matrix of
    agent 0's layer 0 at the compute dtype, on seeded rows → (bitwise
    count, total, the (name, K, N) that differ)."""
    from repro_torch.common.pytree import tree_leaves_with_paths
    gen = torch.Generator(device="cuda").manual_seed(0)
    cdt = cfg.dtype("compute")
    differ, total = [], 0
    for path, leaf in tree_leaves_with_paths(planes["layers"]):
        if leaf.ndim != 4 or "conv" in str(path[-2]):   # (A, L, K, N)
            continue                                    # products only
        w = leaf[0, 0].to(cdt)
        K, N = w.shape
        x = torch.randn((slots, 1, K), generator=gen, device="cuda").to(cdt)
        total += 1
        if not torch.equal(x @ w, x @ w.expand(slots, K, N).contiguous()):
            differ.append(("/".join(map(str, path)), K, N))
    return total - len(differ), total, differ


def group_phase(torch, arch, n_agents, slots, n_requests):
    """[group] ``arch`` at its published widths and depth: ``n_agents``
    agents' fp32 planes (agent a from seed a), ``slots`` slots,
    ``n_requests`` requests (the launcher's draw, seed 0, prompt-len
    1024) round-robin over the agents, 16 greedy tokens, and planes from
    seeds 100 + a published (handed over) after half the requests
    finished. Every request's first token equals the single-agent
    ServeEngine's on the planes of the version it was admitted under
    (agreement in every token and the bf16 drift printed, ``_agree``;
    ``[exact]`` holds every token in fp32); requests admitted after the
    swap carry version 1;
    SSD launches 48 per admission for mamba2-780m, none for
    llama3.2-3b. Then one step
    with every slot live and nothing queued, under
    ``torch.cuda.set_sync_debug_mode("warn")``: exactly one
    synchronizing call (the step's device→host copy)."""
    import warnings

    from repro_torch.common.pytree import tree_leaves_with_paths, tree_map
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import agent_planes, draw_prompts
    from repro_torch.serving import (GroupRequest, GroupServeEngine,
                                     ParamStore, ServeConfig, ServeMetrics)

    label = f"[group] {arch}"
    cfg = get_arch_config(arch)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    store = ParamStore(agent_planes(cfg, n_agents, 0, "cuda"), donate=True)
    planes_by_version = {0: store.acquire()[0]}
    serve = ServeConfig(max_len=1056, max_new_tokens=16)
    metrics = ServeMetrics()
    engine = GroupServeEngine(cfg, store, serve, batch_size=slots,
                              prompt_pad=16, metrics=metrics)
    prompts = draw_prompts(cfg.vocab_size, n_requests, 1024, 0)
    reqs = [GroupRequest(rid, rid % n_agents, pr)
            for rid, pr in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    recorder = _SlotLogits(engine, "decode_step", lambda: engine._slots)
    reset_launches()
    finished, swapped = 0, False
    with _StepClock() as clock:
        t0 = time.perf_counter()
        while not engine.idle:
            finished += len(engine.step())
            if not swapped and finished >= n_requests // 2:
                store.publish(agent_planes(cfg, n_agents, 100, "cuda"),
                              donate=True)
                metrics.observe_swap()
                planes_by_version[1] = store.acquire()[0]
                swapped = True
        secs = time.perf_counter() - t0
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    recorder.remove()
    want = {name: 0 for name in KERNELS}
    if cfg.family == "ssm":
        want["ssd_intra_chunk"] = cfg.n_layers * n_requests
    results = dict(engine.results)
    versions = {r.rid: metrics.traces[r.rid].version for r in reqs}
    alone = {r.rid: _alone(torch, cfg,
                           tree_map(lambda p: p[r.agent_id],
                                    planes_by_version[versions[r.rid]]),
                           serve, list(r.prompt), 16) for r in reqs}
    text, bad = _agreement(results, recorder.rows(), alone)
    after = [rid for rid, v in versions.items() if v == 1]
    single = _single_agent_steps(
        torch, cfg, tree_map(lambda p: p[0], planes_by_version[1]), serve,
        prompts[:2 * slots], slots)
    # one step with every slot live and nothing queued
    engine.reset()
    for r in reqs[:slots]:
        engine.submit(r)
    engine.step()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    engine.drain()
    gb = sum(t.numel() * t.element_size() for _, t in
             tree_leaves_with_paths(planes_by_version[0])) / 1e9
    same_sums, n_mats, differ = _product_probe(torch, cfg,
                                               planes_by_version[0], slots)
    print(f"{label}: {n_agents} agents' fp32 planes ({gb:.2f} GB), {slots} "
          f"slots, {n_requests} requests round-robin, 16 greedy tokens, "
          f"publish after {n_requests // 2} finished, in {secs:.2f} s; group "
          f"{clock.summary()}; single-agent ContinuousBatcher at {slots} "
          f"slots: {single.summary()}; peak memory {peak / 2 ** 30:.3f} GiB; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f"; versions by request {[versions[r.rid] for r in reqs]}; "
          f"against the single-agent ServeEngine on the admitted version's "
          f"planes: {text} (cuBLAS sums a row alike in the per-slot and "
          f"the fixed-batch product for {same_sums} of {n_mats} layer "
          f"matrices; differ: {differ}); synchronizing calls in one full "
          f"step: "
          f"{len(syncs)}" + ("" if len(syncs) == 1 else f" {syncs}"))
    check(sorted(results) == list(range(n_requests))
          and all(len(v) == 16 for v in results.values()),
          f"{label}: not every request completed with 16 tokens")
    check(launched == want, f"{label}: launches {launched} != {want}")
    check(swapped and after and all(v == 1 for v in
                                    list(versions.values())[min(after):]),
          f"{label}: requests admitted after the swap do not carry "
          f"version 1: {versions}")
    check(not bad, f"{label}: first tokens differ from the single-agent "
                   f"engine's: {bad}")
    check(len(syncs) == 1, f"{label}: {len(syncs)} synchronizing calls in "
                           f"one step, not the one copy: {syncs}")
    if cfg.family != "ssm":
        return {}
    return {"ssd_intra_chunk": {label: launched["ssd_intra_chunk"]}}


def exact_slots_phase(torch, arch, n_agents):
    """[exact] ``arch`` at its published widths and depth with fp32
    compute, where a different order of sums moves logits by ulps, not
    by bf16 units: ``n_agents`` requests (the launcher's draw, seed 0,
    prompt-len 1024), 8 greedy tokens, through the ContinuousBatcher (2
    slots, agent 0's weights) and the GroupServeEngine (one request per
    agent, one slot each); every request's tokens equal the fixed-batch
    ServeEngine's on its agent's weights, a near tie excepted, and every
    decode step's logits within FP32_LOGITS · max|logit| of its."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import agent_planes, draw_prompts
    from repro_torch.serving import (ContinuousBatcher, GroupRequest,
                                     GroupServeEngine, ParamStore,
                                     ServeConfig)

    cfg = get_arch_config(arch).with_(compute_dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    planes = agent_planes(cfg, n_agents, 0, "cuda")
    serve = ServeConfig(max_len=1056, max_new_tokens=8)
    prompts = draw_prompts(cfg.vocab_size, n_agents, 1024, 0)
    agent = [lambda p, a=a: p[a] for a in range(n_agents)]
    batcher = ContinuousBatcher(cfg, tree_map(agent[0], planes), serve,
                                batch_size=2, prompt_pad=16)
    rec = _SlotLogits(batcher, "_decode", lambda: batcher.slots)
    out = batcher.run(prompts)
    rec.remove()
    alone = {rid: _alone(torch, cfg, tree_map(agent[0], planes), serve, pr,
                         16) for rid, pr in enumerate(prompts)}
    text_c, bad_c = _agreement(out, rec.rows(), alone, FP32_LOGITS)
    engine = GroupServeEngine(cfg, ParamStore(planes, donate=True), serve,
                              batch_size=n_agents, prompt_pad=16)
    rec = _SlotLogits(engine, "decode_step", lambda: engine._slots)
    out = engine.run([GroupRequest(a, a, prompts[a])
                      for a in range(n_agents)])
    rec.remove()
    alone = {a: _alone(torch, cfg, tree_map(agent[a], planes), serve,
                       prompts[a], 16) for a in range(n_agents)}
    text_g, bad_g = _agreement(out, rec.rows(), alone, FP32_LOGITS)
    print(f"[exact] {arch}, full width and depth, fp32 compute, "
          f"{n_agents} requests x 8 greedy tokens, against the fixed-batch "
          f"ServeEngine on each request's weights: continuous (2 slots) "
          f"{text_c}; group ({n_agents} agents, one request each) {text_g} "
          f"-> {'ok' if not bad_c and not bad_g else 'FAIL'}")
    check(not bad_c and not bad_g, f"[exact] {arch}: the slot engines "
                                   f"disagree with the fixed-batch engine: "
                                   f"{bad_c} {bad_g}")


def load_phase(torch):
    """[load] mamba2-780m: the load bench's twin at full width
    (``repro_torch.benchmarks.bench_serving --full --agents 4 --slots 4
    --requests 32``, the reference's defaults otherwise: open-loop
    Poisson arrivals at 0.6 of the calibrated capacity, a hot swap
    mid-run), with its three gates (completeness, throughput ≥ 0.4 ×
    offered, p50 ≤ 6x and p99 ≤ 15x the calibrated ideal); SSD launches
    48 per admission (the calibration's 5 and the stream's 32)."""
    import contextlib
    import io

    from repro_torch.benchmarks import bench_serving
    from repro_torch.configs import get_arch_config

    label = f"[load] {SLOT_ARCH}"
    cfg = get_arch_config(SLOT_ARCH)
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launches()
    path = ROOT / "build" / "BENCH_serving_torch.json"
    path.parent.mkdir(exist_ok=True)
    try:
        with contextlib.redirect_stdout(out):
            payload = bench_serving.main(
                ["--arch", SLOT_ARCH, "--full", "--agents", "4", "--slots",
                 "4", "--requests", "32", "--json", str(path)])
    except SystemExit as exc:
        print(out.getvalue())
        raise SmokeFailure(f"{label}: {exc}")
    launched = launch_counts()
    for ln in out.getvalue().splitlines():
        if ln.strip():
            print(f"[load]   {ln}")
    c, s, o = payload["calibration"], payload["summary"], payload["open_loop"]
    g = payload["gates"]
    want = {name: 0 for name in KERNELS}
    want["ssd_intra_chunk"] = cfg.n_layers * (4 + 1 + 32)
    print(f"{label}: t_step_s {c['t_step_s']:.5f}, t_prefill_s "
          f"{c['t_prefill_s']:.5f}, capacity {c['capacity_tok_s']:.1f} tok/s, "
          f"offered {o['offered_tok_s']:.1f} tok/s, achieved "
          f"{s['throughput_tok_s']:.1f} tok/s, latency p50 "
          f"{s['latency_p50']:.3f} s (bound {g['latency']['p50_bound']:.3f}), "
          f"p99 {s['latency_p99']:.3f} s (bound "
          f"{g['latency']['p99_bound']:.3f}), gates "
          + ", ".join(f"{k} {'PASS' if v['pass'] else 'FAIL'}"
                      for k, v in g.items())
          + "; launches " + ", ".join(f"{k} {v}" for k, v in launched.items()))
    check(all(v["pass"] for v in g.values()), f"{label}: a gate failed")
    check(launched == want, f"{label}: launches {launched} != {want}")
    return {"ssd_intra_chunk": {label: launched["ssd_intra_chunk"]}}


def _record_logits(fn, sink):
    def wrapped(*args):
        logits, cache = fn(*args)
        sink.append(logits.detach().float().cpu())
        return logits, cache
    return wrapped


def equiv_slots_phase(torch, arch):
    """[equiv] continuous and group at ``arch``'s widths cut to 2 layers
    with fp32 compute, card against the port's CPU path on the same
    weights (2 agents for the group, the second from seed 1): 4 requests
    (the launcher's draw, seed 1, prompt-len 64) through 2 slots, 8 greedy
    tokens; every decode step's logits within rtol = atol = 1e-4 and the
    tokens equal."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_arch_config
    from repro_torch.launch.serve import draw_prompts
    from repro_torch.models import get_model
    from repro_torch.serving import (ContinuousBatcher, GroupRequest,
                                     GroupServeEngine, ServeConfig)

    cfg = get_arch_config(arch).with_(n_layers=2, compute_dtype="float32")
    model = get_model(cfg)
    p0, p1 = (model.init(cfg, torch.Generator().manual_seed(s), "cpu")
              for s in (0, 1))
    planes = tree_map(lambda a, b: torch.stack([a, b]), p0, p1)
    prompts = draw_prompts(cfg.vocab_size, 4, 64, 1)
    serve = ServeConfig(max_len=128, max_new_tokens=8)
    for engine_name in ("continuous", "group"):
        results, steps = {}, {}
        for dev in ("cpu", "cuda"):
            steps[dev] = []
            if engine_name == "continuous":
                eng = ContinuousBatcher(
                    cfg, tree_map(lambda t: t.to(dev), p0), serve,
                    batch_size=2, prompt_pad=16)
                eng._decode = _record_logits(eng._decode, steps[dev])
                results[dev] = eng.run(prompts)
            else:
                eng = GroupServeEngine(
                    cfg, tree_map(lambda t: t.to(dev), planes), serve,
                    batch_size=2, prompt_pad=16)
                eng.decode_step = _record_logits(eng.decode_step, steps[dev])
                results[dev] = eng.run([GroupRequest(i, i % 2, pr)
                                        for i, pr in enumerate(prompts)])
        errs = [float((g - c).abs().max())
                for g, c in zip(steps["cuda"], steps["cpu"])]
        ok = (len(steps["cuda"]) == len(steps["cpu"]) > 0
              and all(torch.allclose(g, c, rtol=1e-4, atol=1e-4)
                      for g, c in zip(steps["cuda"], steps["cpu"]))
              and results["cuda"] == results["cpu"])
        print(f"[equiv] {engine_name} {arch} widths, 2 layers, fp32, 4 "
              f"requests x 8 greedy tokens through 2 slots, card vs CPU: "
              f"{len(steps['cuda'])} decode steps, step logits max abs "
              f"{max(errs):.3e} (rtol=atol=1e-4), tokens equal "
              f"{results['cuda'] == results['cpu']} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"card and CPU {engine_name} engines disagree: {arch}")


def nosync_decode_phase(torch, cfg, params):
    """ServeEngine.decode of llama3.2-3b at full width and depth (2
    requests, 8 greedy tokens) under
    ``torch.cuda.set_sync_debug_mode("error")`` with the prompt lengths
    from the host: any call that synchronizes with the card raises.
    The mode is shown to bite first (a read-back under it raises)."""
    from repro_torch.serving import ServeConfig, ServeEngine, serve_batches

    engine = ServeEngine(cfg, params, ServeConfig(max_len=64,
                                                  max_new_tokens=8))
    toks, lens = serve_batches([[5, 9, 200, 31, 7], [11, 400, 3]], 2,
                               device="cpu")[0]
    logits, cache = engine.prefill(toks.to("cuda"), lens)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            float(logits[0, 0])
            bites = False
        except RuntimeError:
            bites = True
        out = engine.decode(logits, cache, lens)
        error = None
    except RuntimeError as exc:
        error = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[nosync] ServeEngine.decode {LLAMA}, full width, 2 requests x 8 "
          f"tokens under set_sync_debug_mode('error'): a read-back raises "
          f"{bites}, decode "
          + ("ran without a synchronizing call"
             if error is None else f"raised: {error}")
          + f" -> {'ok' if bites and error is None else 'FAIL'}")
    check(bites and error is None and out.shape == (2, 8),
          f"ServeEngine.decode synchronizes with the card: {error}")


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
    from repro_torch.configs import get_arch_config
    from repro_torch.models import get_model
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        card = device_phase(torch)
        instances = build_phase()
        table = kernel_phase(torch)
        table["grad_sketch"] = sketch_phase(torch)
        table["ddal_fused_wavg_q"] = wavg_q_phase(torch)
        stale_kernel_phase(torch)
        table["ssd_intra_chunk"] = ssd_kernel_phase(torch,
                                                    instances["ssd_scan"])
        table["flash_attention"] = flash_kernel_phase(torch)
        launches = main_path_phase(torch)
        serve_launches, prompts = serve_phase(torch, SERVE_ARGV,
                                              SERVE_LABEL)
        llama_launches, _ = serve_phase(torch, LLAMA_SERVE_ARGV,
                                        LLAMA_SERVE_LABEL)
        # the scoring path and its profile share one full-width model
        llama = get_arch_config(LLAMA)
        params = get_model(llama).init(
            llama, torch.Generator(device="cuda").manual_seed(0), "cuda")
        score_launches = score_phase(torch, llama, params)
        profile_score_phase(torch, llama, params,
                            instances["flash_attention"])
        nosync_decode_phase(torch, llama, params)
        del params
        torch.cuda.empty_cache()
        slot_launches = [continuous_phase(torch),
                         group_phase(torch, SLOT_ARCH, 4, 4, 16),
                         group_phase(torch, LLAMA, 2, 2, 4),
                         load_phase(torch)]
        exact_slots_phase(torch, SLOT_ARCH, 4)
        exact_slots_phase(torch, LLAMA, 2)
        for paths in (serve_launches, llama_launches, score_launches,
                      *slot_launches):
            for name, by_path in paths.items():
                launches[name].update(by_path)
        equivalence_phase(torch)
        dqn_equivalence_phase(torch)
        robust_equivalence_phase(torch)
        equiv_serve_phase(torch, "mamba2-780m", prompts)
        cut = _cut_to_two_layers(torch, LLAMA)
        equiv_score_phase(torch, cut)
        equiv_serve_phase(torch, LLAMA, prompts, cut)
        del cut
        for arch in (SLOT_ARCH, LLAMA):
            equiv_slots_phase(torch, arch)
        profile_phase(torch)
        profile_serve_phase(torch, prompts, instances["ssd_scan"])
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
