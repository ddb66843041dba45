"""Two checkouts' share-step and sketch kernels, timed in turns on one
card.

    python src/repro_torch/kernels/kernel_ab.py --old DIR --new DIR

runs a worker process in each checkout in the order old, new, new, old
(each builds its own kernels from its own sources) and prints, for each
shape, the device ms of every run and the mean ratio new / old, beside
the card's name and power limit. Each worker times, with its
checkout's ``chip_smoke.time_ms`` (CUDA events around back-to-back
launches queued behind a spin kernel), the int8 share step
(``fused_wavg_q``) at the main path's (8, 32, 9155), q_block 128, and on
the big ragged plane (16, 8, 2^20 + 37); the gradient sketch
(``sketch_flat``) at the main path's (8, 9155, 256) and on the
LLM-scale plane (16, 2^22 + 37, 256); the fp32 share step
(``fused_wavg``) at (2, 32, 9155) and (8, 32, 9155) as a control; and
the yardsticks (``einsum`` over dequantised planes, ``matmul(G, S)``).
The inputs come from seeded ``torch.Generator``s, so both checkouts
time the same data. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ORDER = ("old", "new", "new", "old")


def worker(root: Path) -> dict:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke as smoke
    from repro_torch.common.pytree import PlaneLayout
    from repro_torch.kernels.ddal_wavg import ops as wops, ref as wref
    from repro_torch.kernels.grad_sketch import ops as sops, ref as sref

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    a2c = smoke._a2c_layout(torch)
    ragged = PlaneLayout(None, [()], [(2 ** 20 + 37,)])
    for label, layout, n, m, iters in (("int8 (8, 32, 9155)", a2c, 8, 32,
                                        200),
                                       ("int8 (16, 8, 2^20+37)", ragged, 16,
                                        8, 20)):
        G, T, R, valid = smoke.make_case(torch, n, m, layout.size, seed=n)
        blocks = layout.blocks(128)
        Q, S = wref.quantize_flat(G, blocks)
        deq = wref.dequantize_flat(Q, S, blocks)
        w = wref.eq4_weights(T, R, valid)
        del G
        out[label] = smoke.time_ms(
            torch, lambda: wops.fused_wavg_q(Q, S, T, R, valid, blocks),
            iters)[0]
        out[label + " einsum"] = smoke.time_ms(
            torch, lambda: torch.einsum("nm,nmp->np", w, deq), iters)[0]
        del Q, S, deq
    for label, n, p, iters in (("sketch (8, 9155, 256)", 8, 9155, 200),
                               ("sketch (16, 2^22+37, 256)", 16,
                                2 ** 22 + 37, 20)):
        g = torch.Generator(device="cuda").manual_seed(n)
        G = torch.randn((n, p), generator=g, device="cuda")
        out[label] = smoke.time_ms(
            torch, lambda: sops.sketch_flat(G, 123, 256), iters)[0]
        S = sref.sign_block(123, 0, p, 256, "cuda")
        out[label + " matmul"] = smoke.time_ms(
            torch, lambda: torch.matmul(G, S), iters)[0]
        del G, S
    for n in (2, 8):
        G, T, R, valid = smoke.make_case(torch, n, 32, 9155, seed=n)
        out[f"fp32 fused ({n}, 32, 9155)"] = smoke.time_ms(
            torch, lambda: wops.fused_wavg(G, T, R, valid), 200)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--new", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker.resolve())))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs = []
    for which in ORDER:
        root = (args.old if which == "old" else args.new).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(root)], cwd=root, env=env, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"[ab] {card}; order {', '.join(ORDER)}; device ms")
    for key in runs[0]:
        t = [r[key] for r in runs]
        old = (t[0] + t[3]) / 2
        new = (t[1] + t[2]) / 2
        print(f"[ab] {key}: " + ", ".join(f"{w} {x:.5f}" for w, x in
                                         zip(ORDER, t))
              + f"; new / old {new / old:.3f}")
    print(json.dumps({"card": card, "order": ORDER, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
