"""DDAL cadence vs communication (beyond-paper table) on the torch path
— the twin of ``benchmarks/bench_train_throughput.py``.

The paper never measures throughput; this bench quantifies DDAL's
communication saving over lockstep data parallelism: the streaming
trainer (``core.sharded_ddal.make_group_train_step``) with share
cadence k exchanges gradients once every k steps, so cross-agent
traffic is 1/k of lockstep DP by construction. It runs 2 agents of the
reference's shape ``ShapeConfig("bench", 128, 4, "train")`` at cadence
1, 4 and 16: one warm-up step (the reference's compile step), then
``steps`` timed steps (the host clock, the card synchronised at the
end), and reports tokens/s beside the exchanges per step.

Each row also counts what the trainer did in the timed steps: its
share steps (``metrics["shared"]``) beside the plan (steps i = 1 ..
``steps`` with i % k == 0, since ``threshold = 0``), and the kernel
launches (on the card the flash kernel once per layer in each agent's
forward; its backward is the plain VJP). By default the model is the
reference's ``reduced()`` config; ``--full-width --layers N`` runs the
arch's published widths cut to N layers.

    python -m repro_torch.benchmarks.bench_train_throughput
        [--arch llama3.2-3b] [--steps 12] [--full-width --layers 2]
        [--device cuda|cpu] [--json PATH]
"""
from __future__ import annotations

import argparse
import os
import time

_DEFAULT_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_train_throughput_torch.json")
CADENCES = (1, 4, 16)
N_AGENTS = 2


def planned_shares(steps: int, cadence: int) -> int:
    """Share steps among the timed steps 1 .. ``steps`` (step 0 is the
    warm-up) at ``threshold = 0``."""
    return sum(1 for i in range(1, steps + 1) if i % cadence == 0)


def bench_config(arch: str, full_width: bool = False, layers=None):
    from repro_torch.configs import get_arch_config
    cfg = get_arch_config(arch)
    if not full_width:
        return cfg.reduced()
    return cfg.with_(n_layers=layers) if layers else cfg


def main(arch: str = "llama3.2-3b", steps: int = 12,
         verbose: bool = True, device=None, full_width: bool = False,
         layers=None, json_path=None):
    from repro_torch import optim
    from repro_torch.benchmarks.common import device_info, synchronize
    from repro_torch.common.device import resolve_device
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.core.sharded_ddal import (init_train_state,
                                               make_group_train_step)
    from repro_torch.data import StreamSpec, make_group_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    dev = resolve_device(device)
    cfg = bench_config(arch, full_width, layers)
    shape = ShapeConfig("bench", 128, 4, "train")
    rows = []
    for cadence in CADENCES:
        spec = GroupSpec(n_agents=N_AGENTS, threshold=0, minibatch=cadence,
                         knowledge_mode="streaming")
        opt = optim.adamw(1e-3)
        state = init_train_state(cfg, spec, opt, seed=0, device=dev)
        step = make_group_train_step(cfg, spec, opt)
        batch = make_group_batch(cfg, shape, StreamSpec(), N_AGENTS, 0, dev)
        state, _ = step(state, batch)          # warm-up
        synchronize(dev)
        before = (fa_ops.flash_attention.launches,
                  ssd_ops.ssd_intra_chunk.launches)
        shares = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
            shares += int(m["shared"])
        synchronize(dev)
        dt = time.perf_counter() - t0
        toks = steps * N_AGENTS * shape.global_batch * shape.seq_len
        rows.append({"cadence": cadence, "tokens_per_s": toks / dt,
                     "exchanges_per_step": 1.0 / cadence,
                     "shares": shares,
                     "planned_shares": planned_shares(steps, cadence),
                     "flash_launches":
                         fa_ops.flash_attention.launches - before[0],
                     "ssd_launches":
                         ssd_ops.ssd_intra_chunk.launches - before[1],
                     "ms_per_step": dt / steps * 1e3})
        del state, step
    if verbose:
        print(f"{arch} ({'published widths, ' + str(cfg.n_layers) + ' layers' if full_width else 'reduced()'}), "
              f"{N_AGENTS} agents, batch {shape.global_batch} x "
              f"{shape.seq_len}, {steps} steps on {dev.type}:")
        print(f"{'cadence':>8} {'tokens/s':>10} {'grad-exchanges/step':>20} "
              f"{'shares':>7} {'planned':>8}")
        for r in rows:
            print(f"{r['cadence']:8d} {r['tokens_per_s']:10,.0f} "
                  f"{r['exchanges_per_step']:20.3f} {r['shares']:7d} "
                  f"{r['planned_shares']:8d}")
        print("cross-agent gradient traffic scales as 1/cadence "
              "(the window moves only at share steps)")
    if json_path:
        from repro_torch.benchmarks.common import write_json
        write_json(json_path, {"bench": "train_throughput", "arch": arch,
                               "n_layers": cfg.n_layers,
                               "full_width": full_width, "steps": steps,
                               **device_info(dev), "rows": rows})
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3.2-3b")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--full-width", action="store_true",
                   help="the arch's published widths (default reduced())")
    p.add_argument("--layers", type=int, default=None,
                   help="with --full-width: cut to this many layers")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=_DEFAULT_JSON)
    a = p.parse_args()
    main(a.arch, a.steps, device=a.device, full_width=a.full_width,
         layers=a.layers, json_path=a.json)
