"""Training launcher — the port of ``repro.launch.train``: DDAL
group-agent training of a model-zoo arch through the streaming trainer
(``repro_torch.core.sharded_ddal``).

    # the host, reduced() config (2 layers, d_model 256, vocab 512)
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch llama3.2-3b --agents 2 --steps 6 --batch 2 --seq 32 \\
        --threshold 2 --minibatch 2
    # the card, mamba2-780m at its published widths and depth
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
        --full --agents 2 --steps 12 --batch 4 --seq 256 --threshold 4 \\
        --minibatch 4 --exchange estimator=grad_cos+sketch \\
        --exchange relevance_sketch_dim=256

Flags are the reference's: the legacy named flags as shims over
``--exchange`` (each explicit use warns ``DeprecationWarning``), the
``--exchange key=value`` vocabulary from the strategy registries
(``repro_torch.core.exchange.cli_options``), ``--full``, ``--elastic``,
``--ckpt`` (final params), ``--ckpt-full`` / ``--restore`` (the whole
``TrainState``, in ``.npz`` files either package reads) and ``--seed``;
``--device`` (default ``cuda``) picks the card or the host. ``--mesh``
takes ``cpu`` only (one device: any other mesh, like ``--pods``, waits
for Slice E and raises ``NotPortedError``). The weights are drawn from
a ``torch.Generator`` of ``--seed`` and the token streams are the
port's own (``repro_torch.data.synthetic``), so neither is the
reference's.

``main`` prints the reference's lines — params per agent, each step's
losses with ``<shared>`` on share steps, tokens/s — and, on top, the
median ms of a warm-up, an accumulation and a share step and the peak
device memory. It returns the numbers and the final state as a dict
(``window``: each agent's count of window pieces after every step).
"""
from __future__ import annotations

import argparse
import statistics
import time
import warnings

_DEPRECATION = " [deprecated spelling of --exchange {key}=N]"

# legacy flag → (GroupSpec field, default applied when unset); the flags
# parse with a None sentinel so only an explicit use warns
_LEGACY_FLAGS = {
    "topology": ("topology", "full"),
    "degree": ("degree", 4),
    "topology-seed": ("topology_seed", 0),
    "pods": ("pods", 0),
    "pod-axis": ("pod_axis", "pod"),
    "resample-every": ("resample_every", 0),
    "relevance-mode": ("relevance_mode", "uniform"),
    "relevance-ema": ("relevance_ema", 0.9),
    "relevance-sketch-dim": ("relevance_sketch_dim", 0),
}


def _legacy_spec_kw(args) -> dict:
    """The legacy named flags as GroupSpec kwargs, warning on each
    explicit use with its --exchange spelling."""
    kw = {}
    for flag, (field, default) in _LEGACY_FLAGS.items():
        value = getattr(args, field)
        if value is None:
            kw[field] = default
        else:
            warnings.warn(
                f"--{flag} is deprecated: spell it --exchange "
                f"{field}={value} (see docs/exchange.md, 'Migration: "
                f"old GroupSpec flags -> strategies')",
                DeprecationWarning, stacklevel=2)
            kw[field] = value
    return kw


def _exchange_kv(text: str):
    """One ``--exchange key=value`` item against the registry
    vocabulary, the value coerced to the parameter's type."""
    from repro_torch.core.exchange import cli_options
    opts = cli_options()
    key, sep, value = text.partition("=")
    if not sep:
        raise argparse.ArgumentTypeError(
            f"--exchange wants key=value, got {text!r}")
    if key not in opts:
        raise argparse.ArgumentTypeError(
            f"unknown exchange option {key!r}; valid keys: "
            f"{', '.join(sorted(opts))}")
    field, typ = opts[key]
    try:
        return field, typ(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--exchange {key} wants a {typ.__name__}, got {value!r}")


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="llama3.2-3b")
    p.add_argument("--agents", type=int, default=2)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--threshold", type=int, default=5)
    p.add_argument("--minibatch", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--exchange", action="append", default=[],
                   type=_exchange_kv, metavar="KEY=VALUE",
                   help="exchange-protocol configuration "
                        "(repro_torch.core.exchange): KEY is a strategy "
                        "selector (schedule= estimator= delay= combiner= "
                        "transport=) or any registered strategy's "
                        "parameter (e.g. resample_every= relevance_ema= "
                        "explore_eps= quant_block=). Repeatable. "
                        "Faulty-network training: --exchange "
                        "transport=faulty --exchange loss=0.2 "
                        "--exchange corrupt=0.05")
    p.add_argument("--topology", default=None,
                   choices=["full", "ring", "torus2d", "star",
                            "random_k", "hierarchical"],
                   help="communication graph"
                        + _DEPRECATION.format(key="topology"))
    p.add_argument("--degree", type=int, default=None,
                   help="k for random_k; pod size for hierarchical"
                        + _DEPRECATION.format(key="degree"))
    p.add_argument("--topology-seed", type=int, default=None,
                   help="gossip sampling seed"
                        + _DEPRECATION.format(key="topology_seed"))
    p.add_argument("--pods", type=int, default=None,
                   help="multi-host pod dispatch (Slice E: refused)"
                        + _DEPRECATION.format(key="pods"))
    p.add_argument("--pod-axis", default=None,
                   help="mesh axis of the leader-level exchange (--pods "
                        "only)" + _DEPRECATION.format(key="pod_axis"))
    p.add_argument("--resample-every", type=int, default=None,
                   help="dynamic gossip: resample the random_k neighbour "
                        "table every N steps (0 = static wiring)"
                        + _DEPRECATION.format(key="resample_every"))
    p.add_argument("--relevance-mode", default=None,
                   choices=["uniform", "grad_cos"],
                   help="eq. 4 per-edge relevance R: 'uniform' or "
                        "'grad_cos' (learned from the cosines of the "
                        "agents' window gradients) [deprecated spelling "
                        "of --exchange estimator=...]")
    p.add_argument("--relevance-ema", type=float, default=None,
                   help="EMA decay of the learned relevance"
                        + _DEPRECATION.format(key="relevance_ema"))
    p.add_argument("--relevance-sketch-dim", type=int, default=None,
                   help="sketched relevance: cosines of (agents, d) "
                        "sign-JL sketches of the gradients (0 = exact)"
                        + _DEPRECATION.format(key="relevance_sketch_dim"))
    p.add_argument("--full", action="store_true",
                   help="the published config (default: reduced())")
    p.add_argument("--mesh", default="cpu",
                   choices=["cpu", "prod", "prod-multipod", "pods"],
                   help="'cpu': one device (the only one ported; the "
                        "meshes wait for Slice E)")
    p.add_argument("--elastic", action="store_true",
                   help="elastic group membership: a per-agent alive "
                        "mask through the exchange")
    p.add_argument("--ckpt", default=None,
                   help="save final params to this .npz")
    p.add_argument("--ckpt-full", default=None,
                   help="save the whole TrainState (params, optimiser "
                        "state, the knowledge window with sketch and "
                        "learned relevance) for --restore")
    p.add_argument("--restore", default=None,
                   help="restore a --ckpt-full TrainState (of either "
                        "package) before training; leaves an older file "
                        "lacks keep their fresh values")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import torch

    from repro_torch import optim
    from repro_torch.checkpoint import restore_train, save, save_train
    from repro_torch.common.device import resolve_device
    from repro_torch.common.pytree import tree_leaves_with_paths
    from repro_torch.configs import get_arch_config
    from repro_torch.configs.base import (GroupSpec, NotPortedError,
                                          ShapeConfig)
    from repro_torch.core.exchange import build_exchange
    from repro_torch.core.sharded_ddal import (init_train_state,
                                               make_group_train_step)
    from repro_torch.data import StreamSpec, make_group_batch

    dev = resolve_device(args.device)
    cfg = get_arch_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    # legacy named flags first (warned when explicit), --exchange
    # key=value pairs on top (later spellings win)
    spec_kw = _legacy_spec_kw(args)
    for field, value in args.exchange:
        spec_kw[field] = value
    spec = GroupSpec(n_agents=args.agents, threshold=args.threshold,
                     minibatch=args.minibatch, knowledge_mode="streaming",
                     elastic=args.elastic, **spec_kw)
    if args.mesh != "cpu":
        raise NotPortedError(
            f"--mesh {args.mesh} (a device mesh) waits for Slice E; the "
            f"port trains on one device (--mesh cpu)")
    shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
    opt = optim.adamw(args.lr)
    stream = StreamSpec(seed=args.seed)

    # one protocol serves state init and the step, so the carried
    # relevance state and the step's estimator cannot drift apart
    exchange = build_exchange(spec, kind="streaming")
    state = init_train_state(cfg, spec, opt, seed=args.seed,
                             exchange=exchange, device=dev)
    if args.restore:
        state = restore_train(args.restore, state, strict=False)
        print(f"restored full TrainState from {args.restore} "
              f"(step {int(state.step)})")
    step_fn = make_group_train_step(cfg, spec, opt, exchange=exchange)
    leaves = [x for _, x in tree_leaves_with_paths(state.params)]
    n_params = sum(x.numel() for x in leaves) // args.agents
    print(f"arch={args.arch} reduced={not args.full} "
          f"params/agent={n_params:,} agents={args.agents}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, shared, step_ms, window = [], [], [], []
    sync()
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = make_group_batch(cfg, shape, stream, args.agents,
                                 int(state.step), dev)
        t_step = time.perf_counter()
        state, m = step_fn(state, batch)
        sync()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        row = [float(x) for x in m["loss"].cpu()]
        losses.append(row)
        window.append(state.know.rsum.tolist())
        if m["shared"]:
            shared.append(m["step"])
        tag = " <shared>" if m["shared"] else ""
        print(f"step {i:4d} losses [{' '.join(f'{x:6.3f}' for x in row)}]"
              f"{tag}")
    dt = time.perf_counter() - t0
    toks = args.steps * args.agents * args.batch * args.seq
    print(f"{args.steps} steps in {dt:.1f}s ({toks / dt:,.0f} tokens/s)")

    first = int(state.step) - args.steps
    kinds = {"warm-up": [], "accumulation": [], "share": []}
    for i, ms in enumerate(step_ms):
        step = first + i
        kinds["warm-up" if step < spec.threshold else
              "share" if step in shared else "accumulation"].append(ms)
    medians = {k: statistics.median(v) for k, v in kinds.items() if v}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    print("median ms per step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in medians.items())
        + ("" if peak is None else f"; peak {peak / 2**30:.3f} GiB"))
    if args.ckpt:
        save(args.ckpt, state.params, step=args.steps)
        print(f"saved params to {args.ckpt}")
    if args.ckpt_full:
        save_train(args.ckpt_full, state, step=int(state.step))
        print(f"saved full TrainState to {args.ckpt_full}")
    return {"state": state, "spec": spec, "cfg": cfg,
            "params_per_agent": n_params, "leaves": len(leaves),
            "losses": losses, "shared": shared, "step_ms": step_ms,
            "window": window,
            "median_ms": medians, "seconds": dt, "tokens_per_s": toks / dt,
            "peak_bytes": peak}


if __name__ == "__main__":
    main()
