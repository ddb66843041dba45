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
    # two ranks on the host, one pod each, over gloo
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
        --mesh pods --agents 4 --steps 6 --batch 2 --seq 32 \\
        --threshold 2 --minibatch 2 --exchange topology=hierarchical \\
        --exchange degree=2 --exchange pods=2

Flags are the reference's: the legacy named flags as shims over
``--exchange`` (each explicit use warns ``DeprecationWarning``), the
``--exchange key=value`` vocabulary from the strategy registries
(``repro_torch.core.exchange.cli_options``), ``--full``, ``--elastic``,
``--ckpt`` (final params), ``--ckpt-full`` / ``--restore`` (the whole
``TrainState``, in ``.npz`` files either package reads) and ``--seed``;
``--device`` (default ``cuda``) picks the card or the host. ``--mesh
cpu`` trains on one device, ``--pods N`` (``--exchange pods=N``) there
through the single-device pod dispatch. ``--mesh pods`` runs under
``torchrun`` on a ``(pod_axis, "agent")`` mesh of the world's ranks
(``launch.mesh.make_pod_mesh``): NCCL on the card (rank r on
``cuda:LOCAL_RANK``), gloo with ``--device cpu``, never one for the
other. Each rank trains its block of agents; rank 0 prints the lines
and writes the checkpoints, gathered into the single-process ``.npz``
format, so ``--restore`` reads either kind of run's file in either
kind. ``--mesh prod`` runs under ``torchrun`` on the reference's 16 x 16
``(data, model)`` production mesh (``launch.mesh.make_production_mesh``;
a world of another size raises ``ValueError`` naming the 256 it needs):
each rank draws only its slices of the state by
``shardings.state_placement_specs`` (``sharded_ddal.init_train_state(...,
mesh=)``: the group's draws in their order, every drawn layer cut at
once), takes its B/16 rows of each agent's batch, and the step runs the
model under ``train_rules(mesh)`` (the tensor-parallel layers of every
family). This is the program that the reference's dry run lowers for
that mesh (``dryrun_lib.lower_train``); it computes the numbers that
the reference's own launcher, whose ``--mesh prod`` installs the mesh
but no rules, computes replicated. ``--mesh prod-multipod`` runs the
same on the 2 x 16 x 16 ``(pod, data, model)`` mesh (512 ranks; a world
of another size raises ``ValueError`` naming 512), one agent block a
pod: a rank holds A/2 agents' slices and B/16 rows of each of their
batches, the window's exchange gathering over ``pod``. On both
``--restore`` reads the file a leaf and a block at a time, each rank
keeping its slice (``checkpoint.restore_sliced``), and ``--ckpt`` /
``--ckpt-full`` gather each leaf to rank 0's host a block at a time
into the single-process ``.npz`` (``checkpoint.save_sliced``). The
weights are drawn from a ``torch.Generator`` of ``--seed`` and the
token streams are the port's own (``repro_torch.data.synthetic``), so
neither is the reference's.

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
                   help="hierarchical pod dispatch: number of pods (the "
                        "'pod' combiner; --mesh pods maps them onto "
                        "the pod axis)" + _DEPRECATION.format(key="pods"))
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
                   help="'cpu': one device; 'pods': the (pod, agent) "
                        "mesh of the torchrun world (needs --pods >= 1); "
                        "'prod': the 16 x 16 (data, model) mesh of a "
                        "256-rank torchrun world (tensor parallelism); "
                        "'prod-multipod': the 2 x 16 x 16 (pod, data, "
                        "model) mesh of a 512-rank world (agents over pod)")
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
    from repro_torch.configs.base import GroupSpec, ShapeConfig
    from repro_torch.core.exchange import build_exchange
    from repro_torch.core.sharded_ddal import (init_train_state,
                                               make_group_train_step)
    from repro_torch.data import (StreamSpec, make_data_batch,
                                  make_group_batch, make_rows_batch)

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
    # mesh wiring reads the merged spec, so --exchange pods=N / pod_axis=X
    # and the legacy named flags behave the same
    mesh = None
    if args.mesh == "pods":
        if spec.pods < 1:
            raise SystemExit("--mesh pods needs --pods >= 1 (or "
                             "--exchange pods=N)")
        from repro_torch.launch.mesh import init_distributed, make_pod_mesh
        dev = init_distributed(args.device)
        mesh = make_pod_mesh(spec.pods, pod_axis=spec.pod_axis,
                             device_type=dev.type)
    elif args.mesh != "cpu":
        from repro_torch.launch import mesh as M
        multi = args.mesh == "prod-multipod"
        M.check_world(*M.production_shape(multi))
        dev = M.init_distributed(args.device)
        mesh = M.make_production_mesh(multi_pod=multi, device_type=dev.type)
    else:
        dev = resolve_device(args.device)
    shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
    opt = optim.adamw(args.lr)
    stream = StreamSpec(seed=args.seed)

    # one protocol serves state init and the step, so the carried
    # relevance state and the step's estimator cannot drift apart
    exchange = build_exchange(spec, kind="streaming", mesh=mesh)
    shard = exchange.shard
    # a mesh with a model axis: (data, model) or (pod, data, model)
    tensor = mesh is not None and args.mesh != "pods"
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    say = print if rank0 else _quiet
    if tensor:
        # the rank's slices drawn (and read) directly: no rank holds the
        # group's whole state
        from repro_torch.checkpoint import restore_sliced
        from repro_torch.launch import shardings as SH
        state_specs = SH.state_placement_specs(
            cfg, mesh, exchange.estimator.learns, exchange.sketch_dim,
            spec.pod_axis)
        state_shapes = SH.full_shapes(init_train_state(
            cfg, spec, opt, seed=args.seed, exchange=exchange,
            device="meta"))
        state = init_train_state(cfg, spec, opt, seed=args.seed,
                                 exchange=exchange, device=dev, mesh=mesh)
        if args.restore:
            state = restore_sliced(args.restore, state, state_specs, mesh,
                                   cfg, strict=False)
    else:
        # the group's state from the seed (and the file), then the
        # rank's rows
        state = init_train_state(cfg, spec, opt, seed=args.seed,
                                 exchange=exchange, device=dev)
        if args.restore:
            state = restore_train(args.restore, state, strict=False)
        if mesh is not None:
            from repro_torch.launch.shardings import (agent_sharded_state,
                                                      gather_agent_state)
            state = agent_sharded_state(state, mesh, spec.pod_axis)
    if args.restore:
        say(f"restored full TrainState from {args.restore} "
            f"(step {int(state.step)})")
    step_fn = make_group_train_step(cfg, spec, opt, exchange=exchange,
                                    mesh=mesh if tensor else None)
    leaves = [x for _, x in tree_leaves_with_paths(
        state_shapes.params if tensor else state.params)]
    n_params = sum(x[0].numel() for x in leaves)
    say(f"arch={args.arch} reduced={not args.full} "
        f"params/agent={n_params:,} agents={args.agents}")
    if mesh is not None:
        import torch.distributed as dist
        backend = dist.get_backend()
        shape_m = tuple(mesh.mesh.shape)
    if not tensor and shard is not None:
        say(f"mesh {spec.pod_axis} x agent = {shape_m} over {backend}: "
            f"{shard.block} agents a rank")
    elif tensor:
        rows = args.batch // mesh.size(mesh.mesh_dim_names.index("data"))
        who = ("every agent on every rank" if shard is None
               else f"{shard.block} agents a rank")
        axes = " x ".join(mesh.mesh_dim_names)
        say(f"mesh {axes} = {shape_m} over {backend}: {who}, {rows} rows "
            f"of each agent's batch and its model-axis slices")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, shared, step_ms, window = [], [], [], []
    sync()
    t0 = time.perf_counter()
    for i in range(args.steps):
        if tensor:
            batch = make_data_batch(cfg, shape, stream, args.agents,
                                    int(state.step), mesh, dev,
                                    rows=None if shard is None
                                    else shard.rows)
        elif shard is None:
            batch = make_group_batch(cfg, shape, stream, args.agents,
                                     int(state.step), dev)
        else:
            batch = make_rows_batch(cfg, shape, stream, shard.rows,
                                    int(state.step), dev)
        t_step = time.perf_counter()
        state, m = step_fn(state, batch)
        sync()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        row = [float(x) for x in m["loss"].cpu()]
        losses.append(row)
        rsum = state.know.rsum
        window.append((rsum if shard is None else shard.gather(rsum)).tolist())
        if m["shared"]:
            shared.append(m["step"])
        tag = " <shared>" if m["shared"] else ""
        say(f"step {i:4d} losses [{' '.join(f'{x:6.3f}' for x in row)}]"
            f"{tag}")
    dt = time.perf_counter() - t0
    toks = args.steps * args.agents * args.batch * args.seq
    say(f"{args.steps} steps in {dt:.1f}s ({toks / dt:,.0f} tokens/s)")

    first = int(state.step) - args.steps
    kinds = {"warm-up": [], "accumulation": [], "share": []}
    for i, ms in enumerate(step_ms):
        step = first + i
        kinds["warm-up" if step < spec.threshold else
              "share" if step in shared else "accumulation"].append(ms)
    medians = {k: statistics.median(v) for k, v in kinds.items() if v}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    say("median ms per step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in medians.items())
        + ("" if peak is None else f"; peak {peak / 2**30:.3f} GiB"))
    if tensor:
        # each leaf gathered to rank 0's host a block at a time, written
        # into the single-process file
        from repro_torch.checkpoint import save_sliced, save_train_sliced
        if args.ckpt:
            save_sliced(args.ckpt, state.params, state_specs.params, mesh,
                        state_shapes.params, cfg, step=args.steps)
            say(f"saved params to {args.ckpt}")
        if args.ckpt_full:
            save_train_sliced(args.ckpt_full, state, state_specs, mesh,
                              state_shapes, cfg, step=int(state.step))
            say(f"saved full TrainState to {args.ckpt_full}")
    elif args.ckpt or args.ckpt_full:
        # the single-process file: the group's rows gathered to every
        # rank, written by rank 0
        full = (state if mesh is None
                else gather_agent_state(state, mesh, spec.pod_axis))
        if rank0:
            if args.ckpt:
                save(args.ckpt, full.params, step=args.steps)
                say(f"saved params to {args.ckpt}")
            if args.ckpt_full:
                save_train(args.ckpt_full, full, step=int(full.step))
                say(f"saved full TrainState to {args.ckpt_full}")
        del full
    if mesh is not None:
        torch.distributed.barrier()
    return {"state": state, "spec": spec, "cfg": cfg, "shard": shard,
            "params_per_agent": n_params, "leaves": len(leaves),
            "losses": losses, "shared": shared, "step_ms": step_ms,
            "window": window,
            "median_ms": medians, "seconds": dt, "tokens_per_s": toks / dt,
            "peak_bytes": peak}


def _quiet(*args, **kwargs):
    """``print`` on the ranks other than 0."""


if __name__ == "__main__":
    main()
    import torch.distributed as _dist
    if _dist.is_available() and _dist.is_initialized():
        _dist.destroy_process_group()
