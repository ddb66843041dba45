"""The dry run's library — the port of ``repro.launch.dryrun_lib``:
the step of every (architecture × input shape) pair on one rank of a
production mesh, traced, and its roofline record.

Prefill and decode on a ``(data, model)`` mesh. The reference places the
parameters by ``param_partition_specs(cfg, serve_rules(mesh, B))`` and
the batch and the decode cache by ``batch_partition_specs`` /
``cache_partition_specs``, then jits ``model.forward`` with a fresh cache
(prefill) or ``model.decode`` under ``axis_rules`` and ``set_mesh``.
:func:`prefill_on_mesh` and :func:`decode_on_mesh` do the same with the
rank's slices (``repro_torch.launch.shardings.place``): every rank of
the mesh calls them together, the layers write their collectives
(``repro_torch.models.attention``'s KV-slot sweep, the vocab-parallel
head's gathered logits), and each returns the full logits of the rank's
rows and the rank's slice of the cache.

The dry run. The reference lowers and compiles each pair's step for
the simulated devices of the 16 x 16 or 2 x 16 x 16 mesh and reads
XLA's ``memory_analysis``, ``cost_analysis`` and the HLO's collectives.
Torch has no program to lower; instead one rank of the production mesh
RUNS the port's own step in a fake world (``launch.mesh.
make_traced_mesh``) on ``meta`` tensors
(``repro_torch.roofline.trace``): :func:`trace` runs the streaming
trainer's step as ``launch.train`` wires it for ``--mesh prod`` /
``prod-multipod`` on the sliced state (``sharded_ddal.init_train_state(
..., mesh=)``), or the prefill or decode step above. Every layer
runs, so the reference's depth extrapolation over two shallow unrolled
compiles is not needed: the counts are the full depth's.
:func:`dryrun_pair` scales the rank's FLOPs, bytes and collective bytes
by the chips, as the reference scales its per-device costs, and prices
them at the H100's constants.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple

import torch

from repro_torch.common.pytree import tree_leaves_with_paths
from repro_torch.common.sharding import axis_rules, set_mesh
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, GroupSpec,
                                      ShapeConfig)
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import serve_rules
from repro_torch.models import get_model
from repro_torch.models.model import cache_specs, param_specs


_PLANS: dict = {}


def _plan(kind: str, cfg: ArchConfig, shape: ShapeConfig, mesh, make):
    """``make()`` once per step kind, config, shape and rank of a mesh:
    the specs and shapes a step places by (drawing the parameter tree on
    ``meta`` takes a while at published widths, and a decode loop asks
    for them every step)."""
    from repro_torch.common.sharding import axis_names
    key = (kind, cfg, shape.seq_len, shape.global_batch, axis_names(mesh),
           tuple(mesh.shape), tuple(mesh.get_coordinate() or ()))
    if key not in _PLANS:
        from repro_torch.common.describe import describing
        with describing():
            _PLANS[key] = make()
    return _PLANS[key]


def _held(tree, specs, mesh, cfg, full, want) -> Any:
    """``tree``'s leaves as the calling rank holds them: a leaf at its
    full shape (``full``, a matching tree of ``meta`` tensors) is cut by
    ``place``, a leaf already at the rank's (``want``) is taken as it
    is."""
    def spec_of(path, x, spec):
        have, mine = tuple(x.shape), tuple(SH._at(want, path).shape)
        if have == mine:
            return None                              # already the rank's
        if have != tuple(SH._at(full, path).shape):
            raise ValueError(
                f"leaf {'/'.join(map(str, path))} of shape {have}: "
                f"expected the full {tuple(SH._at(full, path).shape)} or "
                f"the rank's {mine}")
        return spec
    return SH.place(tree, SH._rebuild(tree, spec_of, specs), mesh, cfg)


def _rows(batch: dict, shape: ShapeConfig, mesh, rules: dict) -> dict:
    """The rank's rows of a batch of the global batch (dim 0 over the
    rules' batch axes where they split it); rows already the rank's
    are taken as they are."""
    axes = rules["batch"]
    if axes is None:
        return batch
    index, size = SH._coord(mesh, axes)
    n = shape.global_batch // size
    return {k: v if v.shape[0] == n else v[index * n:(index + 1) * n]
            for k, v in batch.items()}


def place_params(cfg: ArchConfig, shape: ShapeConfig, mesh, params) -> Any:
    """The rank's slices of ``params`` under ``serve_rules(mesh,
    shape.global_batch)`` (full leaves cut, the rank's leaves kept)."""
    def make():
        specs = SH.param_partition_specs(
            cfg, serve_rules(mesh, shape.global_batch))
        full = param_specs(cfg)
        return specs, full, SH.place(full, specs, mesh, cfg)
    specs, full, want = _plan("params", cfg, shape, mesh, make)
    return _held(params, specs, mesh, cfg, full, want)


def _cache_specs(cfg: ArchConfig, shape: ShapeConfig, rules: dict):
    return SH.cache_partition_specs(cfg, shape, rules["batch"],
                                    slots_axis=rules["kv_slots"])


def place_cache(cfg: ArchConfig, shape: ShapeConfig, mesh, cache) -> Any:
    """The rank's slice of a full decode cache (``shape.global_batch``
    rows, ``shape.seq_len`` slots) under ``serve_rules``: its rows and
    its block of slots; a slot dim that does not divide the axis stays
    whole and lies on model rank 0 (``shardings.place``)."""
    rules = serve_rules(mesh, shape.global_batch)
    return SH.place(cache, _cache_specs(cfg, shape, rules), mesh, cfg)


def prefill_on_mesh(cfg: ArchConfig, shape: ShapeConfig, mesh, params,
                    batch: dict) -> Tuple[torch.Tensor, Any]:
    """The reference's ``prefill_step`` on ``mesh``: a fresh cache of
    ``shape.global_batch`` rows and ``shape.seq_len`` slots (the rank's
    slice) and ``model.forward`` of ``batch`` into it, under
    ``axis_rules(serve_rules(mesh, B))`` and ``set_mesh(mesh)``.
    ``params`` and ``batch`` may be full (cut here) or already the
    rank's. Returns (the full logits of the rank's rows, the rank's
    cache)."""
    model = get_model(cfg)
    rules = serve_rules(mesh, shape.global_batch)
    params = place_params(cfg, shape, mesh, params)
    batch = _rows(batch, shape, mesh, rules)
    device = tree_leaves_with_paths(params)[0][1].device
    with set_mesh(mesh), axis_rules(rules):
        cache = model.make_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=device)
        return model.forward(cfg, params, batch, cache)


def decode_on_mesh(cfg: ArchConfig, shape: ShapeConfig, mesh, params,
                   batch: dict, cache) -> Tuple[torch.Tensor, Any]:
    """The reference's ``decode_step`` on ``mesh``: ``model.decode`` of
    one token per row against ``cache`` under ``axis_rules(serve_rules(
    mesh, B))`` and ``set_mesh(mesh)``. ``params`` and ``batch`` may be
    full (cut by ``param_`` / ``batch_partition_specs``) or already the
    rank's; ``cache`` is the rank's slice, as :func:`prefill_on_mesh`
    returns it (:func:`place_cache` cuts a full one by
    ``cache_partition_specs``), checked against those specs' shapes (a
    whole slot dim has the same shape either way, and only model rank
    0's copy holds its slots). The caller checks that
    the positions fit (``transformer.check_fits``), as for
    ``transformer_decode``. Returns (the full logits of the rank's rows,
    the rank's new cache)."""
    model = get_model(cfg)
    rules = serve_rules(mesh, shape.global_batch)
    params = place_params(cfg, shape, mesh, params)
    batch = _rows(batch, shape, mesh, rules)
    want = _plan("cache", cfg, shape, mesh, lambda: SH.place(
        cache_specs(cfg, shape), _cache_specs(cfg, shape, rules), mesh, cfg))
    for (path, x), (_, w) in zip(tree_leaves_with_paths(cache),
                                 tree_leaves_with_paths(want)):
        if tuple(x.shape) != tuple(w.shape):
            raise ValueError(
                f"cache leaf {'/'.join(map(str, path))} of shape "
                f"{tuple(x.shape)}: the rank's slice is {tuple(w.shape)} "
                f"(place a full cache with place_cache first)")
    with set_mesh(mesh), axis_rules(rules):
        return model.decode(cfg, params, batch, cache)


# ---------------------------------------------------------------------
# the dry run: one rank's step traced on meta tensors
# ---------------------------------------------------------------------
@dataclasses.dataclass
class DryrunResult:
    """One pair's record. ``compile_s`` (the reference's key) is the
    seconds the trace took; ``kernels`` the launches of each of the
    port's kernels that the rank's step makes."""
    arch: str
    shape: str
    mesh_name: str
    ok: bool
    error: Optional[str] = None
    memory: Optional[dict] = None
    roofline: Optional[dict] = None
    compile_s: float = 0.0
    kernels: Optional[dict] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in tuple(mesh.mesh.shape))


def _fresh(tree):
    """A new ``meta`` tensor of each tensor's shape and dtype in a nest
    of dicts, lists and named tuples: the state, batch or cache a step
    starts from, made inside ``traced()`` so that each counts live."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tuple(tree.shape), dtype=tree.dtype,
                           device="meta")
    if hasattr(tree, "_fields"):
        return type(tree)(*(_fresh(x) for x in tree))
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fresh(x) for x in tree)
    return tree


class Traced:
    """A traced step's counts: ``flops``, ``bytes`` (accessed),
    ``argument_bytes`` (the rank's inputs at entry), ``peak_bytes``
    (the live peak), ``collectives`` (``collectives.Record`` s) and
    ``kernels`` (the launches of each kernel op), plus ``n_agents``."""

    def __init__(self, trace, argument_bytes: int, n_agents: int = 1):
        ops = trace.counter.ops
        self.flops = int(trace.flops)
        self.bytes = int(trace.counter.bytes_accessed)
        self.argument_bytes = int(argument_bytes)
        self.peak_bytes = int(trace.counter.peak)
        self.collectives = list(trace.recorder.records)
        self.kernels = {k.split(".", 1)[1]: int(v) for k, v in ops.items()
                        if k.startswith("repro_torch.")}
        self.n_agents = n_agents

    def memory(self) -> dict:
        """The reference's ``_memory_dict`` keys."""
        return {"argument_size_in_bytes": self.argument_bytes,
                "temp_size_in_bytes": self.peak_bytes - self.argument_bytes,
                "total_bytes_per_device": self.peak_bytes}


def _run_traced(inputs, step, n_agents: int = 1) -> Traced:
    """``step(*inputs)`` on fresh ``meta`` tensors under the counters,
    the inputs live from entry."""
    from repro_torch.roofline.trace import traced
    with traced() as trace:
        args = _fresh(inputs)
        held = trace.counter.live
        out = step(*args)
        del out, args
    return Traced(trace, held, n_agents)


def _serve_inputs(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """The rank's parameters and batch rows on ``meta``."""
    from repro_torch.models.model import input_specs
    rules = serve_rules(mesh, shape.global_batch)
    params = place_params(cfg, shape, mesh, param_specs(cfg))
    return params, _rows(input_specs(cfg, shape), shape, mesh, rules)


def share_step(spec: GroupSpec) -> int:
    """The first share step: warm-up over, ``minibatch`` dividing it."""
    mb = spec.minibatch
    return -(-spec.threshold // mb) * mb


def train_inputs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                 spec: GroupSpec):
    """(state, batch, step): the streaming DDAL train step as
    ``launch.train`` wires it for ``--mesh prod`` / ``prod-multipod``
    (``build_exchange(..., mesh=)``, ``make_group_train_step(...,
    mesh=)``), the rank's sliced state (``init_train_state(...,
    mesh=)``, drawn on ``meta``) at the first share step
    (:func:`share_step`) and its rows of its agents' batches on
    ``meta``. The learning rate changes no count the trace takes."""
    from repro_torch import optim
    from repro_torch.core.exchange import build_exchange
    from repro_torch.core.sharded_ddal import (init_train_state,
                                               make_group_train_step)
    from repro_torch.models.model import input_specs
    opt = optim.adamw(3e-4)
    exchange = build_exchange(spec, kind="streaming", mesh=mesh)
    state = init_train_state(cfg, spec, opt, exchange=exchange,
                             device="meta", mesh=mesh)
    state = state._replace(step=share_step(spec))
    shard = exchange.shard
    agents = spec.n_agents if shard is None else shard.block
    rows = shape.global_batch // mesh.size(
        tuple(mesh.mesh_dim_names).index("data"))
    batch = {k: torch.empty((agents, rows) + tuple(v.shape[1:]),
                            dtype=v.dtype, device="meta")
             for k, v in input_specs(cfg, shape).items()}
    step = make_group_train_step(cfg, spec, opt, exchange=exchange,
                                 mesh=mesh)
    return state, batch, step


def step_inputs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                group: Optional[GroupSpec] = None):
    """(inputs, step, n_agents) of a pair on the calling rank: the
    step's arguments on ``meta`` at the rank's shapes and the step
    itself. Train takes ``group``, by default the reference's
    ``GroupSpec(n_agents=<pod axis size>)`` (:func:`train_inputs`);
    prefill the rank's parameters and rows (:func:`prefill_on_mesh`);
    decode those and the rank's cache slice (:func:`decode_on_mesh`)."""
    if shape.kind == "train":
        names = tuple(mesh.mesh_dim_names)
        n_agents = mesh.size(names.index("pod")) if "pod" in names else 1
        spec = group or GroupSpec(n_agents=n_agents)
        state, batch, step = train_inputs(cfg, shape, mesh, spec)
        return (state, batch), step, spec.n_agents
    params, batch = _serve_inputs(cfg, shape, mesh)
    if shape.kind == "prefill":
        return ((params, batch),
                lambda p, b: prefill_on_mesh(cfg, shape, mesh, p, b), 1)
    cache = place_cache(cfg, shape, mesh, cache_specs(cfg, shape))
    return ((params, batch, cache),
            lambda p, b, c: decode_on_mesh(cfg, shape, mesh, p, b, c), 1)


def trace(cfg: ArchConfig, shape: ShapeConfig, mesh,
          group: Optional[GroupSpec] = None) -> Traced:
    """The calling rank's step of the pair (:func:`step_inputs`), traced
    on fresh ``meta`` inputs. A train step is traced at the first share
    step: the step that runs the most, a gradient, the window's
    accumulation, the estimator, the combine and the optimiser, as the
    reference's compiled step holds every branch."""
    return _run_traced(*step_inputs(cfg, shape, mesh, group))


# the reference's names (``lower_train``, ``lower_prefill``,
# ``lower_decode``): ``step_inputs`` picks the step by the shape's kind
trace_train = trace_prefill = trace_decode = trace


def dryrun_pair(arch_id: str, shape_name: str, mesh, *,
                group: Optional[GroupSpec] = None) -> DryrunResult:
    """Trace one (arch × shape) pair on the calling rank of ``mesh`` (a
    mesh of ``launch.mesh.make_traced_mesh``); return its roofline
    record. A pair that raises is recorded ``ok=False`` with its
    error."""
    from repro_torch.configs import arch_for_shape, get_arch_config
    from repro_torch.roofline import analyze, model_flops
    from repro_torch.roofline.collectives import collective_bytes
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_for_shape(get_arch_config(arch_id), shape_name)
    mesh_name = _mesh_name(mesh)
    chips = mesh.size()
    t0 = time.time()
    try:
        tr = trace(cfg, shape, mesh, group)
        mem = tr.memory()
        mflops = model_flops(cfg, shape, tr.n_agents)
        # the rank's counts scaled to the mesh, so the spec's
        # X / (chips · rate) formulas hold
        cost = {"flops": float(tr.flops) * chips,
                "bytes accessed": float(tr.bytes) * chips}
        coll = {k: v * chips
                for k, v in collective_bytes(tr.collectives).items()}
        roof = analyze(arch_id, shape, mesh_name, chips, cost, coll,
                       mflops, bytes_per_device=mem["total_bytes_per_device"])
        return DryrunResult(arch=arch_id, shape=shape_name,
                            mesh_name=mesh_name, ok=True, memory=mem,
                            roofline=roof.to_dict(),
                            compile_s=time.time() - t0, kernels=tr.kernels)
    except Exception as e:                      # noqa: BLE001
        import traceback
        return DryrunResult(arch=arch_id, shape=shape_name,
                            mesh_name=mesh_name, ok=False,
                            error=f"{type(e).__name__}: {e}\n"
                                  f"{traceback.format_exc(limit=8)}",
                            compile_s=time.time() - t0)
