"""DDAL at LLM scale — the streaming group-agent trainer of the model
zoo; the port of ``repro.core.sharded_ddal``, on one device or over
``torch.distributed`` on a two-level ``(pod, "agent")`` device mesh, a
``(data, model)`` device mesh or a ``(pod, data, model)`` one.

Each agent trains its own copy of a model on its own data stream
(``repro_torch.data.synthetic``). Parameters, AdamW moments and the
knowledge window are trees of stacked (n_agents, *param) leaves, as in
the reference. Knowledge is held in streaming form, per-agent
accumulators over the pieces generated since the last share step:

    tg = Σ_j T_j·g_j,  tsum = Σ_j T_j,  rg = Σ_j g_j,  rsum = Σ_j 1

and at a share step eq. 4 over the union of the windows is

    ḡ(dst) = ½ ( Σ_src tg_src / Σ_src tsum_src
               + Σ_src R[src,dst]·rg_src / Σ_src R[src,dst]·rsum_src )

(the global-sum fast path for ``full`` + uniform, the dense-R matmul,
or the neighbour-local sums over a topology's edge table), through the
exchange protocol's ``flat`` combiner (``repro_torch.core.exchange``).
A sketched estimator also carries the window's (n, d) gradient sketch
(``Knowledge.sk``), one ``grad_sketch`` launch per leaf per
accumulation step.

How the reference's traced program maps onto eager PyTorch:

* the step counter is a host ``int``: ``jax.lax.cond`` on it becomes a
  Python branch, so nothing is read back from the card to decide;
* ``jax.vmap(jax.value_and_grad(loss))`` is a loop over the agents, so
  only one agent's activations are live at a time; each agent's
  gradient is copied into one stacked (n, *param) buffer;
* ``segment_sum`` is ``index_add_``, ``.at[src, seg].add`` is
  ``index_put_(..., accumulate=True)``;
* the step writes the new parameters, moments and window into the
  state's tensors (the returned state holds the same tensors), and
  every elementwise pass runs a column chunk at a time
  (``common.pytree.column_chunks``), so no pass copies a whole tree: a
  pair of mamba2-780m agents (0.86 B parameters each) trains on one
  80 GB card. The share step's ḡ reuses the gradient buffer.

On a mesh (``make_group_train_step(..., mesh=...)``, the mesh from
``repro_torch.launch.mesh.make_pod_mesh``) each rank holds a contiguous
block of the agents, pod-major (``AgentShard``): their parameters,
moments and window rows (``launch.shardings.agent_sharded_state``),
while ``rel``, ``alive`` and the step stay global. A rank trains its
own agents on its own rows of the batch; at a share step the
estimator's inputs are gathered over the world (the (n, d) sketches,
or ``rg`` a column chunk at a time for exact ``grad_cos``), so every
rank holds the same ``rel``, and the combiner returns the rank's rows
of ḡ: the ``flat`` combiner gathers the window a column chunk at a time
and computes the rank's destination rows (the reference's GSPMD
path), the ``pod`` combiner runs ``repro_torch.core.pod_dispatch``'s
collectives. ``kill_agents`` / ``revive_agents`` take global masks and
apply them to the rank's rows. The collectives are ``torch.distributed``
ones, NCCL's on the card and gloo's on the host.

On a ``(data, model)`` mesh (``repro_torch.launch.mesh.make_debug_mesh``
/ ``make_production_mesh``) every rank holds every agent, and the
parameter leaves are cut by the reference's partition specs
(``launch.shardings.train_state_partition_specs``, placed by
``launch.shardings.place``): each rank holds its model-axis slice of
every parameter, AdamW moment and window leaf, and its B/d rows of each
agent's batch (``data.sharded.make_data_batch``). The step runs the
model's loss under ``train_rules(mesh)``, so every family's layers
take their split forms (``repro_torch.models.common``); the gradients
are summed over ``data`` (each data rank's loss is the global token
mean, so its gradient is its own rows' part); eq. 4, the window and
AdamW are elementwise and stay on each slice. What sums over all of an
agent's positions is taken as partial sums over the slices, a
replicated leaf counted on model rank 0 only, all-reduced over
``model`` (``common.sharding.ModelShards``): the gradient clip's norm,
exact ``grad_cos``'s dot products and norms, and the sketch (the
``grad_sketch`` kernel on each slice's positions in the full leaf). A
replicated leaf's gradient is the same on every model rank: where it
feeds split work, its value enters through ``copy_to_model``, whose
backward sums the ranks' parts (Mamba2's ``w_B`` / ``w_C`` / ``w_dt``,
``conv_B`` / ``conv_C``, ``dt_bias``, ``A_log`` and ``D``, the hybrid's
LoRA factors of a split target), or it acts after the split work's
all-reduce on the full value (the GELU MLP's ``b2``).

On a ``(pod, data, model)`` mesh (the reference's multi-pod mesh, one
agent block per pod) both hold: a rank keeps its pod's block of the
agents (``AgentShard`` over the ``pod`` axis's process group) and their
model-axis slices. The estimator gathers over ``pod`` what it sums over
``model`` (the sketch rows after their model-axis sum; exact
``grad_cos``'s window chunks before it), and the combine gathers each
window chunk over ``pod`` on the rank's slices (int8 codes and scales
where ``knowledge_quant_block > 0``), as the reference's GSPMD program
turns its sums over the agent axis into collectives over ``pod``.

Everything else is the reference's arithmetic: ``(T_t·g_f32)`` cast to
``knowledge_dtype`` and added, elastic rows held with a select, the
eps clamp once after the sums, the window reset after a share keeping
``rel`` and ``alive``. Sums over the agent axis and the small matmuls
run in another fp32 order than XLA's, so results agree to a tolerance
(the tests state it), while the int8 planes, the sketch signs, the
masks and the step flags are bitwise.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (column_chunks, init_stacked,
                                       tree_leaves_with_paths, tree_map)
from repro_torch.common.sharding import axis_names
from repro_torch.configs.base import DTYPES, NotPortedError
from repro_torch.core.weighting import training_experience
from repro_torch.kernels.ddal_wavg import ops as wavg_ops

EPS = 1e-12


class Knowledge(NamedTuple):
    tg: Any               # tree, leaves (A, *param) in knowledge_dtype
    tsum: torch.Tensor    # (A,) fp32
    rg: Any
    rsum: torch.Tensor    # (A,) fp32
    rel: Any = None       # the estimator's learned (A, A) R, kept across
                          # window resets; None when nothing is learned
    sk: Any = None        # (A, d) fp32 window sketch (sketched estimator)
    alive: Any = None     # (A,) bool elastic mask, kept across resets


class TrainState(NamedTuple):
    params: Any           # tree, leaves (A, *param)
    opt_state: Any
    know: Knowledge
    step: int             # host int (the reference's () int32)


def _leaves(tree):
    return [x for _, x in tree_leaves_with_paths(tree)]


# ---------------------------------------------------------------------
# placement of the agents: a (pod, "agent") or a (pod, data, model) mesh
# ---------------------------------------------------------------------
class AgentShard(NamedTuple):
    """A rank's block of the group's agents. On a two-level ``(pod_axis,
    "agent")`` mesh agents are laid out pod-major over the whole world,
    so the rank at mesh coordinate (p, a) — global rank ``p·A_dev + a``,
    ``init_device_mesh``'s row-major order — holds agents ``index·block
    .. (index + 1)·block − 1`` with ``index = p·A_dev + a``, and
    ``group`` is ``None`` (the world). On a ``(pod_axis, "data",
    "model")`` mesh the block is the pod's: ``index`` is the rank's
    ``pod_axis`` coordinate, ``ranks`` the axis's size and ``group`` its
    process group (the ranks that share the rank's (data, model)
    coordinate)."""
    n_agents: int
    index: int            # the rank's coordinate over the agent blocks
    ranks: int            # the blocks: ranks of ``group``
    group: Any = None     # the process group gathers run over (None: world)

    @property
    def block(self) -> int:
        return self.n_agents // self.ranks

    @property
    def rows(self) -> slice:
        return slice(self.index * self.block, (self.index + 1) * self.block)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every block's (block, ...) rows → the group's (n_agents, ...),
        in agent order (``all_gather`` over ``group``)."""
        return gather_rows(x, self.ranks, self.group)


def gather_rows(x: torch.Tensor, size: int, group) -> torch.Tensor:
    """``all_gather`` of ``x`` over ``group`` (``size`` ranks, ``None``:
    the world), the parts concatenated along dim 0 in group-rank order
    (the list form, which gloo and NCCL both run)."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


MODEL_AXES = ("data", "model")


def mesh_kind(mesh, pod_axis: str = "pod",
              agent_axis: str = "agent") -> Optional[str]:
    """``"pod"`` for the two-level ``(pod_axis, agent_axis)`` mesh,
    ``"model"`` for a ``(data, model)`` mesh, ``"pod_model"`` for the
    ``(pod_axis, data, model)`` mesh (agents over ``pod_axis`` beside the
    model axis), ``None`` for no mesh; any other raises
    ``NotPortedError``."""
    if mesh is None:
        return None
    names = axis_names(mesh)
    if names == (pod_axis, agent_axis):
        return "pod"
    if names == MODEL_AXES:
        return "model"
    if names == (pod_axis,) + MODEL_AXES:
        return "pod_model"
    raise NotPortedError(
        f"a device mesh with axes {names or None} is none of the meshes "
        f"of Slice E: the ({pod_axis!r}, {agent_axis!r}) pod mesh, a "
        f"(data, model) mesh or the ({pod_axis!r}, 'data', 'model') mesh")


def mesh_axes(mesh, pod_axis: str = "pod", agent_axis: str = "agent"):
    """(pod devices, agent devices) of a two-level pod mesh; a ``(data,
    model)`` mesh gives (data devices, model devices); any other mesh
    raises ``ValueError`` (``NotPortedError`` for an unknown one,
    ``mesh_kind``)."""
    if mesh_kind(mesh, pod_axis, agent_axis) not in ("pod", "model"):
        raise ValueError(f"a mesh with axes {axis_names(mesh)} has three "
                         f"axes, not two")
    return mesh.size(0), mesh.size(1)


def agent_shard(mesh, n_agents: int, pod_axis: str = "pod") -> AgentShard:
    """The calling rank's ``AgentShard`` on ``mesh``, after checking the
    placement: the mesh spans the whole process group in
    ``init_device_mesh``'s row-major rank order, and the agents split
    evenly over its devices (the pod mesh) or over its ``pod_axis``
    (the ``(pod, data, model)`` mesh)."""
    import torch.distributed as dist
    kind = mesh_kind(mesh, pod_axis)
    if kind not in ("pod", "pod_model"):
        raise ValueError(
            f"a mesh with axes {axis_names(mesh)} places no agents: each "
            f"rank of a (data, model) mesh holds every agent")
    ranks = mesh.size()
    dims = " x ".join(str(mesh.size(d))
                      for d in range(len(axis_names(mesh))))
    if not dist.is_initialized() or dist.get_world_size() != ranks:
        raise ValueError(
            f"the {dims} mesh must span the whole process group (world size "
            f"{dist.get_world_size() if dist.is_initialized() else 0})")
    if mesh.mesh.flatten().tolist() != list(range(ranks)):
        raise ValueError(
            f"the mesh's ranks {mesh.mesh.tolist()} are not in row-major "
            f"order (init_device_mesh's layout, which pod-major agent "
            f"blocks assume)")
    if kind == "pod_model":
        pods = mesh.size(0)
        if n_agents % pods:
            raise ValueError(
                f"{n_agents} agents do not split evenly over the mesh's "
                f"{pods}-device {pod_axis!r} axis")
        return AgentShard(n_agents=n_agents,
                          index=mesh.get_local_rank(pod_axis), ranks=pods,
                          group=mesh.get_group(pod_axis))
    n_pod, n_agent = mesh_axes(mesh, pod_axis)
    if n_agents % ranks:
        raise ValueError(
            f"{n_agents} agents do not split evenly over the mesh's "
            f"{ranks} devices")
    index = mesh.get_local_rank(pod_axis) * n_agent + mesh.get_local_rank(
        "agent")
    return AgentShard(n_agents=n_agents, index=index, ranks=ranks)


def _local_rows(know: "Knowledge", shard: Optional[AgentShard] = None):
    """The slice of the global ``alive`` mask that ``know``'s rows are:
    ``None`` for a state that holds every agent; on a mesh the rank's
    block, ``shard.rows``. Without ``shard`` the block index is the
    global rank, which is right on the pod mesh only (its blocks lie in
    rank order over the world); a state of another placement raises."""
    if know.alive is None or know.tsum.shape[0] == know.alive.shape[0]:
        return None
    if shard is not None:
        return shard.rows
    import torch.distributed as dist
    block = know.tsum.shape[0]
    if dist.get_world_size() * block != know.alive.shape[0]:
        raise ValueError(
            f"a state of {block} of {know.alive.shape[0]} agents over "
            f"{dist.get_world_size()} ranks is not a pod mesh's: pass the "
            f"rank's AgentShard (shard=exchange.shard)")
    r = dist.get_rank()
    return slice(r * block, (r + 1) * block)


def _rows(tree):
    """(A, p) views of a tree's stacked leaves, in leaf order."""
    return [x.reshape(x.shape[0], -1) for x in _leaves(tree)]


def init_knowledge(params, dtype=torch.float32, rel=None,
                   sketch_dim: int = 0, alive=None) -> Knowledge:
    """A zeroed share window shaped like ``params``; ``rel`` (the learned
    relevance) and ``alive`` (the elastic mask) ride across the reset,
    ``sketch_dim > 0`` adds the (A, d) window sketch."""
    first = _leaves(params)[0]
    A, dev = first.shape[0], first.device

    def zeros(x):
        return torch.zeros(x.shape, dtype=dtype, device=dev)

    sk = (torch.zeros((A, sketch_dim), dtype=torch.float32, device=dev)
          if sketch_dim > 0 else None)
    return Knowledge(tg=tree_map(zeros, params),
                     tsum=torch.zeros((A,), dtype=torch.float32, device=dev),
                     rg=tree_map(zeros, params),
                     rsum=torch.zeros((A,), dtype=torch.float32, device=dev),
                     rel=rel, sk=sk, alive=alive)


def _reset_window_(know: Knowledge, rel) -> Knowledge:
    """``init_knowledge`` in place: the window sums and the sketch back
    to zero, the new ``rel`` and the old ``alive`` kept."""
    for x in _leaves(know.tg) + _leaves(know.rg):
        x.zero_()
    know.tsum.zero_()
    know.rsum.zero_()
    if know.sk is not None:
        know.sk.zero_()
    return know._replace(rel=rel)


def init_train_state(cfg, spec, opt, seed: int = 0, exchange=None,
                     device=None, mesh=None) -> TrainState:
    """Random initialisation on ``device`` (``None``: the card; ``meta``
    gives the shapes alone): agent i's parameters are the model's
    ``init`` drawn i-th from one generator seeded by ``seed`` (the
    reference splits a key per agent; the draws are the port's own),
    the optimiser's moments at zero and the window empty. The relevance
    seed and the sketch width come from the exchange protocol
    (``exchange``, built from ``spec`` if not given).

    ``mesh`` (a ``(data, model)`` or ``(spec.pod_axis, "data",
    "model")`` ``DeviceMesh``, or a ``common.sharding.MeshPoint`` that
    describes one rank of it) draws the calling rank's slice only:
    bitwise ``launch.shardings.place(init_train_state(...),
    state_placement_specs(...), mesh, cfg)``. The draws keep their
    order: each agent is drawn a layer at a time (``common.pytree.
    init_stacked``), every drawn tree cut to the rank's slice at once
    (``launch.shardings.init_cut``); an agent of another pod is drawn
    and dropped. The moments and the window are zeros at the slice's
    shapes. The memory it takes is the rank's state plus the largest
    tree drawn whole for one agent (a layer, the embedding or the
    head)."""
    from repro_torch.core.exchange import build_exchange
    from repro_torch.models import get_model
    if exchange is None:
        exchange = build_exchange(spec, kind="streaming")
    dev = resolve_device(device)
    model = get_model(cfg)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    if mesh is None:
        params = init_stacked(spec.n_agents,
                              lambda: model.init(cfg, gen, dev))
    else:
        params = _init_params_sliced(cfg, spec, exchange, model, gen, dev,
                                     mesh)
    alive = (torch.ones((spec.n_agents,), dtype=torch.bool, device=dev)
             if spec.elastic else None)
    know = init_knowledge(params, DTYPES[spec.knowledge_dtype],
                          rel=exchange.streaming_rel_init(dev),
                          sketch_dim=exchange.sketch_dim, alive=alive)
    return TrainState(params=params, opt_state=opt.tree_init(params),
                      know=know, step=0)


def _init_params_sliced(cfg, spec, exchange, model, gen, dev, mesh):
    """The rank's slices of every agent's parameters, drawn in the
    one-device order (``init_train_state``)."""
    from repro_torch.common.pytree import slicing
    from repro_torch.launch import shardings as SH
    if mesh_kind(mesh, spec.pod_axis) not in ("model", "pod_model"):
        raise ValueError(
            f"a sliced init takes a (data, model) or a ({spec.pod_axis!r}, "
            f"'data', 'model') mesh, not axes {axis_names(mesh)}")
    A = spec.n_agents
    specs = SH.state_placement_specs(cfg, mesh, exchange.estimator.learns,
                                     exchange.sketch_dim, spec.pod_axis)
    ps = SH.placement_spec(cfg, mesh, (), tuple(specs.know.tsum), (A,))
    rows = SH.local_slices(mesh, ps, (A,))[0]
    keep, drop = SH.init_cut(cfg, mesh, True), SH.init_cut(cfg, mesh, False)
    n = rows.stop - rows.start
    params = None
    for i in range(A):
        held = rows.start <= i < rows.stop
        with slicing(keep if held else drop):
            p_i = model.init(cfg, gen, dev)
        if not held:
            continue
        if params is None:
            params = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                              p_i)
        j = i - rows.start
        tree_map(lambda dst, x: dst[j].copy_(x), params, p_i)
        del p_i
    return params


# ---------------------------------------------------------------------
# eq. 4 over the window: the combiners' arithmetic
# ---------------------------------------------------------------------
def _dead_rows_zeroed(x: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """``x`` (A, ...) with the rows of agents not ``alive`` set to 0."""
    m = alive.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(m, x, torch.zeros_like(x))


def _int8_roundtrip(tree, q_block: int):
    """A tree of stacked (A, ...) leaves, or one (A, p) tensor, through
    the int8 wire format and back to fp32 (``ddal_wavg.ops.
    quantize_tree`` / ``dequantize_tree``)."""
    q, s = wavg_ops.quantize_tree(tree, q_block, lead=1)
    return wavg_ops.dequantize_tree(q, s, q_block)


def _gate(x2: torch.Tensor, cols: slice, alive, q_block: int,
          gather=None) -> torch.Tensor:
    """One column chunk of a window leaf as the combine reads it: dead
    agents' rows zeroed (``mask_knowledge``), then the int8 round trip
    (``quantize_knowledge_roundtrip``) when ``q_block > 0``. Chunks hold
    whole int8 blocks, so the round trip is the leaf's. ``gather`` (on a
    mesh) collects the rows of every rank after the gate: the int8
    planes and their scales when ``q_block > 0`` (the wire format),
    else the planes, in their dtype."""
    c = x2[:, cols]
    if alive is not None:
        c = _dead_rows_zeroed(c, alive)
    if q_block > 0:
        q, s = wavg_ops.quantize_tree(c, q_block, lead=1)
        if gather is not None:
            q, s = gather(q), gather(s)
        return wavg_ops.dequantize_tree(q, s, q_block)
    return c if gather is None else gather(c)


def _scalars(know: Knowledge, alive):
    if alive is None:
        return know.tsum, know.rsum
    return (_dead_rows_zeroed(know.tsum, alive),
            _dead_rows_zeroed(know.rsum, alive))


_split = threading.local()


@contextlib.contextmanager
def model_slices(shards):
    """Within this scope the window's leaves are the rank's model-axis
    slices described by ``shards`` (a ``ModelShards``): the combiners'
    int8 round trip then takes each block's scale over the full leaf."""
    prev = getattr(_split, "shards", None)
    _split.shards = shards
    try:
        yield
    finally:
        _split.shards = prev


def _block_ids(cols: slice, leaf, q_block: int, device) -> torch.Tensor:
    """The full leaf's int8 block of each local column in ``cols`` of a
    slice (``LeafShard``)."""
    stride, c0, width = leaf.position_map()
    q = torch.arange(cols.start, cols.stop, dtype=torch.int64, device=device)
    return ((q // width) * stride + c0 + q % width) // q_block


def _blocks_split(leaf, q_block: int) -> bool:
    """Whether a slice's int8 blocks are not whole blocks of the full
    leaf (then each block's scale is taken over the ranks)."""
    if leaf.dim is None:
        return False                 # the whole leaf on every rank
    stride, c0, width = leaf.position_map()
    rows = int(np.prod(leaf.shape)) // stride
    return bool(width % q_block or c0 % q_block
                or (rows > 1 and stride % q_block))


def _split_scales(x2: torch.Tensor, alive, q_block: int, leaf,
                  axis) -> torch.Tensor:
    """(A, blocks of the full leaf) int8 scales of a slice ``x2`` (A,
    p_local): each block's largest |x| over the rank's part of it (dead
    rows zeroed), the largest over the model axis, times f32(1/127) as
    ``ddal_wavg.ref.quantize_rows`` takes it."""
    import torch.distributed as dist
    A = x2.shape[0]
    nb = -(-int(np.prod(leaf.shape)) // q_block)
    amax = torch.zeros((A, nb), dtype=torch.float32, device=x2.device)
    for cols in column_chunks(x2.shape[1]):
        c = x2[:, cols].to(torch.float32)
        if alive is not None:
            c = _dead_rows_zeroed(c, alive)
        blk = _block_ids(cols, leaf, q_block, x2.device)
        amax.scatter_reduce_(1, blk.expand(A, -1), torch.abs(c), "amax")
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=axis.group)
    return amax * (1.0 / 127.0)


def _gate_split(x2: torch.Tensor, cols: slice, alive, q_block: int,
                scale: torch.Tensor, leaf, gather=None,
                scale_all: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_gate`` of a slice whose int8 blocks straddle ranks: the round
    trip of each element with its full block's scale (``_split_scales``),
    the arithmetic of ``ddal_wavg.ref.quantize_rows`` /
    ``dequantize_rows``, so the values are the one-device round trip's.
    ``gather`` (agents over ``pod`` beside the model axis) collects the
    int8 codes over the agent blocks, and ``scale_all`` is ``scale``
    gathered the same way: the wire format crosses ranks, not fp32."""
    c = x2[:, cols].to(torch.float32)
    if alive is not None:
        c = _dead_rows_zeroed(c, alive)
    blk = _block_ids(cols, leaf, q_block, x2.device)
    s = scale[:, blk]
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(c / safe), -127, 127)
    if gather is None:
        return q * s
    return gather(q.to(torch.int8)).to(torch.float32) * scale_all[:, blk]


def _eq4(know: Knowledge, fold: Callable, out=None, alive=None,
         q_block: int = 0, gather=None, rows: Optional[slice] = None):
    """ḡ leaf by leaf and chunk by chunk: ``fold(tg_chunk, rg_chunk)``
    → the (A, cols) fp32 result, written into ``out`` (a tree of fp32
    leaves shaped like the window, allocated if ``None``). On a mesh
    ``alive`` is the mask of ``know``'s own rows, ``gather`` collects
    the gated chunk's rows over the ranks the fold reads, and ``rows``
    picks the rank's destination rows out of the fold's result. Under
    ``model_slices`` (a model axis) a slice whose int8 blocks straddle
    ranks takes its scales over the model axis, and then ``gather``
    collects its int8 codes and scales."""
    if out is None:
        out = tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                             device=x.device), know.tg)
    shards = getattr(_split, "shards", None)
    for i, (t2, r2, o2) in enumerate(zip(_rows(know.tg), _rows(know.rg),
                                         _rows(out))):
        leaf = None if shards is None else shards.leaves[i]
        if q_block > 0 and leaf is not None and _blocks_split(leaf,
                                                              q_block):
            st, sr = (_split_scales(x, alive, q_block, leaf, shards.axis)
                      for x in (t2, r2))
            st_all, sr_all = ((None, None) if gather is None
                              else (gather(st), gather(sr)))

            def gate(x2, cols, scale, scale_all):
                return _gate_split(x2, cols, alive, q_block, scale, leaf,
                                   gather, scale_all)
            for cols in column_chunks(t2.shape[1]):
                g = fold(gate(t2, cols, st, st_all),
                         gate(r2, cols, sr, sr_all))
                o2[:, cols].copy_(g if rows is None else g[rows])
            continue
        for cols in column_chunks(t2.shape[1]):
            g = fold(_gate(t2, cols, alive, q_block, gather),
                     _gate(r2, cols, alive, q_block, gather))
            o2[:, cols].copy_(g if rows is None else g[rows])
    return out


def _sharded(know: Knowledge, alive, shard: Optional[AgentShard]):
    """(``know`` with the group's tsum / rsum, the alive mask of
    ``know``'s own rows, the eq4 keywords) for a combine on ``shard``'s
    rows; ``shard=None`` changes nothing."""
    if shard is None:
        return know, alive, {}
    know_g = know._replace(tsum=shard.gather(know.tsum),
                           rsum=shard.gather(know.rsum))
    local = None if alive is None else alive[shard.rows]
    return know_g, local, {"gather": shard.gather, "rows": shard.rows}


def _global_fold(know: Knowledge, R, uniform: bool, alive):
    """The fold of ``_combine``: the global-sum fast path (uniform) or
    the dense-R eq. 4, T̂ global either way."""
    tsum, rsum = _scalars(know, alive)
    if uniform:
        ts = torch.clamp_min(torch.sum(tsum), EPS)
        rs = torch.clamp_min(torch.sum(rsum), EPS)

        def fold(tg, rg):
            t = torch.sum(tg, dim=0).to(torch.float32) / ts
            r = torch.sum(rg, dim=0).to(torch.float32) / rs
            return (0.5 * (t + r))[None].expand(tg.shape[0], -1)
        return fold
    R = R.to(torch.float32)
    r_t = torch.clamp_min(torch.sum(tsum), EPS)
    rden = torch.clamp_min(rsum @ R, EPS)

    def fold(tg, rg):
        t = torch.sum(tg, dim=0).to(torch.float32) / r_t
        r = (R.T @ rg.to(torch.float32)) / rden[:, None]
        return 0.5 * (t[None] + r)
    return fold


def _combine(know: Knowledge, R, uniform: bool, out=None, alive=None,
             q_block: int = 0, shard: Optional[AgentShard] = None):
    """eq. 4 over the union of every agent's window → per-destination
    ḡ, a tree of (A, *param) fp32 leaves (identical rows when uniform).
    ``alive`` and ``q_block`` apply the combiners' gate on the way in
    (dead rows zeroed, the int8 round trip). With ``shard`` (a mesh)
    ``know`` holds the rank's rows and ḡ is the rank's rows; ``alive``
    stays the group's mask."""
    know_g, local, kw = _sharded(know, alive, shard)
    return _eq4(know, _global_fold(know_g, R, uniform, alive), out, local,
                q_block, **kw)


def _edge_weights(know: Knowledge, nbr, mask, rel, alive=None):
    """The edge list as dense src→dst weights: (M, tden, Rd, rden), M
    and Rd (A, A) with M[src, dst] the mask and Rd[src, dst] the
    relevance summed over dst's edge slots, tden / rden the eq. 4
    denominators Σ over dst's edges of tsum[src] / rel·rsum[src]
    (before the eps clamp)."""
    A, k = nbr.shape
    dev = know.tsum.device
    src = nbr.reshape(-1).long()
    seg = torch.arange(A, device=dev).repeat_interleave(k)
    m = mask.reshape(-1).to(torch.float32)
    relf = torch.where(mask, rel.to(torch.float32),
                       torch.zeros((), dtype=torch.float32,
                                   device=dev)).reshape(-1)
    tsum, rsum = _scalars(know, alive)
    zeros = torch.zeros((A,), dtype=torch.float32, device=dev)
    tden = zeros.index_add(0, seg, m * tsum[src])
    rden = zeros.index_add(0, seg, relf * rsum[src])
    z2 = torch.zeros((A, A), dtype=torch.float32, device=dev)
    Rd = z2.index_put((src, seg), relf, accumulate=True)
    M = z2.index_put((src, seg), m, accumulate=True)
    return M, tden, Rd, rden


def _edge_sums(know: Knowledge, nbr, mask, rel, weights=None):
    """The reference's ``_edge_sums``: eq. 4 numerators and denominators
    over one edge list, (tnum, tden, rnum, rden), the numerators trees
    of (A, *param) fp32 leaves (Mᵀ·tg and Rdᵀ·rg over the agent axis).
    ``weights``: ``_edge_weights``' result, if it is already known."""
    M, tden, Rd, rden = weights or _edge_weights(know, nbr, mask, rel)
    tnum = tree_map(lambda g: torch.tensordot(
        M.T, g.to(torch.float32), dims=1), know.tg)
    rnum = tree_map(lambda g: torch.tensordot(
        Rd.T, g.to(torch.float32), dims=1), know.rg)
    return tnum, tden, rnum, rden


def _finish_combine(tnum, tden, rnum, rden):
    """ḡ = ½(t / T̂ + r / R̂), the eps clamp applied once, after the sums."""
    tden = torch.clamp_min(tden, EPS)
    rden = torch.clamp_min(rden, EPS)

    def avg(t, r):
        ex = (-1,) + (1,) * (t.ndim - 1)
        return 0.5 * (t / tden.reshape(ex) + r / rden.reshape(ex))
    return tree_map(avg, tnum, rnum)


def topo_tables(topo, device):
    """(nbr int64, mask bool, relevance fp32) of ``topo`` on ``device``
    (its tables are host arrays, the relevance a device tensor once the
    learned R is gathered onto it)."""
    return (torch.as_tensor(np.asarray(topo.nbr), dtype=torch.int64,
                            device=device),
            torch.as_tensor(np.asarray(topo.mask), device=device),
            torch.as_tensor(topo.relevance, dtype=torch.float32,
                            device=device))


def _combine_topo(know: Knowledge, topo, out=None, alive=None,
                  q_block: int = 0, shard: Optional[AgentShard] = None):
    """eq. 4 with neighbour-local normalisation: both terms of each
    destination sum over its in-edges only (``_edge_sums`` then
    ``_finish_combine``, a column chunk at a time, the edge weights
    formed once). ``shard`` as in ``_combine``: each chunk of the
    window is gathered over the world and the rank keeps its rows, so
    the result is bitwise the single-process one."""
    nbr, mask, rel = topo_tables(topo, know.tsum.device)
    know_g, local, kw = _sharded(know, alive, shard)
    weights = _edge_weights(know_g, nbr, mask, rel, alive)

    def fold(tg, rg):
        chunk = know_g._replace(tg=tg, rg=rg)
        return _finish_combine(*_edge_sums(chunk, nbr, mask, rel, weights))
    return _eq4(know, fold, out, local, q_block, **kw)


def drop_topology_edges(topo, keep):
    """Cut the edges whose message did not survive this share round
    (``keep``: host (n, k) bool from ``Transport.deliver_mask``): mask
    False and relevance exactly 0, so both eq. 4 sums skip the edge.
    The self-loop always survives and the eps clamp covers a
    destination with no edge left, so a faulty round degrades toward
    the local window, never toward NaN."""
    k = np.asarray(keep, bool)
    rel = topo.relevance
    if isinstance(rel, torch.Tensor):
        rel = torch.where(torch.as_tensor(k, device=rel.device), rel,
                          torch.zeros((), dtype=rel.dtype,
                                      device=rel.device))
    else:
        rel = np.where(k, np.asarray(rel, np.float32), np.float32(0.0))
    return topo._replace(mask=np.asarray(topo.mask, bool) & k,
                         relevance=rel)


# ---------------------------------------------------------------------
# elastic membership (alive-masked exchange)
# ---------------------------------------------------------------------
def _select_rows(mask, new, old):
    """Per-agent row select over matching trees: rows where ``mask`` is
    True from ``new``, the rest from ``old``."""
    m = torch.as_tensor(mask, dtype=torch.bool)

    def sel(n_, o_):
        mm = m.to(n_.device).reshape((-1,) + (1,) * (n_.ndim - 1))
        return torch.where(mm, n_, o_)
    return tree_map(sel, new, old)


def mask_knowledge(know: Knowledge, alive) -> Knowledge:
    """Dead agents' window rows (tg / rg leaves, tsum / rsum, the sketch)
    zeroed, so their eq. 4 numerators and denominators are exactly 0 in
    every combine path; ``rel`` and ``alive`` ride through. ``alive``
    ``None`` returns ``know`` as it is."""
    if alive is None:
        return know
    a = torch.as_tensor(alive, dtype=torch.bool, device=know.tsum.device)

    def rows(x):
        return _dead_rows_zeroed(x, a)
    return know._replace(
        tg=tree_map(rows, know.tg), rg=tree_map(rows, know.rg),
        tsum=rows(know.tsum), rsum=rows(know.rsum),
        sk=None if know.sk is None else rows(know.sk))


def quantize_knowledge_roundtrip(know: Knowledge, q_block: int
                                 ) -> Knowledge:
    """The window's gradient planes (tg / rg) through the int8 wire
    format (``ddal_wavg.ops.quantize_tree`` / ``dequantize_tree``), as
    every cross-agent hop carries them when ``knowledge_quant_block >
    0``; ``q_block <= 0`` is the identity."""
    if q_block <= 0:
        return know
    return know._replace(tg=_int8_roundtrip(know.tg, q_block),
                         rg=_int8_roundtrip(know.rg, q_block))


def clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` whose tensors are its own: the train step
    updates a state's tensors in place, so a snapshot to splice agents
    back from (``revive_agents(restore=...)``) is taken with this (or
    saved with ``repro_torch.checkpoint.save_train``)."""
    def cp(x):
        if isinstance(x, dict):
            return {k: cp(v) for k, v in x.items()}
        return x.clone() if isinstance(x, torch.Tensor) else x
    know = type(state.know)(*(cp(x) for x in state.know))
    return state._replace(params=cp(state.params),
                          opt_state=cp(state.opt_state), know=know)


def kill_agents(state: TrainState, dead,
                shard: Optional[AgentShard] = None) -> TrainState:
    """Mark ``dead`` ((A,) bool) agents gone: their partial window is
    zeroed, their parameter and optimiser rows freeze, ``rel`` holds.
    Snapshot the state first (``clone_state``) to splice an agent back
    later. On a mesh the state holds the rank's rows: ``shard`` (the
    exchange's ``AgentShard``) names them (``_local_rows``)."""
    know = state.know
    if know.alive is None:
        raise ValueError(
            "kill_agents needs an elastic TrainState — build the spec "
            "with GroupSpec(elastic=True) so Knowledge.alive exists")
    alive = know.alive & ~torch.as_tensor(dead, dtype=torch.bool,
                                          device=know.alive.device)
    rows = _local_rows(know, shard)
    own = alive if rows is None else alive[rows]
    return state._replace(
        know=mask_knowledge(know, own)._replace(alive=alive))


def revive_agents(state: TrainState, mask,
                  restore: Optional[TrainState] = None,
                  shard: Optional[AgentShard] = None) -> TrainState:
    """Flip ``mask`` ((A,) bool) agents back alive with an empty window;
    with ``restore`` (a checkpointed ``TrainState``) their parameter and
    optimiser rows splice back from it, every survivor's untouched.
    ``shard`` as in ``kill_agents``."""
    know = state.know
    if know.alive is None:
        raise ValueError(
            "revive_agents needs an elastic TrainState — build the spec "
            "with GroupSpec(elastic=True) so Knowledge.alive exists")
    m = torch.as_tensor(mask, dtype=torch.bool, device=know.alive.device)
    rows = _local_rows(know, shard)
    own = m if rows is None else m[rows]
    know = mask_knowledge(know, ~own)._replace(alive=know.alive | m)
    params, opt_state = state.params, state.opt_state
    if restore is not None:
        params = _select_rows(own, restore.params, params)
        opt_state = _select_rows(own, restore.opt_state, opt_state)
    return state._replace(params=params, opt_state=opt_state, know=know)


# ---------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------
class TensorParallel(NamedTuple):
    """The trainer's view of a ``(data, model)`` mesh: the mesh, its
    rule table, the data and model axes (``AxisGroup`` s) and the rank's
    parameter slices (``ModelShards``)."""
    mesh: Any
    rules: dict
    data: Any
    model: Any
    shards: Any

    def all_reduce_data_(self, tree) -> None:
        """Every leaf of ``tree`` summed over the data axis, in place."""
        import torch.distributed as dist
        for x in _leaves(tree):
            dist.all_reduce(x, group=self.data.group)


def tensor_parallel(cfg, mesh) -> TensorParallel:
    """The ``TensorParallel`` of ``cfg`` on a ``(data, model)`` or a
    ``(pod, data, model)`` mesh (every family splits over its model
    axis; ``train_rules`` puts the agents over ``pod``)."""
    from repro_torch.common.sharding import (ModelShards, axis_rules,
                                             mesh_axis, set_mesh)
    from repro_torch.launch.mesh import train_rules
    from repro_torch.launch.shardings import leaf_shards
    if cfg is None:
        raise ValueError("a (data, model) mesh needs the model's config "
                         "(its leaves are cut by the partition specs)")
    rules = train_rules(mesh)
    with axis_rules(rules), set_mesh(mesh):
        data, model = mesh_axis("batch"), mesh_axis("ff")
    return TensorParallel(mesh, rules, data, model,
                          ModelShards(leaf_shards(cfg, mesh, rules), model))


def value_and_grads(loss_fn: Callable, params, batch, out) -> torch.Tensor:
    """Each agent's loss and gradient: the reference's
    ``vmap(value_and_grad(loss_fn))`` as a loop over the agents, agent
    i's gradient copied into row i of ``out`` (a tree of stacked leaves
    like ``params``). Returns the (A,) fp32 losses."""
    out_leaves = _leaves(out)
    A = out_leaves[0].shape[0]
    losses = []
    for i in range(A):
        p_i = tree_map(lambda x: x[i].detach().requires_grad_(True), params)
        leaves = _leaves(p_i)
        b_i = tree_map(lambda v: v[i], batch)
        with torch.enable_grad():
            loss = loss_fn(p_i, b_i)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for dst, g in zip(out_leaves, grads):
            if g is None:
                dst[i].zero_()
            else:
                dst[i].copy_(g)
        losses.append(loss.detach().to(torch.float32))
        del loss, grads, p_i, leaves
    return torch.stack(losses)


def _accumulate_(know: Knowledge, grads, T_t: float, kdt, alive):
    """The window takes this step's piece in place: tg += (T_t·g)→kdt,
    rg += g→kdt, tsum += T_t, rsum += 1; with ``alive`` dead rows hold."""
    for t2, r2, g2 in zip(_rows(know.tg), _rows(know.rg), _rows(grads)):
        for cols in column_chunks(g2.shape[1]):
            g = g2[:, cols]
            t_new = t2[:, cols] + (T_t * g.to(torch.float32)).to(kdt)
            r_new = r2[:, cols] + g.to(kdt)
            if alive is not None:
                t_new = torch.where(alive[:, None], t_new, t2[:, cols])
                r_new = torch.where(alive[:, None], r_new, r2[:, cols])
            t2[:, cols].copy_(t_new)
            r2[:, cols].copy_(r_new)
    if alive is None:
        know.tsum.add_(T_t)
        know.rsum.add_(1.0)
    else:
        zero = torch.zeros_like(know.tsum)
        know.tsum.add_(torch.where(alive, torch.full_like(zero, T_t), zero))
        know.rsum.add_(torch.where(alive, torch.ones_like(zero), zero))


def make_group_train_step(cfg, spec, opt, relevance=None,
                          loss_fn: Optional[Callable] = None,
                          topology=None, mesh=None, exchange=None):
    """The DDAL streaming train step: ``step(state, batch) -> (state',
    metrics)``, ``batch`` a dict of (n_agents, ...) tensors on the
    state's device (each agent's own stream). ``loss_fn(params, batch)``
    defaults to the model's loss (``get_model(cfg).loss``).

    Warm-up steps (``step < threshold``) apply each agent's own
    gradient; later steps add it to the window, and every
    ``minibatch``-th step is a share step: the estimator observes the
    window (or its sketch), the combiner runs eq. 4, the optimiser
    applies ḡ and the window resets. ``metrics``: ``loss`` (A,) fp32 on
    the device, ``step`` and ``shared`` host ints. The step updates the
    state's tensors in place and returns a state holding them.

    ``mesh`` (a ``(spec.pod_axis, "agent")`` ``DeviceMesh``,
    ``repro_torch.launch.mesh.make_pod_mesh``) runs the step on the
    calling rank's block of agents: the state from
    ``launch.shardings.agent_sharded_state``, ``batch`` the rank's rows
    (``repro_torch.data.sharded``); ``loss`` is still the group's (A,)
    losses. A prebuilt ``exchange`` carries its mesh from
    ``build_exchange(..., mesh=...)``.

    ``mesh`` (a ``("data", "model")`` ``DeviceMesh``) runs the step on
    the rank's slices: the state placed by
    ``launch.shardings.place(state, train_state_partition_specs(...),
    mesh, cfg)``, ``batch`` the rank's rows of every agent
    (``data.sharded.make_data_batch``); ``loss`` is each agent's loss
    over the global batch. It may come with a prebuilt ``exchange`` (it
    places no agents, so the protocol does not carry it).

    ``mesh`` (a ``(spec.pod_axis, "data", "model")`` ``DeviceMesh``)
    does both: the rank holds its pod's block of agents
    (``exchange.shard``, gathered over ``pod_axis``) and their slices
    (``launch.shardings.place`` by ``train_state_partition_specs(cfg,
    train_rules(mesh), pod_axis, ...)``), ``batch`` its B/d rows of each
    of those agents (``data.make_data_batch(..., rows=shard.rows)``).
    The gradients are summed over ``data``; the estimator gathers over
    ``pod`` and sums over ``model``; the combine gathers the window's
    chunks (the int8 codes and scales) over ``pod`` on the rank's
    slices and keeps its destination rows. ``loss`` is the group's
    (A,).
    """
    if loss_fn is None:
        from repro_torch.models import get_model
        model = get_model(cfg)

        def loss_fn(params, batch):        # noqa: F811
            return model.loss(cfg, params, batch)
    tensor = None
    kind = mesh_kind(mesh, spec.pod_axis)
    if kind in ("model", "pod_model"):
        tensor = tensor_parallel(cfg, mesh)
        if exchange is not None:
            mesh = None             # a prebuilt protocol carries its shard
        if exchange is not None and kind == "pod_model" and (
                exchange.shard is None):
            raise ValueError(
                "a (pod, data, model) mesh places the agents over pod: "
                "build the exchange with build_exchange(..., mesh=mesh)")
    if exchange is None:
        from repro_torch.core.exchange import build_exchange
        exchange = build_exchange(spec, kind="streaming", topology=topology,
                                  relevance=relevance, mesh=mesh)
    elif exchange.kind != "streaming":
        raise ValueError(
            f"the streaming train step needs a 'streaming' exchange "
            f"protocol, got {exchange.kind!r}")
    elif (topology is not None or relevance is not None
          or mesh is not None):
        raise ValueError(
            "topology/relevance/mesh would be silently ignored: they "
            "are baked into the protocol at build time — pass them to "
            "build_exchange(...) instead when supplying a prebuilt "
            "exchange")
    if opt.tree_update_ is None:
        raise ValueError("the optimiser has no tree form (tree_update_)")
    sketch_dim = exchange.sketch_dim
    elastic = bool(spec.elastic)
    kdt = DTYPES[spec.knowledge_dtype]
    mb = spec.minibatch
    shard = exchange.shard

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        step = int(state.step)
        params, opt_state, know = state.params, state.opt_state, state.know
        group_alive = know.alive if elastic else None
        if elastic and group_alive is None:
            raise ValueError(
                "GroupSpec.elastic=True but Knowledge.alive is None — "
                "init the state through init_train_state / "
                "init_knowledge(..., alive=...) so the mask exists")
        # the rank's own rows of the group's mask (all of it off a mesh)
        alive = (group_alive if shard is None or group_alive is None
                 else group_alive[shard.rows])
        grads = tree_map(torch.empty_like, params)
        if tensor is None:
            losses = value_and_grads(loss_fn, params, batch, grads)
            kw = {}
        else:
            from repro_torch.common.sharding import axis_rules, set_mesh
            with set_mesh(tensor.mesh), axis_rules(tensor.rules):
                losses = value_and_grads(loss_fn, params, batch, grads)
            tensor.all_reduce_data_(grads)
            kw = {"shards": tensor.shards}
        warmup = step < spec.threshold
        is_share = (not warmup) and step % mb == 0
        if warmup:
            opt.tree_update_(grads, opt_state, params, step, rows=alive,
                             **kw)
        else:
            _accumulate_(know, grads, training_experience(
                step, spec.t_weighting), kdt, alive)
            rnd = (step + mb - 1) // mb
            if sketch_dim > 0:
                # the projection is linear and every step of the window
                # ending at share step t folds the same round index, so
                # at share time sk is the sketch of rg
                contrib = exchange.sketch_step(grads, rnd, **kw)
                if elastic:
                    contrib = torch.where(alive[:, None], contrib,
                                          torch.zeros_like(contrib))
                know.sk.add_(contrib)
            if is_share:
                rel = exchange.observe(know.rel, grads=know.rg,
                                       sketch=know.sk, rnd=rnd,
                                       alive=group_alive, **kw)
                f32 = all(x.dtype == torch.float32 for x in _leaves(grads))
                with model_slices(None if tensor is None
                                  else tensor.shards):
                    gbar = exchange.combine(know, rel, step,
                                            alive=group_alive,
                                            out=grads if f32 else None)
                opt.tree_update_(gbar, opt_state, params, step, rows=alive,
                                 **kw)
                del gbar
                know = _reset_window_(know, rel)
        del grads
        if shard is not None:
            losses = shard.gather(losses)
        metrics = {"loss": losses, "step": step, "shared": int(is_share)}
        return TrainState(params=params, opt_state=opt_state, know=know,
                          step=step + 1), metrics

    return train_step
