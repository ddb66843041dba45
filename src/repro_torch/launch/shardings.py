"""Partition specs and placement — the port of ``repro.launch.shardings``
(and of ``_sanitize``, ``repro.launch.dryrun_lib``).

The model axis. A spec is a tuple with one entry per dim: a mesh axis
name, a tuple of names or ``None``. ``param_partition_specs``,
``batch_partition_specs``, ``group_plane_partition_specs``,
``cache_partition_specs`` and ``train_state_partition_specs`` give the
reference's specs entry for entry (``param_logical_axes`` through a
rule table; batches over the data axes; caches by name and rank).
``_sanitize`` replicates a dim that does not divide over its axes, as
the reference's jit inputs do. Torch has no GSPMD to reshard inside the
program, so the placement (``placement_spec``) adds one rule of its
own: a leaf made of heads is split only in whole heads
(``whole_heads``), else that dim is placed replicated and the layer
picks the heads it needs. An attention projection (``wq`` / ``bq`` and
MLA's ``w_uk`` / ``w_uv`` need the query heads, ``wk`` / ``wv`` /
``bk`` / ``bv`` the kv heads, to divide over the axis); the
cross-attention's projections, ``wo``'s rows and its ``ck`` / ``cv``
cache by its heads; Mamba2's ``ssm_inner`` leaves (``w_z``, ``w_x``,
``conv_x``, ``norm_w``, ``out_proj``'s rows and the cache's ``conv_x``
/ ``ssm``) by its SSD heads d_inner / head_dim. ``place`` cuts a rank's local slice of full tensors by
specs; ``gather`` puts full tensors back (a collective: every rank calls
it). Both handle a decode cache's slot dim (``common.sharding.
slot_range``): a split dim is cut into contiguous blocks, and a dim that
stays whole lies on model rank 0, the other ranks' copies empty.
``local_cache_shapes`` gives the shapes a rank's cache is built at
(``models.transformer.make_transformer_cache``). ``leaf_shards``
describes each parameter leaf's slice on the calling rank for the
partial sums over the model axis
(``repro_torch.common.sharding.ModelShards``).

Group serving on a ``(pod, "agent")`` mesh: ``AgentPlanes`` places a
group's stacked planes by ``group_plane_partition_specs``, each rank
keeping its agents' rows.

The reference shards dim 0 of every per-agent leaf of a ``TrainState``
over ``ddal_agent_axis(mesh)``. Here that becomes: each rank keeps its
contiguous, pod-major block of the agents (``sharded_ddal.AgentShard``)
of every leaf with a leading agent axis — the parameters, the AdamW
moments and step counts, the window's ``tg`` / ``rg`` / ``tsum`` /
``rsum`` and sketch ``sk`` — while ``rel``, ``alive`` and ``step`` stay
global (every rank holds the group's). ``gather_agent_state`` is the
inverse, for checkpoints and tests. A ``(data, model)`` mesh shards no
agent axis: there ``train_state_partition_specs`` gives each leaf's
spec over the model axis alone; on a ``(pod, data, model)`` mesh dim 0
lies over ``pod`` beside the model axis. ``state_placement_specs`` is
what a state on either is placed by (``rel`` kept global), and
``init_cut`` cuts an agent's drawn trees to a rank's slices as
``place`` would (the sliced init, ``sharded_ddal.init_train_state(...,
mesh=)``). Every placement function takes a ``DeviceMesh`` or a
``common.sharding.MeshPoint``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

from repro_torch.common.pytree import (tree_from_paths,
                                       tree_leaves_with_paths, tree_map)
from repro_torch.common.sharding import axis_names, axis_size

Axis = Union[None, str, tuple]


def ddal_agent_axis(mesh, pod_axis: str = "pod") -> Axis:
    """The mesh axes the agent dim lies over: both levels of the pod mesh
    (agents pod-major), ``pod_axis`` alone on a one-level mesh, else
    ``None``."""
    names = axis_names(mesh) if mesh is not None else ()
    if pod_axis in names and "agent" in names:
        return (pod_axis, "agent")
    if pod_axis in names:
        return pod_axis
    return None


def _map_agent_leaves(state, fn):
    """``fn`` over every per-agent leaf of a streaming ``TrainState``
    (params, optimiser state, the window's tg / tsum / rg / rsum / sk);
    ``rel``, ``alive`` and ``step`` as they are."""
    know = state.know
    return state._replace(
        params=tree_map(fn, state.params),
        opt_state=tree_map(fn, state.opt_state),
        know=know._replace(
            tg=tree_map(fn, know.tg), rg=tree_map(fn, know.rg),
            tsum=fn(know.tsum), rsum=fn(know.rsum),
            sk=None if know.sk is None else fn(know.sk)))


def _pod_mesh_only(mesh, pod_axis: str) -> None:
    from repro_torch.core.sharded_ddal import mesh_kind
    if mesh_kind(mesh, pod_axis) == "pod_model":
        raise ValueError(
            "a (pod, data, model) mesh cuts the agents and the model "
            "axis together: place the state with place(state, "
            "state_placement_specs(...), mesh, cfg) and put it back with "
            "gather(...)")


def agent_sharded_state(state, mesh, pod_axis: str = "pod"):
    """The calling rank's part of a group's ``TrainState`` on ``mesh``:
    its block of rows of every per-agent leaf (each a tensor of its
    own), the global ``rel``, ``alive`` and step. ``mesh=None`` returns
    ``state``; the ``(pod, data, model)`` mesh raises (``place``)."""
    if ddal_agent_axis(mesh, pod_axis) is None:
        return state
    _pod_mesh_only(mesh, pod_axis)
    from repro_torch.core.sharded_ddal import agent_shard
    n = state.know.tsum.shape[0]
    rows = agent_shard(mesh, n, pod_axis).rows
    return _map_agent_leaves(state, lambda x: x[rows].clone())


def gather_agent_state(state, mesh, pod_axis: str = "pod"):
    """The inverse of ``agent_sharded_state``: every rank's rows gathered
    into the group's ``TrainState`` on every rank (a collective: all
    ranks call it)."""
    if ddal_agent_axis(mesh, pod_axis) is None:
        return state
    _pod_mesh_only(mesh, pod_axis)
    from repro_torch.core.sharded_ddal import agent_shard
    n = state.know.tsum.shape[0] * mesh.size()
    shard = agent_shard(mesh, n, pod_axis)
    return _map_agent_leaves(state, shard.gather)


# ---------------------------------------------------------------------
# the model axis: partition specs (the reference's, entry for entry)
# ---------------------------------------------------------------------
def _dict_leaves(tree, prefix=()):
    """(path, leaf) of a nest of dicts whose leaves are anything (spec
    tuples included), keys sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _dict_leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def param_partition_specs(cfg, rules: dict, lead: Tuple[Axis, ...] = ()):
    """Physical specs for the parameter tree; ``lead`` prefixes extra
    axes (the DDAL agent axis)."""
    from repro_torch.models.model import param_logical_axes, param_specs
    logical = param_logical_axes(cfg, param_specs(cfg))
    return tree_from_paths(
        (path, tuple(lead) + tuple(rules.get(n) if n is not None else None
                                   for n in tup))
        for path, tup in _dict_leaves(logical))


def batch_partition_specs(cfg, shape, batch_axes: Axis,
                          lead: Tuple[Axis, ...] = ()) -> dict:
    """Specs for the input batch dict: dim 0 (after ``lead``) is the
    batch dim of every leaf."""
    from repro_torch.models.model import input_specs
    return {k: tuple(lead) + (batch_axes,) + (None,) * (v.ndim - 1)
            for k, v in input_specs(cfg, shape).items()}


def group_plane_partition_specs(cfg, mesh, pod_axis: str = "pod"):
    """Specs of the group serving engine's stacked per-agent planes: dim
    0 (the agent axis) over ``ddal_agent_axis``, the rest replicated."""
    from repro_torch.models.model import param_specs
    axis = ddal_agent_axis(mesh, pod_axis)
    return tree_map(lambda _: (axis,), param_specs(cfg))


# key: {rank: {dim: logical}}. KV caches shard batch + SLOTS
# (flash-decoding sweep; head dims often don't divide the mesh)
_CACHE_RULES = {
    "k":      {5: {1: "B", 2: "slots"}, },
    "v":      {5: {1: "B", 2: "slots"}, },
    "ck":     {5: {1: "B", 3: "model"}, },
    "cv":     {5: {1: "B", 3: "model"}, },
    "pos":    {3: {1: "B", 2: "slots"}},
    "ckv":    {4: {1: "B", 2: "slots"}},
    "k_rope": {4: {1: "B", 2: "slots"}},
    "conv_x": {4: {1: "B", 3: "model"}, 5: {2: "B", 4: "model"}},
    "conv_B": {4: {1: "B"}, 5: {2: "B"}},
    "conv_C": {4: {1: "B"}, 5: {2: "B"}},
    "ssm":    {5: {1: "B", 2: "model"}, 6: {2: "B", 3: "model"}},
}


def cache_partition_specs(cfg, shape, batch_axes: Axis,
                          model_axis: Axis = "model",
                          slots_axis: Axis = "model"):
    """Specs matching ``repro_torch.models.model.cache_specs(cfg,
    shape)``, by each leaf's last string key and rank."""
    from repro_torch.models.model import cache_specs

    def rule(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), None)
        dims = _CACHE_RULES.get(name, {}).get(leaf.ndim, {})
        axes = []
        for d in range(leaf.ndim):
            a = dims.get(d)
            axes.append(batch_axes if a == "B" else model_axis
                        if a == "model" else slots_axis if a == "slots"
                        else None)
        return tuple(axes)

    return tree_from_paths(
        (path, rule(path, leaf))
        for path, leaf in tree_leaves_with_paths(cache_specs(cfg, shape)))


def train_state_partition_specs(cfg, rules: dict, agent_axis: Axis,
                                learn_relevance: bool = False,
                                sketch_dim: int = 0):
    """Specs for a streaming ``TrainState`` with AdamW (m / v mirror the
    parameters, count and the window scalars are per agent); the learned
    (A, A) relevance and the (A, d) sketch are row-sharded like the other
    per-agent leaves when the estimator carries them; ``alive`` and the
    step are replicated (``None`` / ``()``)."""
    from repro_torch.core.sharded_ddal import Knowledge, TrainState
    pspec = param_partition_specs(cfg, rules, lead=(agent_axis,))
    vec = (agent_axis,)
    rel = (agent_axis, None) if learn_relevance else None
    sk = (agent_axis, None) if (learn_relevance and sketch_dim > 0) else None
    return TrainState(
        params=pspec,
        opt_state={"m": pspec, "v": pspec, "count": vec},
        know=Knowledge(tg=pspec, tsum=vec, rg=pspec, rsum=vec, rel=rel,
                       sk=sk),
        step=())


def state_placement_specs(cfg, mesh, learn_relevance: bool = False,
                          sketch_dim: int = 0, pod_axis: str = "pod"):
    """The specs a streaming ``TrainState`` is placed by on a ``(data,
    model)`` or a ``(pod_axis, "data", "model")`` mesh:
    ``train_state_partition_specs(cfg, train_rules(mesh), agent axis,
    ...)`` — the agent dim over ``pod_axis`` on the three-axis mesh, over
    nothing on the other — with the learned ``rel`` global (``None``:
    every rank holds the group's (A, A), as on the pod mesh), while the
    window sketch ``sk`` keeps its rows over the agent axis. ``alive``
    and the step are global too."""
    from repro_torch.launch.mesh import train_rules
    rules = train_rules(mesh, pod_axis)
    specs = train_state_partition_specs(cfg, rules, rules["agent"],
                                        learn_relevance, sketch_dim)
    return specs._replace(know=specs.know._replace(rel=None))


def _sanitize(mesh, spec: tuple, shape) -> tuple:
    """Drop every spec entry whose mesh-axis product does not divide its
    dim (e.g. kv_heads 8 over model 16, vocab 49155 over 16): that dim is
    placed replicated."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(axes if axes and dim % axis_size(mesh, axes) == 0 else None
                 for dim, axes in zip(shape, entries))


# ---------------------------------------------------------------------
# the model axis: placement
# ---------------------------------------------------------------------
_HEAD_LEAVES = {"wq": "q", "bq": "q", "wk": "kv", "bk": "kv", "wv": "kv",
                "bv": "kv", "w_uk": "q", "w_uv": "q"}
_XATTN_LEAVES = {"wq": -1, "wk": -1, "wv": -1, "wo": -2}
# Mamba2's d_inner leaves (its SSD heads' channels): the dim, from the
# end, that lies over the model axis
_SSM_LEAVES = {"w_z": -1, "w_x": -1, "norm_w": -1, "out_proj": -2}


def whole_heads(cfg, path) -> Optional[Tuple[int, int]]:
    """(heads, dim counted from the end) of a leaf whose model-axis dim
    splits only in whole heads, else ``None``: an attention projection
    (query heads for ``wq`` / ``bq`` and MLA's ``w_uk`` / ``w_uv``, kv
    heads for ``wk`` / ``wv`` / ``bk`` / ``bv``), the cross-attention's
    ``wq`` / ``wk`` / ``wv`` and ``wo``'s rows (its heads), the
    cross-attention cache's ``ck`` / ``cv``, and Mamba2's ``ssm_inner``
    leaves, whose channels are the SSD heads' (``w_z``, ``w_x``,
    ``conv_x``'s ``w`` / ``b``, ``norm_w``, ``out_proj``'s rows; the
    cache's ``conv_x`` and ``ssm``)."""
    if cfg is None or not path:
        return None
    last = path[-1]
    parent = path[-2] if len(path) > 1 else None
    if last in _HEAD_LEAVES and parent in ("attn", None):
        kind = _HEAD_LEAVES[last]
        return (cfg.n_heads if kind == "q" else cfg.n_kv_heads), -1
    if parent == "xattn" and last in _XATTN_LEAVES:
        return cfg.n_heads, _XATTN_LEAVES[last]
    if last in ("ck", "cv"):
        return cfg.n_heads, -2
    if getattr(cfg, "ssm", None) is None:
        return None
    heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    if parent == "mamba" and last in _SSM_LEAVES:
        return heads, _SSM_LEAVES[last]
    if parent == "conv_x" or last == "conv_x":
        return heads, -1
    if last == "ssm":
        return heads, -3
    return None


def placement_spec(cfg, mesh, path, spec: tuple, shape) -> tuple:
    """The spec a leaf is placed by: ``_sanitize``'s, with the dim of a
    leaf that splits in whole heads (:func:`whole_heads`) replicated
    unless its heads divide over the dim's axes: an explicit shard
    cannot split a head."""
    out = _sanitize(mesh, spec, shape)
    rule = whole_heads(cfg, path)
    if rule is None:
        return out
    heads, d = rule
    d += len(out)
    axes = out[d]
    if axes is not None and heads % axis_size(mesh, axes):
        out = out[:d] + (None,) + out[d + 1:]
    return out


def _coord(mesh, axes) -> Tuple[int, int]:
    """(the calling rank's index along ``axes``, their size): row-major
    over a tuple of names."""
    if isinstance(axes, str):
        axes = (axes,)
    index, size = 0, 1
    names = axis_names(mesh)
    for a in axes:
        n = mesh.size(names.index(a))
        index = index * n + mesh.get_local_rank(a)
        size *= n
    return index, size


def local_slices(mesh, spec: tuple, shape) -> tuple:
    """The calling rank's slice of every dim of a full ``shape`` under a
    (placement) ``spec``."""
    out = []
    for dim, axes in zip(shape, list(spec) + [None] * (len(shape)
                                                      - len(spec))):
        if axes is None:
            out.append(slice(0, dim))
            continue
        index, size = _coord(mesh, axes)
        if dim % size:
            raise ValueError(f"dim {dim} does not split over {axes!r} "
                             f"({size} devices)")
        blk = dim // size
        out.append(slice(index * blk, (index + 1) * blk))
    return tuple(out)


def _rebuild(tree, fn, specs, path=()):
    if hasattr(tree, "_fields"):
        return type(tree)(*(
            None if x is None else _rebuild(x, fn, s, path + (name,))
            for name, x, s in zip(tree._fields, tree, specs)))
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, specs[k], path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, specs)


def _leaf_spec(cfg, mesh, path, x, spec):
    """The placement spec of one leaf (``None``: as it is); a spec names
    dims from the left, a ``TrainState``'s per-agent leaves with their
    lead."""
    import torch
    if spec is None or not isinstance(x, torch.Tensor) or x.ndim == 0:
        return None
    key_path = tuple(k for k in path if isinstance(k, str))
    return placement_spec(cfg, mesh, key_path, tuple(spec), tuple(x.shape))


def _whole_slots(mesh, path, x, spec, ps) -> Optional[Axis]:
    """The slot axis of a decode-cache leaf (named by ``_CACHE_RULES``)
    whose slot dim ``spec`` puts over more than one rank and the
    placement ``ps`` keeps whole (it does not divide), else ``None``:
    such a cache's slots lie on the axis's rank 0."""
    name = next((k for k in reversed(path) if isinstance(k, str)), None)
    for d, kind in _CACHE_RULES.get(name, {}).get(x.ndim, {}).items():
        if (kind == "slots" and spec[d] is not None and ps[d] is None
                and axis_size(mesh, spec[d]) > 1):
            return spec[d]
    return None


def _empty_like(x):
    """An empty cache leaf like ``x``: zeros, positions −1."""
    import torch
    return torch.full_like(x, 0 if x.dtype.is_floating_point else -1)


def place(tree, specs, mesh, cfg=None):
    """The calling rank's local slice of every leaf of ``tree`` (full
    tensors) under ``specs`` (a matching tree of spec tuples; ``cfg``
    adds the whole-heads rule): each slice a contiguous tensor of its
    own. A leaf whose slice is all of it (no spec, or axes of one rank)
    is kept as it is, not copied. A cache leaf whose slot dim stays
    whole on a slot axis of several ranks is kept by the axis's rank 0;
    the other ranks take an empty copy (``common.sharding.slot_range``)."""
    def cut(path, x, spec):
        ps = _leaf_spec(cfg, mesh, path, x, spec)
        if ps is None:
            return x
        whole = _whole_slots(mesh, path, x, tuple(spec), ps)
        if whole is not None and _coord(mesh, whole)[0] != 0:
            x = _empty_like(x)
        sl = local_slices(mesh, ps, tuple(x.shape))
        if all(s.stop - s.start == n for s, n in zip(sl, x.shape)):
            return x                 # the whole leaf (axes of one rank)
        return x[sl].clone()
    return _rebuild(tree, cut, specs)


def full_shapes(tree):
    """``tree`` with every tensor replaced by a ``meta`` tensor of its
    shape and dtype (nothing allocated): the shapes ``gather`` needs."""
    import torch

    def meta(path, x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return _rebuild(tree, meta, _none_like(tree))


def _none_like(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_none_like(x) for x in tree))
    if isinstance(tree, dict):
        return {k: _none_like(v) for k, v in tree.items()}
    return None


def gather(tree, specs, mesh, like, cfg=None):
    """The inverse of ``place``: every rank's slices gathered into the
    full tensors on every rank (``all_gather`` over each split dim's
    axes; a leaf that is whole on the rank is returned as it is, a cache
    leaf whose slot dim stays whole is the slot axis's rank 0's,
    broadcast). ``like`` (``full_shapes`` of the full tree) gives the
    shapes the placement was resolved against."""
    import torch
    import torch.distributed as dist

    def full(path, x, spec):
        if spec is None or not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        shape = tuple(_at(like, path).shape)
        key_path = tuple(k for k in path if isinstance(k, str))
        ps = placement_spec(cfg, mesh, key_path, tuple(spec), shape)
        out = x
        whole = _whole_slots(mesh, path, x, tuple(spec), ps)
        if whole is not None:
            # a whole slot dim lies on the axis's rank 0
            for a in ((whole,) if isinstance(whole, str) else whole):
                group = mesh.get_group(a)
                out = out.contiguous().clone()
                dist.broadcast(out, dist.get_global_rank(group, 0),
                               group=group)
        for d, axes in enumerate(ps):
            if axes is None:
                continue
            names = (axes,) if isinstance(axes, str) else tuple(axes)
            for a in reversed(names):
                group = mesh.get_group(a)
                n = mesh.size(axis_names(mesh).index(a))
                if n == 1:
                    continue
                parts = [torch.empty_like(out) for _ in range(n)]
                dist.all_gather(parts, out.contiguous(), group=group)
                out = torch.cat(parts, dim=d)
        return out
    return _rebuild(tree, full, specs)


def _at(tree, path):
    for k in path:
        if tree is None:
            return None
        tree = getattr(tree, k) if hasattr(tree, "_fields") else tree[k]
    return tree


def init_cut(cfg, mesh, keep: bool = True):
    """The ``common.pytree.slicing`` cut of one agent's parameter draws
    for the calling rank of ``mesh`` (a ``DeviceMesh`` or a
    ``common.sharding.MeshPoint``): each drawn tree's leaves cut by
    ``placement_spec`` of ``param_partition_specs(cfg, train_rules(
    mesh))`` (whole heads included), as ``place`` cuts the full leaf. A
    layer's cut (``lead`` stacking dims) is a view, copied into its
    stack at once; a tree drawn whole is cut into tensors of its own,
    so the whole is freed. ``keep=False`` (an agent of another rank)
    keeps nothing: every leaf becomes an empty tensor."""
    import torch

    from repro_torch.launch.mesh import train_rules
    from repro_torch.models.model import param_specs
    specs = param_partition_specs(cfg, train_rules(mesh))
    full = param_specs(cfg)

    def one(path, x, lead):
        if not keep:
            return x.new_empty((0,))
        shape = tuple(_at(full, path).shape)
        if tuple(x.shape) != shape[len(lead):]:
            raise ValueError(f"leaf {'/'.join(map(str, path))}: drawn "
                             f"{tuple(x.shape)}, the model's {shape}")
        ps = placement_spec(cfg, mesh, path, _at(specs, path), shape)
        sl = local_slices(mesh, ps, shape)
        if any(a is not None for a in ps[:len(lead)]):
            raise ValueError(f"leaf {'/'.join(map(str, path))}: a "
                             f"stacking dim is split ({ps})")
        sl = sl[len(lead):]
        if all(c.stop - c.start == n for c, n in zip(sl, x.shape)):
            return x
        return x[sl] if lead else x[sl].clone()

    def walk(path, tree, lead):
        if isinstance(tree, torch.Tensor):
            return one(path, tree, lead)
        return {k: walk(path + (k,), v, lead) for k, v in tree.items()}

    def cut(path, tree, lead):
        return walk(tuple(path), tree, tuple(lead))
    return cut


def leaf_shards(cfg, mesh, rules: Optional[dict] = None):
    """Each parameter leaf's slice on the calling rank, in leaf order, as
    ``repro_torch.common.sharding.LeafShard`` s: its full shape, the dim
    that is split over the model axis (``None``: replicated) and the
    rank's start and length along it."""
    from repro_torch.common.sharding import LeafShard
    from repro_torch.launch.mesh import train_rules
    from repro_torch.models.model import param_specs
    rules = rules if rules is not None else train_rules(mesh)
    specs = param_partition_specs(cfg, rules)
    out = []
    for path, x in tree_leaves_with_paths(param_specs(cfg)):
        spec = _at(specs, path)
        ps = placement_spec(cfg, mesh, path, spec, tuple(x.shape))
        split = [d for d, a in enumerate(ps) if a is not None]
        if len(split) > 1:
            raise ValueError(f"leaf {'/'.join(map(str, path))}: more than "
                             f"one split dim {ps}")
        if not split:
            out.append(LeafShard(tuple(x.shape), None, 0, 0))
            continue
        d = split[0]
        sl = local_slices(mesh, ps, tuple(x.shape))[d]
        out.append(LeafShard(tuple(x.shape), d, sl.start, sl.stop - sl.start))
    return out


def _on_mesh(mesh, spec: tuple) -> tuple:
    """``spec`` with every entry naming an axis the mesh lacks dropped."""
    names = axis_names(mesh)

    def keep(axes):
        if axes is None:
            return None
        parts = (axes,) if isinstance(axes, str) else tuple(axes)
        return axes if all(a in names for a in parts) else None
    return tuple(keep(a) for a in spec)


def local_cache_shapes(cfg, batch: int, max_len: int):
    """(the decode cache of a global ``batch`` and ``max_len`` on
    ``meta``, each leaf's shape on the calling rank) under the installed
    rules and mesh: ``cache_partition_specs`` with the rules' batch and
    ``"kv_slots"`` axes, placed as ``place`` places it. ``None`` without
    rules or a mesh."""
    from repro_torch.common.sharding import get_mesh, get_rules, set_mesh
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import cache_specs
    rules, mesh = get_rules(), get_mesh()
    if not rules or mesh is None:
        return None
    shape = ShapeConfig("cache", max_len, batch, "decode")
    with set_mesh(None):
        full = cache_specs(cfg, shape)
        specs = cache_partition_specs(cfg, shape, rules.get("batch"),
                                      slots_axis=rules.get("kv_slots"))

    def local(path, x, spec):
        key_path = tuple(k for k in path if isinstance(k, str))
        ps = placement_spec(cfg, mesh, key_path, _on_mesh(mesh, tuple(spec)),
                            tuple(x.shape))
        return tuple(sl.stop - sl.start
                     for sl in local_slices(mesh, ps, tuple(x.shape)))
    return full, _rebuild(full, local, specs)


def local_cache(cfg, batch: int, max_len: int, device=None):
    """The calling rank's slice of an empty decode cache of a global
    ``batch`` and ``max_len`` under the installed rules and mesh, each
    leaf at its ``local_cache_shapes`` shape on ``device`` (``None``: the
    card): zeros, positions −1. ``None`` without rules or a mesh (the
    family then builds its one-device cache)."""
    import torch

    from repro_torch.common.device import resolve_device
    local = local_cache_shapes(cfg, batch, max_len)
    if local is None:
        return None
    dev = resolve_device(device)
    return tree_map(lambda t, shape: torch.full(
        shape, 0 if t.dtype.is_floating_point else -1, dtype=t.dtype,
        device=dev), local[0], local[1])


class AgentPlanes(NamedTuple):
    """The placer of a group's stacked serving planes on a ``(pod,
    "agent")`` mesh, by ``group_plane_partition_specs``: dim 0 over the
    agent axes, so the calling rank keeps the rows of its block of the
    ``n_agents`` agents (``sharded_ddal.AgentShard``: pod-major, the
    trainer's placement). Planes of ``n_agents`` rows are cut to the
    rank's block (views); planes already of the block's rows (an
    agent-sharded trainer's ``state.params``) are taken as they are, so
    a publish from such a trainer is a handoff: no plane crosses
    ranks."""
    n_agents: int
    first: int
    block: int

    @classmethod
    def on(cls, mesh, n_agents: int, pod_axis: str = "pod"):
        from repro_torch.core.sharded_ddal import agent_shard
        shard = agent_shard(mesh, n_agents, pod_axis)
        return cls(n_agents, shard.rows.start, shard.block)

    def __call__(self, planes):
        def rows(x):
            if x.shape[0] == self.block:
                return x
            if x.shape[0] == self.n_agents:
                return x[self.first:self.first + self.block]
            raise ValueError(
                f"a plane of {x.shape[0]} agents: expected the group's "
                f"{self.n_agents} or the rank's block of {self.block}")
        return tree_map(rows, planes)
