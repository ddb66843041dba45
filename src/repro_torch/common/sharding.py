"""Logical-axis sharding helpers — the port of ``repro.common.sharding``.

Model code names tensor axes *logically* ("batch", "heads", "ff",
"vocab", "experts", ...). A rule table, installed by the caller with
``axis_rules`` (the launcher's ``train_rules`` / ``serve_rules``, or
none at all on one device), maps the names to the axes of a device mesh
installed with ``set_mesh``. A spec is a plain tuple of axis names,
``None`` or tuples of names: the port has no ``PartitionSpec``.

Torch has no GSPMD, so ``shard`` is the identity on values: the layers
hold explicit local shards of their weights and write the collectives
themselves (``repro_torch.models.common``: a copy into the model region,
an all-reduce out of it), where GSPMD would insert them. ``shard`` keeps
the reference's call sites readable. ``mesh_axis`` tells a layer which
process group, size and rank a logical name resolves to under the
installed rules and mesh; with no rules or no mesh it returns ``None``
and the layer runs its one-device form.

``COLLECTIVES`` counts the collectives the layers issue in their
forward, by site (``"attn_out"``, ``"mlp_out"``, ``"moe_combine"``,
``"embed"``, ``"ce_max"``, ``"kv_max"``, ``"kv_sum"``, ``"ssm_norm"``,
``"ssm_out"``, ``"xattn_out"``, ...), so a run can show where they
went.

Decode caches under ``serve_rules`` split their slot dim over the
``"kv_slots"`` axis (the reference's flash-decoding layout):
``slot_range`` gives the global slots a rank holds.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import NamedTuple, Optional, Tuple

_state = threading.local()

# Default logical→physical rules for the ("data", "model") mesh (the
# "pod" axis only ever shards the leading agent axis)
DEFAULT_RULES = {
    "batch": "data",
    "agent": "pod",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv_fused": "model",
    "ff": "model",
    "experts": "model",
    "ssm_inner": "model",
    "embed": None,
    "seq": None,
}

#: forward collectives issued by the layers, by site
COLLECTIVES: collections.Counter = collections.Counter()


def get_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[dict]):
    """Install logical→physical sharding rules for the enclosed scope."""
    prev = get_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def logical_spec(*names: Optional[str]) -> tuple:
    """Resolve logical axis names to a spec tuple under the current rules
    (``()`` with no rules, as the reference's ``P()``)."""
    rules = get_rules()
    if rules is None:
        return ()
    return tuple(rules.get(n) if n is not None else None for n in names)


def shard(x, *names: Optional[str]):
    """The reference's sharding constraint: the identity here (the
    layers own their collectives)."""
    del names
    return x


def get_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Install ``mesh`` (a ``DeviceMesh``) as the ambient mesh for the
    enclosed scope."""
    prev = get_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


class AxisGroup(NamedTuple):
    """A mesh axis as a layer uses it: its process group, its size and
    the calling rank's coordinate along it."""
    name: str
    group: object
    size: int
    rank: int


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` or a
    plain description's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", ())
    return tuple(names or ())


def axis_size(mesh, axes) -> int:
    """The number of devices along ``axes`` (a name, a tuple of names or
    ``None``) of ``mesh``: a ``DeviceMesh`` or anything with a ``shape``
    dict, as the reference's ``mesh.shape[name]``."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        shape = getattr(mesh, "shape", None)
        if isinstance(shape, dict):
            n *= int(shape[a])
        else:
            n *= mesh.size(axis_names(mesh).index(a))
    return n


def mesh_axis(logical: str) -> Optional[AxisGroup]:
    """The mesh axis the installed rules map ``logical`` to, as an
    ``AxisGroup`` of the installed mesh; ``None`` when no rules or no
    mesh are installed, or the rule maps the name nowhere."""
    rules, mesh = get_rules(), get_mesh()
    if not rules or mesh is None:
        return None
    axis = rules.get(logical)
    if axis is None or not isinstance(axis, str):
        return None
    names = axis_names(mesh)
    if axis not in names:
        return None
    return AxisGroup(axis, mesh.get_group(axis),
                     mesh.size(names.index(axis)),
                     mesh.get_local_rank(axis))


def count(site: str) -> None:
    COLLECTIVES[site] += 1


def slot_range(T: int, ax: Optional[AxisGroup]) -> Tuple[int, int]:
    """The global slots [start, stop) of a ``T``-slot cache dim that the
    calling rank holds on the slot axis ``ax``: the contiguous
    [r·T/m, (r+1)·T/m) where m divides T. A dim that does not divide
    keeps its whole shape on every rank (the placement's ``_sanitize``)
    and its slots lie on model rank 0: (0, T) there, (T, T) on the
    others, whose copies stay empty. ``ax`` None: (0, T)."""
    if ax is None:
        return 0, T
    if T % ax.size == 0:
        n = T // ax.size
        return ax.rank * n, (ax.rank + 1) * n
    return (0, T) if ax.rank == 0 else (T, T)


class LeafShard(NamedTuple):
    """One parameter leaf's slice on a rank: the full shape (no agent
    axis), the dim split over the model axis (``None``: the leaf is
    replicated) and the rank's start and length along it."""
    shape: tuple
    dim: Optional[int]
    start: int
    length: int

    def position_map(self) -> tuple:
        """(row stride, column offset, local width) of the rank's slice
        in the leaf's flat positions: local element q sits at position
        (q // width) · stride + c0 + q % width of the full leaf. A
        replicated leaf (or a split of the leading dim) is one
        contiguous range."""
        size = 1
        for n in self.shape:
            size *= n
        if self.dim is None:
            return size, 0, size
        inner = 1
        for n in self.shape[self.dim + 1:]:
            inner *= n
        stride = inner * self.shape[self.dim]
        return stride, self.start * inner, self.length * inner


class ModelShards:
    """The parameter leaves of a rank on the model axis (``leaves``, in
    leaf order) and the axis itself (``axis``, an ``AxisGroup``). A sum
    over every parameter position (a squared norm, a dot product, a
    sketch) is taken as partial sums: each rank adds its own slices of
    the split leaves and, of a replicated leaf, only model rank 0 adds
    it; ``all_reduce`` then sums the partials over the model axis."""

    def __init__(self, leaves, axis: AxisGroup):
        self.leaves = list(leaves)
        self.axis = axis
        self.owned = [leaf.dim is not None or axis.rank == 0
                      for leaf in self.leaves]

    def all_reduce(self, t):
        """``t`` summed over the model axis, in place."""
        import torch.distributed as dist
        dist.all_reduce(t, group=self.axis.group)
        return t


class MeshPoint(NamedTuple):
    """A plain description of a device mesh seen from one rank: its axis
    names, their sizes and the rank's coordinate. It answers what the
    placement reads of a ``DeviceMesh`` (``size``, ``get_local_rank``,
    ``shape`` by name), so a rank's slices can be computed, drawn and
    tested without a process group."""
    axis_names: tuple
    sizes: tuple
    coord: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def size(self, dim: Optional[int] = None) -> int:
        if dim is not None:
            return int(self.sizes[dim])
        n = 1
        for s in self.sizes:
            n *= int(s)
        return n

    def get_local_rank(self, name: str) -> int:
        return int(self.coord[self.axis_names.index(name)])

    def points(self):
        """Every coordinate of the mesh, row-major, as ``MeshPoint`` s."""
        import itertools
        return [self._replace(coord=c) for c in
                itertools.product(*(range(int(n)) for n in self.sizes))]

