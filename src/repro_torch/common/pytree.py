"""Flat parameter planes — the port's counterpart of
``repro.common.pytree``.

The reference keeps parameters and gradients as pytrees and maps every
helper leaf by leaf. The port stores each agent's whole parameter set
as one contiguous fp32 row, so a stack of agents is an (n, P) tensor
and the eq. 4 share step is one kernel launch over every agent's
store. A :class:`PlaneLayout` is the leaf table that maps between the
two: leaf paths, shapes and offsets, in ``jax.tree_util.tree_flatten``
order (dict keys sorted, lists in index order), so a test can flatten
a reference pytree and a port tree the same way.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Any, List, Sequence, Tuple

import torch

Path = Tuple[Any, ...]


def tree_leaves_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs of a nest of dicts / lists / tuples in
    ``jax.tree_util`` order: dict keys sorted, sequences by index."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_leaves_with_paths(tree[key], prefix + (key,))
        return out
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = []
        for i, sub in enumerate(tree):
            out += tree_leaves_with_paths(sub, prefix + (i,))
        return out
    return [(prefix, tree)]


#: columns of an (n, p) leaf view that the streaming trainer's
#: elementwise passes take at a time: a multiple of every int8 block
#: (each divides 8192), so a chunk holds whole blocks, and small enough
#: that a pass's temporaries stay near n · 64 MiB whatever the leaf
COLUMN_CHUNK = 1 << 24


def column_chunks(p: int, width: int = COLUMN_CHUNK):
    """Slices covering 0 .. p − 1, ``width`` columns at a time."""
    return [slice(c, min(p, c + width)) for c in range(0, p, width)]


def tree_from_paths(pairs) -> dict:
    """A nest of dicts from (path, leaf) pairs: the inverse of
    :func:`tree_leaves_with_paths` for dict trees."""
    out: dict = {}
    for path, value in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def tree_map(fn, tree, *rest):
    """``fn`` leaf by leaf over matching nests of dicts (the model
    zoo's parameter and cache trees): ``fn(leaf, *matching_leaves)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def layer(tree, i: int):
    """Layer ``i``'s slice of a pytree stacked on axis 0 (views)."""
    return tree_map(lambda t: t[i], tree)


def unstack_layers(tree, n: int):
    """The ``n`` per-layer trees of a tree stacked on axis 0, as views
    (``torch.unbind`` of every leaf once). The views equal
    :func:`layer`'s; under autograd the gradients of all layers meet in
    one stack per leaf, where a ``select`` per layer would each
    scatter into a zero tensor of the whole stacked leaf."""
    parts = tree_map(lambda t: torch.unbind(t, 0), tree)
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


_held = threading.local()


@contextlib.contextmanager
def agent_rows(rows):
    """Within the scope, every per-slot row pick (:func:`pick_rows`,
    :func:`slot_layer`) reads planes that hold only the calling rank's
    block of a group's agents on a ``(pod, "agent")`` mesh spanning the
    process group: ``rows.first .. rows.first + rows.block − 1``
    (``repro_torch.launch.shardings.AgentPlanes``); ``None``: every
    agent's."""
    prev = getattr(_held, "rows", None)
    _held.rows = rows
    try:
        yield
    finally:
        _held.rows = prev


def pick_rows(t: torch.Tensor, agents: torch.Tensor, pick=None):
    """Each slot's rows of an agents' stacked (A, ...) tensor for the (B,)
    long index ``agents``: ``pick(t, agents)``, by default
    ``t.index_select(0, agents)`` (B, ...). Under :func:`agent_rows` the
    rank holds only its agents' rows: it picks the slots whose agents it
    holds, zeros for the others, and one all-reduce (sum) over the mesh
    gives every rank every slot's rows (one nonzero term each, so the
    sum is exact) over the process group, counted as
    ``"plane_rows"``."""
    pick = pick or (lambda x, a: x.index_select(0, a))
    rows = getattr(_held, "rows", None)
    if rows is None:
        return pick(t, agents)
    import torch.distributed as dist

    from repro_torch.common.sharding import count
    local = agents - rows.first
    own = (local >= 0) & (local < rows.block)
    out = pick(t, torch.where(own, local, torch.zeros_like(local)))
    out = torch.where(own.view((-1,) + (1,) * (out.ndim - 1)), out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    count("plane_rows")
    dist.all_reduce(out)
    return out


def slot_layer(tree, agents: torch.Tensor, *index: int):
    """Layer ``index`` of each row's agent from agents' stacked trees
    (leaves (A, n_layers, ...), or (A, d1, d2, ...) with one index per
    depth axis, or (A, ...) with none) → leaves (B, ...) for the (B,)
    long index ``agents``: a gather, B copies of one layer
    (:func:`pick_rows`: on a pod mesh one collective a leaf)."""
    def pick(t):
        for i in index:
            t = t.select(1, i)
        return pick_rows(t, agents)
    return tree_map(pick, tree)


def stack_layers(trees):
    """The inverse of :func:`layer`: per-layer pytrees → one pytree
    stacked on axis 0."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


_slice = threading.local()


@contextlib.contextmanager
def slicing(cut):
    """Within the scope a model's ``init`` hands every tree it draws to
    ``cut(path, tree, lead)`` before keeping it: ``path`` is the tree's
    place in the parameter tree, ``lead`` the stacking dims the drawn
    tree lacks (``()`` for a tree drawn whole: :func:`sliced`; a layer's
    for :func:`init_stacked`). ``cut`` returns the part the calling rank
    keeps (``repro_torch.core.sharded_ddal.init_train_state`` draws a
    rank's slice of a state this way). ``None``: keep everything."""
    prev = getattr(_slice, "cut", None)
    _slice.cut = cut
    try:
        yield
    finally:
        _slice.cut = prev


def sliced(path: Path, tree, lead: Tuple[int, ...] = ()):
    """``tree``, drawn whole at ``path`` of the parameter tree, as the
    active :func:`slicing` keeps it (as it is outside one)."""
    cut = getattr(_slice, "cut", None)
    return tree if cut is None else cut(tuple(path), tree, tuple(lead))


def init_stacked(n_layers, draw, path: Path = ()):
    """``draw()`` called once per layer, each layer's tree copied into
    its slot of leaves stacked on axis 0 as soon as it is drawn, so a
    model's weights are never held twice (the reference draws them all
    at once under ``vmap``). ``n_layers`` is a count, or a tuple of
    counts for nested stacks (leaves (d1, d2, ...)), filled in
    row-major order. On ``meta`` one layer is drawn, for its shapes.
    Under :func:`slicing` each drawn layer is cut (``path``: the
    stack's place in the parameter tree) before it is copied into a
    stack of the cut's shape."""
    lead = (n_layers,) if isinstance(n_layers, int) else tuple(n_layers)
    first = sliced(path, draw(), lead)
    stacked = tree_map(lambda t: t.new_empty(lead + tuple(t.shape)), first)
    if all(t.is_meta for _, t in tree_leaves_with_paths(first)):
        return stacked              # shapes only: no values to copy
    src = first
    del first
    for n, idx in enumerate(itertools.product(*map(range, lead))):
        if n:
            src = sliced(path, draw(), lead)
        tree_map(lambda dst, x: dst[idx].copy_(x), stacked, src)
        src = None                  # one drawn layer alive at a time
    return stacked


def _build(skeleton, leaves_by_path: dict, prefix: Path = ()):
    if isinstance(skeleton, dict):
        return {k: _build(skeleton[k], leaves_by_path, prefix + (k,))
                for k in skeleton}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(
            _build(s, leaves_by_path, prefix + (i,))
            for i, s in enumerate(skeleton))
    return leaves_by_path[prefix]


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_skeleton(v) for v in tree)
    return None


class PlaneLayout:
    """Leaf table of one agent's parameter tree over a flat row.

    ``paths[i]`` names leaf i, ``shapes[i]`` its per-agent shape and
    ``offsets[i]`` where it starts in the row; ``size`` is P, the row
    length. Leaves are laid out back to back with no padding.
    """

    def __init__(self, skeleton, paths: Sequence[Path],
                 shapes: Sequence[Tuple[int, ...]]):
        self.skeleton = skeleton
        self.paths = tuple(paths)
        self.shapes = tuple(tuple(s) for s in shapes)
        sizes = [math.prod(s) for s in self.shapes]
        self.offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
        self.sizes = tuple(sizes)
        self.size = sum(sizes)

    @classmethod
    def from_tree(cls, tree, lead: int = 0) -> "PlaneLayout":
        """Layout of ``tree``, whose leaves carry ``lead`` leading
        (agent / slot) axes that are not part of the parameter."""
        pairs = tree_leaves_with_paths(tree)
        return cls(_skeleton(tree), [p for p, _ in pairs],
                   [tuple(x.shape[lead:]) for _, x in pairs])

    def flatten(self, tree) -> torch.Tensor:
        """Concatenate a tree of this layout into flat rows. Each leaf
        may carry the same leading axes (agents, ring slots, delay
        planes); the result is (*lead, P)."""
        pairs = tree_leaves_with_paths(tree)
        if [p for p, _ in pairs] != list(self.paths):
            raise ValueError(
                f"tree leaves {[p for p, _ in pairs]} do not match the "
                f"layout {list(self.paths)}")
        parts = []
        for (path, x), shape in zip(pairs, self.shapes):
            x = torch.as_tensor(x)
            lead = x.ndim - len(shape)
            if lead < 0 or tuple(x.shape[lead:]) != shape:
                raise ValueError(
                    f"leaf {path} has shape {tuple(x.shape)}, expected "
                    f"(..., {', '.join(map(str, shape))})")
            parts.append(x.reshape(x.shape[:lead] + (-1,)))
        return torch.cat(parts, dim=-1)

    def build(self, leaves: Sequence[Any]):
        """The tree of this layout's skeleton holding ``leaves``, one per
        leaf in layout order (any array type, any leading axes)."""
        if len(leaves) != len(self.paths):
            raise ValueError(f"{len(leaves)} leaves for a layout of "
                             f"{len(self.paths)}")
        return _build(self.skeleton, dict(zip(self.paths, leaves)))

    def blocks(self, q_block: int) -> "BlockLayout":
        """The int8 block layout of a row of this layout: ``q_block``
        consecutive elements of each leaf share one fp32 scale, and
        the blocks restart at every leaf, as the reference's
        ``quantize_tree`` blocks each leaf on its own."""
        return BlockLayout(self.offsets, self.sizes, q_block)

    def unflatten(self, flat: torch.Tensor):
        """The tree of views into ``flat`` (*lead, P): each leaf is
        (*lead, *shape) and shares storage with the row, so gradients
        through the views land in the flat tensor."""
        if flat.shape[-1] != self.size:
            raise ValueError(
                f"flat rows have {flat.shape[-1]} elements, layout "
                f"needs {self.size}")
        leaves = {}
        for path, off, size, shape in zip(self.paths, self.offsets,
                                          self.sizes, self.shapes):
            seg = flat[..., off:off + size]
            leaves[path] = seg.unflatten(-1, shape) if shape else seg[..., 0]
        return _build(self.skeleton, leaves)


class BlockLayout:
    """Where the int8 scale of every element of a flat row lives.

    Leaf i of the row (elements ``offsets[i]`` to ``offsets[i] +
    sizes[i]``) is cut into ⌈size / q_block⌉ blocks whose scales are
    the columns from ``scale_offsets[i]`` on; ``n_blocks`` is the
    number of scale columns of a row (76 for the paper's A2C at
    ``q_block=128``). A leaf's last block may be short, so the scale
    column of element p is ``scale_offsets[leaf] + (p - offsets[leaf])
    // q_block``, not ``p // q_block``.

    The maps behind that, as index arrays: ``columns`` (P,) — each
    element's scale column; ``padded`` (n_blocks · q_block,) — the row
    element in each slot of the zero-padded block grid, ``P`` for a
    pad slot; ``unpadded`` (P,) — each element's slot in that grid.
    """

    def __init__(self, offsets: Sequence[int], sizes: Sequence[int],
                 q_block: int):
        if q_block <= 0:
            raise ValueError(f"q_block must be > 0, got {q_block}")
        self.q_block = int(q_block)
        self.offsets = tuple(offsets)
        self.sizes = tuple(sizes)
        self.size = sum(self.sizes)
        nbs = [-(-s // self.q_block) for s in self.sizes]
        self.scale_offsets = tuple(sum(nbs[:i]) for i in range(len(nbs)))
        self.n_blocks = sum(nbs)
        cols, padded, unpadded = [], [], []
        for off, size, nb, soff in zip(self.offsets, self.sizes, nbs,
                                       self.scale_offsets):
            local = torch.arange(size, dtype=torch.int64)
            cols.append(soff + local // self.q_block)
            unpadded.append(soff * self.q_block + local)
            slot = torch.full((nb * self.q_block,), self.size,
                              dtype=torch.int64)
            slot[:size] = off + local
            padded.append(slot)
        cat = (lambda xs: torch.cat(xs) if xs
               else torch.zeros((0,), dtype=torch.int64))
        self.columns = cat(cols).to(torch.int32)
        self.padded = cat(padded)
        self.unpadded = cat(unpadded)
        self._on: dict = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(columns, padded, unpadded) on ``device``, copied there once
        so that a share step or a send uploads nothing."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = tuple(x.to(device) for x in (
                self.columns, self.padded, self.unpadded))
        return self._on[key]


def global_norm_clip(grads: torch.Tensor, max_norm: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global-norm clipping of every agent row on its own; returns
    (clipped, norm). The reference clips per agent because its
    optimizer update is vmapped over agents, so the norm is taken over
    the last axis, never over the whole (n, P) stack."""
    norm = torch.sqrt(torch.sum(grads * grads, dim=-1))
    # a true division: Python's ``float / tensor`` is evaluated as
    # reciprocal-then-multiply, one rounding more than the reference
    limit = torch.as_tensor(max_norm, dtype=norm.dtype, device=norm.device)
    scale = torch.clamp_max(limit / (norm + 1e-6), 1.0)
    return grads * scale.unsqueeze(-1), norm


def tree_select(pred: torch.Tensor, a, b):
    """Leafwise ``where(pred, a, b)`` over matching nests of tensors,
    dicts, lists and NamedTuples; ``pred`` (n,) broadcasts over each
    leaf's trailing axes."""
    if isinstance(a, torch.Tensor):
        p = pred.reshape(pred.shape + (1,) * (a.ndim - pred.ndim))
        return torch.where(p, a, b)
    if isinstance(a, dict):
        return {k: tree_select(pred, a[k], b[k]) for k in a}
    if hasattr(a, "_fields"):
        return type(a)(*(tree_select(pred, x, y) for x, y in zip(a, b)))
    if isinstance(a, (list, tuple)):
        return type(a)(tree_select(pred, x, y) for x, y in zip(a, b))
    raise TypeError(f"tree_select: unsupported node {type(a).__name__}")
