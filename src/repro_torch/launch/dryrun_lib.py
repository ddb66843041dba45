"""Prefill and decode steps on a ``(data, model)`` mesh — the port of
``repro.launch.dryrun_lib``'s ``lower_prefill`` / ``lower_decode``,
which here RUN the step bodies on the calling rank instead of lowering
them.

The reference places the parameters by ``param_partition_specs(cfg,
serve_rules(mesh, B))`` and the batch and the decode cache by
``batch_partition_specs`` / ``cache_partition_specs``, then jits
``model.forward`` with a fresh cache (prefill) or ``model.decode`` under
``axis_rules`` and ``set_mesh``. :func:`prefill_on_mesh` and
:func:`decode_on_mesh` do the same with the rank's slices
(``repro_torch.launch.shardings.place``): every rank of the mesh calls
them together, the layers write their collectives
(``repro_torch.models.attention``'s KV-slot sweep, the vocab-parallel
head's gathered logits), and each returns the full logits of the rank's
rows and the rank's slice of the cache.

Not ported: the lowering itself, its cost analysis and the depth
extrapolation over two shallow unrolled variants (the reference's
``lower_train`` / ``_lower_for``, ``run_cell`` and the HLO parse). They
price an XLA program for simulated TPU devices; torch has no program to
lower.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.common.pytree import tree_leaves_with_paths
from repro_torch.common.sharding import axis_rules, set_mesh
from repro_torch.configs.base import ArchConfig, ShapeConfig
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
