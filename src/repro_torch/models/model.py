"""Public model API — the port of ``repro.models.model`` for every
family of the zoo (SSM, dense, MoE, hybrid, VLM and audio; the dense,
MoE, VLM and audio families share one transformer):

    model = get_model(cfg)
    params = model.init(cfg, generator, device)
    loss = model.loss(cfg, params, batch)                      # scoring
    logits, cache = model.forward(cfg, params, batch, cache)   # prefill
    logits, cache = model.decode(cfg, params, batch, cache)
    logits, cache = model.decode(cfg, planes, batch, cache, agents)

Every family has its loss, a cache-free pass that the streaming
trainer differentiates: every such pass runs the CUDA kernels (flash
attention, the SSD intra-chunk form), and one that autograd records
takes each kernel's gradient from its plain version
(``repro_torch.kernels.plain_vjp``; ``ArchConfig`` docstring).
``kv_pos`` is None for a model without a KV cache (the SSM family),
else the cache → its slots' positions (…, B, slots): the serving
engines check a fit against those slots.

The shape helpers are the reference's, with ``meta`` tensors in place
of ``jax.ShapeDtypeStruct`` (nothing is allocated): ``input_specs``
(the batch of a ``ShapeConfig``), ``cache_specs`` (the decode cache),
``param_specs`` (the parameter tree) and ``param_logical_axes`` (a tree
of logical axis-name tuples matching the parameters, which
``repro_torch.launch.shardings`` maps through a rule table).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.common.pytree import tree_from_paths, tree_leaves_with_paths
from repro_torch.configs.base import (TRANSFORMER_FAMILIES, ArchConfig,
                                      ShapeConfig)
from repro_torch.models import hybrid as hy
from repro_torch.models import ssm_model as ssm
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class Model:
    init: Callable               # (cfg, generator, device)
    loss: Callable
    forward: Callable            # full-seq: (cfg, params, batch, cache)
    decode: Callable             # (cfg, params, batch, cache[, agents])
    make_cache: Callable         # (cfg, batch_size, max_len, device)
    kv_pos: Optional[Callable] = None    # cache -> (..., B, slots)


def _tf_prefill(cfg, params, batch, cache):
    logits, _, new_cache = tf.transformer_forward(cfg, params, batch,
                                                  cache=cache)
    return logits, new_cache


def _ssm_prefill(cfg, params, batch, cache):
    logits, _, new_cache = ssm.ssm_forward(cfg, params, batch, cache=cache)
    return logits, new_cache


def _hy_prefill(cfg, params, batch, cache):
    logits, _, new_cache = hy.hybrid_forward(cfg, params, batch, cache=cache)
    return logits, new_cache


_FAMILIES: Dict[str, Model] = {
    "transformer": Model(
        init=tf.init_transformer,
        loss=tf.transformer_loss,
        forward=_tf_prefill,
        decode=tf.transformer_decode,
        make_cache=tf.make_transformer_cache,
        kv_pos=lambda cache: cache["layers"]["kv"]["pos"],
    ),
    "ssm": Model(
        init=ssm.init_ssm_model,
        loss=ssm.ssm_loss,
        forward=_ssm_prefill,
        decode=ssm.ssm_decode,
        make_cache=ssm.make_ssm_cache,
    ),
    "hybrid": Model(
        init=hy.init_hybrid,
        loss=hy.hybrid_loss,
        forward=_hy_prefill,
        decode=hy.hybrid_decode,
        make_cache=hy.make_hybrid_cache,
        kv_pos=hy.kv_pos,
    ),
}


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family in TRANSFORMER_FAMILIES:
        return _FAMILIES["transformer"]
    return _FAMILIES[cfg.family]


# ----------------------------------------------------------------------
# input specs (shape contracts; meta tensors, nothing allocated)
# ----------------------------------------------------------------------
def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta tensors of the batch of ``shape.kind``: train and prefill
    carry the whole sequence (labels for train), decode ONE new token
    (the cache comes from ``cache_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cdt = cfg.dtype("compute")
    E = cfg.d_model
    if shape.kind in ("train", "prefill"):
        specs = {"positions": _sds((B, S), i32)}
        if cfg.family == "audio":
            specs["tokens"] = _sds((B, cfg.n_codebooks, S), i32)
            specs["cond"] = _sds((B, cfg.cond_len, E), cdt)
            if shape.kind == "train":
                specs["labels"] = _sds((B, cfg.n_codebooks, S), i32)
        elif cfg.family == "vlm":
            vp = cfg.vision_prefix
            specs["tokens"] = _sds((B, S - vp), i32)
            specs["vision"] = _sds((B, vp, E), cdt)
            specs["positions"] = _sds((B, 3, S), i32)
            if shape.kind == "train":
                specs["labels"] = _sds((B, S), i32)
        else:
            specs["tokens"] = _sds((B, S), i32)
            if shape.kind == "train":
                specs["labels"] = _sds((B, S), i32)
        return specs
    if cfg.family == "audio":
        return {"tokens": _sds((B, cfg.n_codebooks, 1), i32),
                "positions": _sds((B, 1), i32)}
    if cfg.family == "vlm":
        return {"tokens": _sds((B, 1), i32),
                "positions": _sds((B, 3, 1), i32)}
    return {"tokens": _sds((B, 1), i32), "positions": _sds((B, 1), i32)}


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> Any:
    """The decode cache of ``shape`` on ``meta``, at its global shapes
    whatever mesh is installed."""
    from repro_torch.common.describe import describing
    from repro_torch.common.sharding import set_mesh
    with set_mesh(None), describing():
        return get_model(cfg).make_cache(cfg, shape.global_batch,
                                         shape.seq_len, device="meta")


def param_specs(cfg: ArchConfig) -> Any:
    """The parameter tree on ``meta`` (no allocation)."""
    from repro_torch.common.describe import describing
    with describing():
        return get_model(cfg).init(cfg, None, "meta")


# ----------------------------------------------------------------------
# parameter sharding rules (logical axes; see repro_torch.common.sharding)
# ----------------------------------------------------------------------
_COLUMN = {"wq", "wk", "wv", "w_gate", "w_up", "w1", "w_uk", "w_uv",
           "w_z", "w_x"}
_ROW = {"wo", "w_down", "w2", "out_proj"}
_COLUMN_BIAS = {"bq", "bk", "bv", "b1"}
_VEC_SHARDED = {"norm_w", "conv_x"}


def _leaf_axes(cfg: ArchConfig, path, ndim: int) -> tuple:
    """The reference's rule for one leaf, by its last two path names."""
    names = [str(p) for p in path]
    last = names[-1]
    parent = names[-2] if len(names) > 1 else ""

    def spec(*tail):
        return tuple([None] * (ndim - len(tail)) + list(tail))

    if parent == "experts":
        # (Ne, E, F) / (Ne, F, E): expert-parallel on axis -3
        return tuple([None] * (ndim - 3) + ["experts", None, None])
    if last == "embed":
        return spec("vocab", None)
    if last == "lm_head":
        return spec(None, "vocab")
    if last in _COLUMN:
        return spec(None, "ff")
    if last in _ROW:
        return spec("ff", None)
    if last in _COLUMN_BIAS:
        return spec("ff")
    if last == "norm_w":
        return spec("ssm_inner")
    if parent == "conv_x" and last == "w":
        return spec(None, "ssm_inner")
    if parent == "conv_x" and last == "b":
        return spec("ssm_inner")
    if parent in ("a", "b") or last in ("a", "b"):
        # LoRA factors: small, replicated
        return spec(None, None) if ndim >= 2 else spec(None)
    return tuple([None] * ndim)


def param_logical_axes(cfg: ArchConfig, params_shape) -> Any:
    """A tree (matching ``params_shape``) of logical axis-name tuples,
    one entry per dim of each leaf."""
    return tree_from_paths((path, _leaf_axes(cfg, path, leaf.ndim))
                           for path, leaf in tree_leaves_with_paths(
                               params_shape))
