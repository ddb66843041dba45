"""Reference state ↔ port state, for holding the port against the JAX
package on the same inputs and for checkpoints both packages read.

Every function takes the reference's structures with numpy leaves
(``jax.tree.map(np.asarray, x)`` on the reference side) and returns the
port's tensors; ``group_tree`` goes the other way, from a port
``GroupState`` to the reference's nest with numpy leaves (the
structure ``repro_torch.checkpoint.npz`` writes under the reference's
key paths), and ``group_state`` back. Parameter-shaped pytrees become
flat rows through a :class:`~repro_torch.common.pytree.PlaneLayout`, in
the reference's
leaf order, so both sides then compute the same thing. Int8 stores and
delay lines keep their int8 planes, and their per-leaf scale leaves
(…, ⌈size / q_block⌉) are laid side by side in leaf order into the
port's scale columns (``BlockLayout``). The model zoo's params keep
the reference's pytree as they are (``ssm_params``,
``transformer_params``, ``hybrid_params``), and Mamba2 decode states,
transformer KV caches and hybrid caches go both ways (``ssm_state``,
``ssm_state_to_numpy``, ``kv_cache``, ``kv_cache_to_numpy``,
``hybrid_cache``, ``hybrid_cache_to_numpy``). The streaming trainer's
``TrainState`` goes both ways too (``train_state``, ``train_tree``):
its trees of stacked leaves keep the reference's pytree as they are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import (PlaneLayout, tree_leaves_with_paths,
                                       tree_map)
from repro_torch.core.exchange.estimators import ObsStatsState
from repro_torch.core.knowledge import KnowledgeStore, SparseInFlight
from repro_torch.rl.a2c import A2CState
from repro_torch.rl.dqn import DQNState, Replay


def _t(x, device, dtype=None) -> torch.Tensor:
    # a copy: arrays taken from JAX are read-only, which torch refuses
    # to alias without a warning
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v, device) for v in tree)
    return _t(tree, device)


def flat_params(tree, lead: int = 1, layout: Optional[PlaneLayout] = None,
                device="cpu") -> Tuple[torch.Tensor, PlaneLayout]:
    """A parameter-shaped pytree whose leaves carry ``lead`` leading
    axes (agents, slots, ...) → ((*lead, P) fp32 rows, its layout)."""
    torch_tree = _tree_to_torch(tree, device)
    layout = layout or PlaneLayout.from_tree(torch_tree, lead=lead)
    return layout.flatten(torch_tree).to(torch.float32), layout


def _planes(grads, scale, layout: PlaneLayout, q_block: int, device):
    """(grads rows, scale columns, block layout) of a reference store or
    delay line: fp32 rows and no scales, or int8 rows and the per-leaf
    scale leaves concatenated in leaf order."""
    if scale is None:
        rows = flat_params(grads, layout=layout, device=device)[0]
        return rows, None, None
    if q_block <= 0:
        raise ValueError("an int8 store or delay line needs its q_block")
    blocks = layout.blocks(q_block)
    rows = layout.flatten(_tree_to_torch(grads, device))
    leaves = tree_leaves_with_paths(scale)
    if [path for path, _ in leaves] != list(layout.paths):
        raise ValueError("scale leaves do not match the layout")
    cols = []
    for (path, x), size in zip(leaves, layout.sizes):
        if np.shape(x)[-1] != -(-size // q_block):
            raise ValueError(
                f"scale leaf {path} has {np.shape(x)[-1]} blocks, "
                f"{size} elements at q_block {q_block} make "
                f"{-(-size // q_block)}")
        cols.append(_t(x, device, torch.float32))
    return rows, torch.cat(cols, dim=-1), blocks


def adamw_state(state, layout: PlaneLayout, device="cpu") -> dict:
    """The reference's AdamW state ``{"m", "v", "count"}`` stacked over
    agents → flat moments and an (n,) int32 step count."""
    return {"m": flat_params(state["m"], layout=layout, device=device)[0],
            "v": flat_params(state["v"], layout=layout, device=device)[0],
            "count": _t(state["count"], device, torch.int32)}


def a2c_state(state, layout: PlaneLayout, device="cpu") -> A2CState:
    """A reference ``A2CState`` stacked over agents (AdamW optimiser)."""
    return A2CState(
        params=flat_params(state.params, layout=layout, device=device)[0],
        opt_state=adamw_state(state.opt_state, layout, device),
        step=_t(state.step, device, torch.int32))


def replay(rep, device="cpu") -> Replay:
    """A reference replay ring stacked over agents (``Replay`` leaves
    (n, C, …), int32 actions, (n,) ``ptr`` and ``size``) → the port's,
    whose actions take its index dtype (int64)."""
    return Replay(
        obs=_t(rep.obs, device, torch.float32),
        actions=_t(rep.actions, device, torch.int64),
        rewards=_t(rep.rewards, device, torch.float32),
        next_obs=_t(rep.next_obs, device, torch.float32),
        dones=_t(rep.dones, device, torch.bool),
        ptr=_t(rep.ptr, device, torch.int32),
        size=_t(rep.size, device, torch.int32))


def dqn_state(state, layout: PlaneLayout, device="cpu") -> DQNState:
    """A reference ``DQNState`` stacked over agents (AdamW optimiser):
    params, target params, moments, the replay rings and the step and
    ε counters."""
    return DQNState(
        params=flat_params(state.params, layout=layout, device=device)[0],
        target_params=flat_params(state.target_params, layout=layout,
                                  device=device)[0],
        opt_state=adamw_state(state.opt_state, layout, device),
        replay=replay(state.replay, device),
        step=_t(state.step, device, torch.int32),
        eps_t=_t(state.eps_t, device, torch.int32))


def knowledge_store(store, layout: PlaneLayout, device="cpu",
                    q_block: int = 0) -> KnowledgeStore:
    """A reference ``KnowledgeStore`` stacked over agents (leaves
    (n, m, *param), and for an int8 store scale leaves (n, m, nb_leaf)
    built with ``q_block``) → flat (n, m, P) planes."""
    grads, scale, blocks = _planes(store.grads, store.scale, layout,
                                   q_block, device)
    born = getattr(store, "born", None)
    return KnowledgeStore(
        grads=grads,
        T=_t(store.T, device, torch.float32),
        R=_t(store.R, device, torch.float32),
        valid=_t(store.valid, device, torch.bool),
        ptr=_t(store.ptr, device, torch.int32),
        scale=scale, blocks=blocks,
        born=None if born is None else _t(born, device, torch.int32))


def sparse_inflight(flight, layout: PlaneLayout, device="cpu",
                    q_block: int = 0, leaves=None) -> SparseInFlight:
    """A reference ``SparseInFlight`` (leaves (n, k, D+2, *param), and
    for an int8 line scale leaves (n, k, D+2, nb_leaf)) → flat
    (n, k, D+2, P) planes, with its ``chk`` and ``born`` planes when it
    has them. A transport line needs ``leaves``, the rows'
    ``repro_torch.core.transport.LeafTable`` (by default the layout's)."""
    grads, scale, blocks = _planes(flight.grads, flight.scale, layout,
                                   q_block, device)
    chk, born = getattr(flight, "chk", None), getattr(flight, "born", None)
    if chk is not None and leaves is None:
        from repro_torch.core.transport import LeafTable
        leaves = LeafTable.of(layout.size, layout, blocks)
    return SparseInFlight(
        grads=grads,
        T=_t(flight.T, device, torch.float32),
        R=_t(flight.R, device, torch.float32),
        valid=_t(flight.valid, device, torch.bool),
        scale=scale, blocks=blocks,
        chk=None if chk is None else _t(chk, device, torch.float32),
        born=None if born is None else _t(born, device, torch.int32),
        leaves=None if chk is None else leaves)


def relevance(state, device="cpu"):
    """The reference's learned relevance state (``GroupState.relevance``):
    the gradient estimators' (n, n) matrix, or ``obs_stats``'s moments
    (``ObsStatsState``)."""
    if hasattr(state, "_fields"):
        return ObsStatsState(*(_t(x, device, torch.float32) for x in state))
    return _t(state, device, torch.float32)


# ---------------------------------------------------------------------
# a whole buffer-trainer GroupState, both ways
# ---------------------------------------------------------------------
def _np(x) -> np.ndarray:
    return x.detach().to("cpu").numpy()


def _rows_tree(flat: torch.Tensor, layout: PlaneLayout):
    leaves = tree_leaves_with_paths(layout.unflatten(flat))
    return layout.build([_np(x) for _, x in leaves])


def _scale_tree(scale: torch.Tensor, layout: PlaneLayout, blocks):
    cols = [scale[..., off:off + -(-size // blocks.q_block)]
            for off, size in zip(blocks.scale_offsets, blocks.sizes)]
    return layout.build([_np(c) for c in cols])


def _planes_tree(x, layout: PlaneLayout):
    """A port store or delay line → the reference's, numpy leaves."""
    kw = {name: _np(getattr(x, name))
          for name in ("T", "R", "valid", "ptr", "chk", "born")
          if getattr(x, name, None) is not None}
    kw["grads"] = _rows_tree(x.grads, layout)
    if x.scale is not None:
        kw["scale"] = _scale_tree(x.scale, layout, x.blocks)
    return type(x)(**kw)


def _agent_tree(state, layout: PlaneLayout):
    """A port ``A2CState`` / ``DQNState`` → the reference's, numpy
    leaves (replay actions as the reference's int32)."""
    kw = {}
    for name, v in zip(state._fields, state):
        if name in ("params", "target_params"):
            kw[name] = _rows_tree(v, layout)
        elif name == "opt_state":
            kw[name] = {k: (_rows_tree(x, layout) if k in ("m", "v")
                            else _np(x)) for k, x in v.items()}
        elif name == "replay":
            kw[name] = Replay(*(_np(x).astype(np.int32) if f == "actions"
                                else _np(x)
                                for f, x in zip(v._fields, v)))
        else:
            kw[name] = _np(v)
    return type(state)(**kw)


def group_tree(gs, layout: PlaneLayout):
    """A port ``GroupState`` → the reference's ``GroupState`` nest with
    numpy leaves (parameter-shaped rows split into the layout's leaves,
    int8 scale columns into per-leaf arrays), under the port's own
    NamedTuple types, whose field names are the reference's."""
    rel = gs.relevance
    return type(gs)(
        agent_states=_agent_tree(gs.agent_states, layout),
        stores=_planes_tree(gs.stores, layout),
        flight=_planes_tree(gs.flight, layout),
        epoch=np.asarray(gs.epoch, np.int32),
        relevance=(ObsStatsState(*(_np(x) for x in rel))
                   if hasattr(rel, "_fields") else _np(rel)),
        nbr=np.asarray(gs.nbr, np.int32),
        alive=None if gs.alive is None else np.asarray(gs.alive, bool))


def group_state(tree, layout: PlaneLayout, like):
    """The inverse of ``group_tree``: a reference-shaped ``GroupState``
    nest with numpy leaves → a port ``GroupState`` on the device of
    ``like``, a port state of the same trainer (its agent-state type,
    block and leaf tables)."""
    dev = like.stores.T.device
    blocks = like.stores.blocks
    q_block = 0 if blocks is None else blocks.q_block
    convert = {A2CState: a2c_state, DQNState: dqn_state}.get(
        type(like.agent_states))
    if convert is None:
        raise ValueError(f"no conversion for agent state "
                         f"{type(like.agent_states).__name__}")
    return type(like)(
        agent_states=convert(tree.agent_states, layout, dev),
        stores=knowledge_store(tree.stores, layout, dev, q_block),
        flight=sparse_inflight(tree.flight, layout, dev, q_block,
                               like.flight.leaves),
        epoch=int(tree.epoch),
        relevance=relevance(tree.relevance, dev),
        nbr=np.asarray(tree.nbr, np.int32),
        alive=(None if getattr(tree, "alive", None) is None
               else np.asarray(tree.alive, bool)))


# ---------------------------------------------------------------------
# the SSM model zoo (Mamba2): params and decode states
# ---------------------------------------------------------------------
SSM_STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def _array_to_tensor(x, device) -> torch.Tensor:
    """A numpy leaf → a tensor of the same dtype; bf16 arrays (numpy's
    ``ml_dtypes`` bfloat16, as JAX hands them out) go through fp32,
    which holds every bf16 value exactly."""
    if np.asarray(x).dtype.name == "bfloat16":
        return _t(np.asarray(x, np.float32), device).to(torch.bfloat16)
    return _t(x, device)


def _tensor_to_array(x: torch.Tensor) -> np.ndarray:
    """A tensor → a numpy array on the host; bf16 as fp32, which holds
    every bf16 value exactly."""
    x = x.detach().to("cpu")
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def ssm_params(params, device="cpu") -> dict:
    """The reference's SSM-model params (``repro.models.ssm_model``:
    numpy leaves, the layers' leaves stacked on axis 0) → the port's,
    which keep the same pytree and dtypes."""
    want = {"embed", "final_norm", "layers"}
    if not want <= set(params) or set(params["layers"]) != {"ln", "mamba"}:
        raise ValueError(f"not an SSM-model param tree: keys "
                         f"{sorted(params)}")
    return tree_map(lambda x: _array_to_tensor(x, device), params)


def ssm_state(state, device="cpu") -> dict:
    """A reference Mamba2 decode state (``make_mamba_state`` layout: conv
    tails and the SSM state, one leading layer axis or none) → the
    port's."""
    if set(state) != set(SSM_STATE_KEYS):
        raise ValueError(f"not a Mamba2 decode state: keys {sorted(state)}")
    return {k: _array_to_tensor(state[k], device) for k in SSM_STATE_KEYS}


def ssm_state_to_numpy(state) -> dict:
    """The port's Mamba2 decode state → numpy arrays (bf16 tails as
    fp32), for the reference's functions."""
    return {k: _tensor_to_array(state[k]) for k in SSM_STATE_KEYS}


# ---------------------------------------------------------------------
# the transformers (llama, qwen3-moe, deepseek, qwen2-vl, musicgen):
# params and KV caches
# ---------------------------------------------------------------------
KV_KEYS = ("k", "v", "pos")
MLA_KEYS = ("ckv", "k_rope", "pos")
XKV_KEYS = ("ck", "cv")
_LAYER_KEYS = ({"ln1", "ln2", "attn", "mlp"}, {"ln1", "ln2", "attn", "moe"},
               {"ln1", "ln2", "attn", "ln_x", "xattn", "mlp"})


def transformer_params(params, device="cpu") -> dict:
    """The reference's transformer params (``repro.models.transformer``:
    numpy leaves, the layers' leaves stacked on axis 0; dense SwiGLU,
    GELU (audio) or MoE feed-forwards, GQA or MLA attention,
    cross-attention with its ``ln_x`` (audio), the audio family's
    (C, V, E) embedding and (C, E, V) heads, and DeepSeek's unstacked
    ``layer0``) → the port's, which keep the same pytree and dtypes."""
    want = {"embed", "final_norm", "layers"}
    if (not want <= set(params)
            or set(params["layers"]) not in _LAYER_KEYS
            or ("layer0" in params
                and set(params["layer0"]) != _LAYER_KEYS[0])):
        raise ValueError(f"not a dense-transformer or MoE param tree: keys "
                         f"{sorted(params)}")
    return tree_map(lambda x: _array_to_tensor(x, device), params)


def _cache_keys(kv):
    for keys in (KV_KEYS, MLA_KEYS, XKV_KEYS):
        if set(kv) == set(keys):
            return keys
    return None


def _is_kv_cache(cache) -> bool:
    return (set(cache) in ({"layers"}, {"layers", "layer0"})
            and all(set(cache[k]) in ({"kv"}, {"kv", "xkv"})
                    and _cache_keys(cache[k]["kv"]) in (KV_KEYS, MLA_KEYS)
                    and set(cache[k].get("xkv", XKV_KEYS)) == set(XKV_KEYS)
                    for k in cache))


def kv_cache(cache, device="cpu") -> dict:
    """A reference transformer cache (``{"layers": {"kv": {"k", "v",
    "pos"}}}``, or MLA's ``{"ckv", "k_rope", "pos"}``, leaves (n_layers,
    batch, slots, ...), with the cross-attention's ``"xkv": {"ck",
    "cv"}`` (n_layers, batch, cond_len, H, D) where the model has it,
    and ``layer0``'s of depth 1 where there is one) → the port's."""
    if not _is_kv_cache(cache):
        raise ValueError(f"not a transformer KV cache: keys {sorted(cache)}")
    return {k: {name: _kv(part, device) for name, part in cache[k].items()}
            for k in cache}


def _kv(kv, device) -> dict:
    return {k: _array_to_tensor(kv[k], device) for k in _cache_keys(kv)}


def kv_cache_to_numpy(cache) -> dict:
    """The port's transformer cache → numpy arrays (bf16 as fp32), for
    the reference's functions."""
    return {k: {name: _kv_to_numpy(part) for name, part in cache[k].items()}
            for k in cache}


def _kv_to_numpy(kv) -> dict:
    return {k: _tensor_to_array(kv[k]) for k in _cache_keys(kv)}


# ---------------------------------------------------------------------
# the hybrid (zamba2): params and caches
# ---------------------------------------------------------------------
HYBRID_KEYS = {"embed", "final_norm", "lm_head", "shared", "mamba_blocks",
               "lora"}


def hybrid_params(params, device="cpu") -> dict:
    """The reference's hybrid params (``repro.models.hybrid``: numpy
    leaves, ``mamba_blocks`` stacked (nb, mpb, ...), ``lora`` (nb, ...),
    ``tail`` (tail, ...)) → the port's, which keep the same pytree and
    dtypes."""
    if not HYBRID_KEYS <= set(params) or set(params["shared"]) != {
            "ln1", "ln2", "attn", "mlp"}:
        raise ValueError(f"not a hybrid param tree: keys {sorted(params)}")
    return tree_map(lambda x: _array_to_tensor(x, device), params)


def hybrid_cache(cache, device="cpu") -> dict:
    """A reference hybrid cache (``{"mamba": (nb, mpb, B, ...), "kv":
    {"k", "v", "pos"} (nb, B, ...), "tail": (tail, B, ...)}``) → the
    port's."""
    if set(cache) != {"mamba", "kv", "tail"} \
            or set(cache["kv"]) != set(KV_KEYS):
        raise ValueError(f"not a hybrid cache: keys {sorted(cache)}")
    return {"mamba": ssm_state(cache["mamba"], device),
            "kv": _kv(cache["kv"], device),
            "tail": (None if cache["tail"] is None
                     else ssm_state(cache["tail"], device))}


def hybrid_cache_to_numpy(cache) -> dict:
    """The port's hybrid cache → numpy arrays (bf16 as fp32), for the
    reference's functions."""
    return {"mamba": ssm_state_to_numpy(cache["mamba"]),
            "kv": _kv_to_numpy(cache["kv"]),
            "tail": (None if cache["tail"] is None
                     else ssm_state_to_numpy(cache["tail"]))}


# ---------------------------------------------------------------------
# the streaming trainer's TrainState
# ---------------------------------------------------------------------
def _opt_tree(state, device):
    out = {}
    for k, v in state.items():
        out[k] = (tree_map(lambda x: _array_to_tensor(x, device), v)
                  if isinstance(v, dict) else _array_to_tensor(v, device))
    return out


def train_state(state, device="cpu"):
    """The reference's streaming ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) → the port's
    (``repro_torch.core.sharded_ddal.TrainState``): params, the
    optimiser's state, ``Knowledge`` with ``rel``, ``sk`` and ``alive``
    where present, and the step as a host int. Dtypes are kept (bf16
    arrays through fp32)."""
    from repro_torch.core.sharded_ddal import Knowledge, TrainState
    know = state.know

    def opt(x):
        return None if x is None else _array_to_tensor(x, device)
    return TrainState(
        params=tree_map(lambda x: _array_to_tensor(x, device), state.params),
        opt_state=_opt_tree(state.opt_state, device),
        know=Knowledge(
            tg=tree_map(lambda x: _array_to_tensor(x, device), know.tg),
            tsum=_array_to_tensor(know.tsum, device),
            rg=tree_map(lambda x: _array_to_tensor(x, device), know.rg),
            rsum=_array_to_tensor(know.rsum, device),
            rel=opt(getattr(know, "rel", None)),
            sk=opt(getattr(know, "sk", None)),
            alive=opt(getattr(know, "alive", None))),
        step=int(np.asarray(state.step)))


def train_tree(state):
    """The port's ``TrainState`` → the reference's structure with numpy
    leaves (bf16 as fp32, the step as an int32 scalar), under the port's
    NamedTuple types, whose field names are the reference's: what
    ``repro_torch.checkpoint.save_train`` writes."""
    from repro_torch.core.sharded_ddal import Knowledge

    def arr(x):
        return None if x is None else _tensor_to_array(x)
    know = state.know
    return type(state)(
        params=tree_map(arr, state.params),
        opt_state={k: (tree_map(arr, v) if isinstance(v, dict) else arr(v))
                   for k, v in state.opt_state.items()},
        know=Knowledge(tg=tree_map(arr, know.tg), tsum=arr(know.tsum),
                       rg=tree_map(arr, know.rg), rsum=arr(know.rsum),
                       rel=arr(know.rel), sk=arr(know.sk),
                       alive=arr(know.alive)),
        step=np.asarray(int(state.step), np.int32))
