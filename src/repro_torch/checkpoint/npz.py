"""Checkpointing: a nest flattened to keyed numpy arrays in one ``.npz``
— the port of ``repro.checkpoint.npz``.

Keys are the reference's ``jax.tree_util.keystr`` paths, written here
without JAX: ``.field`` for a NamedTuple field, ``['key']`` for a dict
key, ``[i]`` for a sequence index; ``None`` holds no leaf. So a file
written by either package restores in the other. ``save`` /
``restore`` / ``restore_step`` take any such nest of arrays;
``save_group`` / ``restore_group`` take the buffer trainer's
``GroupState``, whose flat parameter rows are split into the
reference's per-leaf arrays (and back) through the agents'
``PlaneLayout`` (``repro_torch.interop.group_tree`` /
``group_state``): agent states, stores, the delay line, elastic and
transport planes included; ``save_train`` / ``restore_train`` take the
streaming trainer's ``TrainState`` (params, optimiser state and the
knowledge window with its learned relevance, sketch and alive mask),
whose trees keep the reference's key paths as they are
(``repro_torch.interop.train_tree`` / ``train_state``). Writes are
atomic (a temporary file, then a rename).
"""
from __future__ import annotations

import os
import tempfile
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr, leaf) pairs in the reference's flatten order."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        out = []
        for name, sub in zip(tree._fields, tree):
            out += _paths(sub, f"{prefix}.{name}")
        return out
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _paths(tree[key], f"{prefix}[{key!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += _paths(sub, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _rebuild(tree, leaves: dict, prefix: str = ""):
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(sub, leaves, f"{prefix}.{name}")
                            for name, sub in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        if x.dtype == torch.bfloat16:
            # np.savez has no bf16: fp32 holds it exactly, and restore
            # casts back to the template's dtype
            x = x.to(torch.float32)
        return x.numpy()
    return np.asarray(x)


def save(path: str, tree: Any, step: Optional[int] = None) -> None:
    flat = {key: _array(leaf) for key, leaf in _paths(tree)}
    if step is not None:
        flat["__step__"] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore(path: str, template: Any, strict: bool = True) -> Any:
    """Refill ``template``'s leaves (numpy arrays) from ``path``, cast to
    the template's dtypes; shapes must match exactly. ``strict=False``
    keeps the template's value for leaves the file lacks (an ``alive``
    mask a pre-elastic checkpoint never saw). A damaged file raises one
    ``ValueError`` naming every fault: an unreadable or truncated
    archive, each missing leaf (strict), each unreadable entry and each
    shape mismatch with both shapes."""
    with open(path, "rb") as fh:
        try:
            data = np.load(fh)
        except (zipfile.BadZipFile, ValueError, OSError) as e:
            raise ValueError(
                f"checkpoint {path!r} is unreadable (truncated, or "
                f"not an .npz archive): {e}") from e
        problems, leaves = [], {}
        for key, leaf in _paths(template):
            leaf = np.asarray(leaf)
            if key not in data:
                if not strict:
                    leaves[key] = leaf
                else:
                    problems.append(
                        f"missing leaf {key!r} (template expects "
                        f"shape {tuple(leaf.shape)})")
                continue
            try:
                arr = data[key]
            except (zipfile.BadZipFile, ValueError, OSError) as e:
                problems.append(
                    f"unreadable leaf {key!r} (truncated entry: {e})")
                continue
            if tuple(arr.shape) != tuple(leaf.shape):
                problems.append(
                    f"shape mismatch at {key!r}: checkpoint "
                    f"{tuple(arr.shape)} vs template "
                    f"{tuple(leaf.shape)}")
                continue
            leaves[key] = arr.astype(leaf.dtype)
        if problems:
            raise ValueError(
                f"checkpoint {path!r} does not match the template "
                f"({len(problems)} problem"
                f"{'s' if len(problems) > 1 else ''}): "
                + "; ".join(problems))
        return _rebuild(template, leaves)


def restore_step(path: str) -> Optional[int]:
    with np.load(path) as data:
        return int(data["__step__"]) if "__step__" in data else None


def save_group(path: str, gs, layout, step: Optional[int] = None) -> None:
    """Save a buffer-trainer ``GroupState`` under the reference's keys;
    ``layout`` is the agents' ``PlaneLayout`` (``DDAL.layout``)."""
    from repro_torch import interop
    save(path, interop.group_tree(gs, layout), step)


def restore_group(path: str, like, layout, strict: bool = True):
    """A ``GroupState`` shaped like ``like`` (a state of the same
    trainer: its device, agent-state type, block and leaf tables),
    refilled from ``path`` — written by ``save_group`` or by the
    reference's ``save``."""
    from repro_torch import interop
    tree = restore(path, interop.group_tree(like, layout), strict)
    return interop.group_state(tree, layout, like)


def save_train(path: str, state, step: Optional[int] = None) -> None:
    """Save a streaming ``TrainState`` under the reference's keys (the
    reference's ``save(path, state)``)."""
    from repro_torch import interop
    save(path, interop.train_tree(state), step)


def restore_train(path: str, like, strict: bool = True):
    """A streaming ``TrainState`` shaped like ``like`` (its device and
    dtypes), refilled from ``path`` — written by ``save_train`` or by
    the reference's ``save``. ``strict=False`` keeps ``like``'s value
    for leaves the file lacks (an older file's missing ``alive``)."""
    from repro_torch import interop
    got = interop.train_state(restore(path, interop.train_tree(like),
                                      strict), "cpu")

    def put(x, ref):
        if isinstance(ref, dict):
            return {k: put(x[k], ref[k]) for k in ref}
        return None if ref is None else x.to(device=ref.device,
                                              dtype=ref.dtype)
    know = type(like.know)(*(put(getattr(got.know, f), getattr(like.know, f))
                             for f in like.know._fields))
    return type(like)(params=put(got.params, like.params),
                      opt_state=put(got.opt_state, like.opt_state),
                      know=know, step=got.step)
