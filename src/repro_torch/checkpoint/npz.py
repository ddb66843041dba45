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

On a production mesh no rank holds a whole leaf: ``restore_sliced``
reads a rank's slices of a whole file a block at a time, and
``save_sliced`` / ``save_train_sliced`` gather each leaf to rank 0's
host a block at a time into the same ordinary file.
"""
from __future__ import annotations

import itertools
import os
import tempfile
import zipfile
from typing import Any, List, NamedTuple, Optional, Tuple

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


# ---------------------------------------------------------------------
# a rank's slices: the sliced restore and the save gathered to rank 0
# ---------------------------------------------------------------------
#: bytes a sliced restore reads, and a sliced save gathers to rank 0, at
#: a time: below one (agent, layer) block of the largest leaf of every
#: published config (qwen3-moe-30b-a3b's experts: 805 MB in fp32)
READ_BYTES = 1 << 26


def _walk(tree, specs, prefix: str = "", names: tuple = ()):
    """(keystr, leaf, spec, names) of a ``TrainState``-like nest beside
    its spec tree (``launch.shardings`` specs: a tuple per leaf, ``None``
    for a global leaf), in ``_paths``' order; ``names`` are the field
    and key names down to the leaf (what ``placement_spec`` reads)."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        out = []
        for name, sub in zip(tree._fields, tree):
            s = None if specs is None else getattr(specs, name)
            out += _walk(sub, s, f"{prefix}.{name}", names + (name,))
        return out
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            s = None if specs is None else specs[key]
            out += _walk(tree[key], s, f"{prefix}[{key!r}]", names + (key,))
        return out
    return [(prefix, tree, specs, names)]


def _placement(cfg, mesh, names, spec, shape) -> tuple:
    """The leaf's placement spec (``launch.shardings.placement_spec``;
    every dim whole for a global leaf)."""
    from repro_torch.launch.shardings import placement_spec
    if spec is None or not shape:
        return (None,) * len(shape)
    return placement_spec(cfg, mesh, names, tuple(spec), tuple(shape))


def _block_dim(shape, itemsize: int, cap: int) -> int:
    """The first dim j whose trailing block (dims j ..) holds at most
    ``cap`` bytes: a leaf is read and gathered one index of dims < j at
    a time."""
    for j in range(len(shape) + 1):
        if int(np.prod(shape[j:], dtype=np.int64)) * itemsize <= cap:
            return j
    return len(shape)


class _Member(NamedTuple):
    shape: tuple
    dtype: np.dtype
    offset: int           # of the data in the file


def _npy_header(fh):
    """(shape, fortran order, dtype) of the ``.npy`` data at ``fh``."""
    version = np.lib.format.read_magic(fh)
    if version == (1, 0):
        return np.lib.format.read_array_header_1_0(fh)
    return np.lib.format.read_array_header_2_0(fh)


def _member(raw, info) -> _Member:
    """The ``.npy`` header of a stored archive member and where its data
    starts in the file."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError("a compressed member (np.savez_compressed); the "
                         "sliced restore reads stored ones (np.savez)")
    raw.seek(info.header_offset)
    local = raw.read(30)
    if len(local) < 30 or local[:4] != b"PK\x03\x04":
        raise ValueError("bad local header")
    n, m = int.from_bytes(local[26:28], "little"), int.from_bytes(
        local[28:30], "little")
    raw.seek(info.header_offset + 30 + n + m)
    shape, fortran, dtype = _npy_header(raw)
    if fortran:
        raise ValueError("Fortran-ordered array")
    return _Member(tuple(shape), dtype, raw.tell())


def _read_slice_(raw, member: _Member, sl: tuple, dst, cap: int):
    """The box ``sl`` of a member copied into ``dst`` (a tensor of the
    box's shape), read ``cap`` bytes at a time: one index of the dims
    before ``_block_dim`` a read, the box's rows of the next dim."""
    shape, dt = member.shape, member.dtype
    if not shape:
        raw.seek(member.offset)
        arr = np.frombuffer(raw.read(dt.itemsize), dt).reshape(())
        dst.copy_(torch.from_numpy(arr.copy()).to(dst.dtype))
        return
    j = min(_block_dim(shape, dt.itemsize, cap), len(shape) - 1)
    inner = int(np.prod(shape[j + 1:], dtype=np.int64))
    strides = [int(np.prod(shape[d + 1:], dtype=np.int64))
               for d in range(len(shape))]
    rows = sl[j]
    for t in itertools.product(*(range(s.start, s.stop) for s in sl[:j])):
        first = sum(i * strides[d] for d, i in enumerate(t))
        start = first + rows.start * strides[j]
        count = (rows.stop - rows.start) * inner
        raw.seek(member.offset + start * dt.itemsize)
        buf = bytearray(count * dt.itemsize)      # writable for torch
        if raw.readinto(buf) != len(buf):
            raise ValueError("truncated entry")
        arr = np.frombuffer(buf, dt).reshape(
            (rows.stop - rows.start,) + tuple(shape[j + 1:]))
        arr = arr[(slice(None),) + tuple(sl[j + 1:])]
        at = tuple(i - s.start for i, s in zip(t, sl[:j]))
        dst[at].copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(
            dst.dtype))


def restore_sliced(path: str, like, specs, mesh, cfg=None,
                   strict: bool = True, read_bytes: int = READ_BYTES):
    """The calling rank's slices of a checkpoint written whole
    (``save_train`` / ``save`` of either package, or ``save_sliced``):
    every tensor of ``like`` (the rank's state, e.g. from
    ``init_train_state(..., mesh=)``) is refilled in place with its
    slice of the file's leaf, cut by ``specs`` (``launch.shardings.
    state_placement_specs``) on ``mesh`` (a ``DeviceMesh`` or a
    ``common.sharding.MeshPoint``) as ``launch.shardings.place`` cuts
    it; ``like`` is returned with the file's step. The file is read a
    leaf at a time and ``read_bytes`` at a time (``np.savez`` stores
    members uncompressed, so a member's rows lie at their offsets after
    its ``.npy`` header), so no leaf is ever held whole in host memory.
    ``strict`` and the faults are ``restore``'s: one ``ValueError``
    names every fault before anything is read."""
    from repro_torch.launch.shardings import local_slices
    try:
        zf = zipfile.ZipFile(path)
    except (zipfile.BadZipFile, ValueError, OSError) as e:
        raise ValueError(
            f"checkpoint {path!r} is unreadable (truncated, or "
            f"not an .npz archive): {e}") from e
    with zf, open(path, "rb") as raw:
        size = os.fstat(raw.fileno()).st_size
        problems, plan = [], []
        for key, leaf, spec, names in _walk(like, specs):
            info = zf.NameToInfo.get(key + ".npy")
            want = (tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
                    else ())
            if info is None:
                if strict:
                    problems.append(f"missing leaf {key!r} (template "
                                    f"expects shape {want})")
                continue
            try:
                member = _member(raw, info)
            except (ValueError, OSError, EOFError) as e:
                problems.append(f"unreadable leaf {key!r} ({e})")
                continue
            nbytes = int(np.prod(member.shape, dtype=np.int64)
                         ) * member.dtype.itemsize
            if member.offset + nbytes > size:
                problems.append(f"unreadable leaf {key!r} (truncated "
                                f"entry: {size - member.offset} of "
                                f"{nbytes} bytes)")
                continue
            try:
                ps = _placement(cfg, mesh, names, spec, member.shape)
                sl = local_slices(mesh, ps, member.shape)
            except ValueError as e:
                problems.append(f"shape mismatch at {key!r}: checkpoint "
                                f"{member.shape} does not split ({e})")
                continue
            got = tuple(s.stop - s.start for s in sl)
            if got != want:
                problems.append(
                    f"shape mismatch at {key!r}: checkpoint "
                    f"{member.shape} (the rank's slice {got}) vs "
                    f"template {want}")
                continue
            plan.append((key, leaf, member, sl))
        if problems:
            raise ValueError(
                f"checkpoint {path!r} does not match the template "
                f"({len(problems)} problem"
                f"{'s' if len(problems) > 1 else ''}): "
                + "; ".join(problems))
        step = None
        for key, leaf, member, sl in plan:
            if isinstance(leaf, torch.Tensor):
                _read_slice_(raw, member, sl, leaf, read_bytes)
            else:
                dst = torch.zeros((), dtype=torch.int64)
                _read_slice_(raw, member, sl, dst, read_bytes)
                step = int(dst)
    if step is not None and hasattr(like, "step"):
        like = like._replace(step=step)
    return like


def save_sliced(path: str, tree, specs, mesh, like, cfg=None,
                step: Optional[int] = None) -> None:
    """``save`` of a tree whose tensors are the ranks' slices (placed by
    ``specs`` on ``mesh``, a ``DeviceMesh``; ``like`` holds the full
    shapes: ``launch.shardings.full_shapes``): a collective, every rank
    calls it. Each leaf goes to rank 0's host one block at a time
    (``READ_BYTES``, the blocks ``restore_sliced`` reads): the rank that
    holds each part of a block at data coordinate 0 sends it, and rank 0
    writes the blocks in order as one member of an ordinary ``.npz``
    (what ``np.load``, ``restore`` / ``restore_train`` and the
    reference's ``restore`` read)."""
    import torch.distributed as dist

    from repro_torch.common.sharding import axis_names
    rank0 = dist.get_rank() == 0
    names_m = axis_names(mesh)
    sizes = tuple(int(n) for n in mesh.mesh.shape)
    zf = tmp = None
    if rank0:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        os.close(fd)
        zf = zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED,
                             allowZip64=True)
    try:
        for key, leaf, spec, names in _walk(tree, specs):
            full = _full_leaf(like, names)
            if not isinstance(leaf, torch.Tensor):
                if rank0:
                    _write_member(zf, key, np.asarray(leaf))
                continue
            _gather_leaf(zf, key, leaf, _placement(
                cfg, mesh, names, spec, tuple(full.shape)),
                tuple(full.shape), mesh, names_m, sizes, READ_BYTES)
        if rank0:
            if step is not None:
                _write_member(zf, "__step__", np.asarray(step))
            zf.close()
            zf = None
            os.replace(tmp, path)
    finally:
        if zf is not None:
            zf.close()
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
    dist.barrier()


def save_train_sliced(path: str, state, specs, mesh, like, cfg=None,
                      step: Optional[int] = None) -> None:
    """``save_train`` of a ``TrainState`` whose tensors are the ranks'
    slices (``save_sliced``): the file ``save_train`` writes of the
    gathered state."""
    save_sliced(path, state._replace(step=np.asarray(int(state.step),
                                                     np.int32)),
                specs, mesh, like, cfg, step)


def _full_leaf(like, names):
    for k in names:
        like = getattr(like, k) if hasattr(like, "_fields") else like[k]
    return like


def _write_member(zf, key: str, arr: np.ndarray) -> None:
    with zf.open(key + ".npy", "w", force_zip64=True) as fh:
        np.lib.format.write_array(fh, np.asarray(arr, order="C"),
                                  allow_pickle=False)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The file's dtype of a tensor dtype (bf16 is written as fp32)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(torch.empty((), dtype=dtype).numpy().dtype)


def _owners(ps, shape, j, t, sizes, names_m):
    """The parts of block ``t`` (an index of dims < ``j``) of a leaf
    placed by ``ps``: (mesh coordinate of the holder at data coordinate
    0, the part's box in the block, the box in the holder's slice)."""
    shape_m = dict(zip(names_m, sizes))
    per_dim = []                    # [(axes, n, blk)] of every dim
    for d, axes in enumerate(ps):
        if axes is None:
            per_dim.append(None)
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = int(np.prod([shape_m[a] for a in axes]))
        per_dim.append((axes, n, shape[d] // n))
    choices = []
    for d, p in enumerate(per_dim):
        if p is None:
            choices.append([None])
        elif d < j:
            choices.append([t[d] // p[2]])
        else:
            choices.append(list(range(p[1])))
    out = []
    for pick in itertools.product(*choices):
        coord = dict.fromkeys(names_m, 0)
        in_block, in_local = [], []
        for d, (p, c) in enumerate(zip(per_dim, pick)):
            if p is not None:
                axes, n, blk = p
                rem = c
                for a in reversed(axes):
                    coord[a] = rem % shape_m[a]
                    rem //= shape_m[a]
            if d < j:
                in_local.append(t[d] - (0 if p is None else c * p[2]))
                continue
            if p is None:
                in_block.append(slice(0, shape[d]))
                in_local.append(slice(0, shape[d]))
            else:
                in_block.append(slice(c * p[2], (c + 1) * p[2]))
                in_local.append(slice(0, p[2]))
        out.append((tuple(coord[a] for a in names_m), tuple(in_block),
                    tuple(in_local)))
    return out


def _gather_leaf(zf, key, leaf, ps, shape, mesh, names_m, sizes, cap):
    """One leaf to rank 0's member ``key``, a block at a time
    (``save_sliced``)."""
    import torch.distributed as dist
    rank0 = zf is not None
    dt = _np_dtype(leaf.dtype)
    j = min(_block_dim(shape, dt.itemsize, cap), max(len(shape) - 1, 0))
    fh = None
    if rank0:
        fh = zf.open(key + ".npy", "w", force_zip64=True)
        np.lib.format.write_array_header_1_0(fh, {
            "descr": np.lib.format.dtype_to_descr(dt),
            "fortran_order": False, "shape": shape})
    try:
        for t in itertools.product(*(range(n) for n in shape[:j])):
            block = (np.empty(shape[j:], dt) if rank0 else None)
            for coord, in_block, in_local in _owners(
                    ps, shape, j, t, sizes, names_m):
                src = int(mesh.mesh[coord])
                if src == dist.get_rank():
                    part = leaf[in_local].contiguous()
                    if rank0:
                        block[in_block] = part.cpu().to(
                            torch.float32 if leaf.dtype == torch.bfloat16
                            else leaf.dtype).numpy()
                    else:
                        dist.send(part, 0)
                elif rank0:
                    part = torch.empty(tuple(
                        s.stop - s.start for s in in_block),
                        dtype=leaf.dtype, device=leaf.device)
                    dist.recv(part, src)
                    block[in_block] = part.cpu().to(
                        torch.float32 if leaf.dtype == torch.bfloat16
                        else leaf.dtype).numpy()
            if rank0:
                fh.write(np.ascontiguousarray(block).tobytes())
    finally:
        if fh is not None:
            fh.close()
