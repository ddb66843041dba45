"""Device meshes and their logical rule tables — the port of
``repro.launch.mesh`` over ``torch.distributed``.

``make_pod_mesh`` builds the ``(pod_axis, "agent")`` ``DeviceMesh`` of
hierarchical DDAL (``repro_torch.core.pod_dispatch``): the ``"agent"``
axis holds a pod's ranks, ``pod_axis`` crosses pods, and only pod
leaders' planes cross it. ``init_distributed`` starts the process group
from ``torchrun``'s environment for the device the caller asked for:
NCCL for ``cuda`` (rank r on ``cuda:LOCAL_RANK``), gloo for ``cpu``. A
failed NCCL start raises; nothing falls back to gloo or the host.

``make_production_mesh`` builds the reference's 16 x 16 ``("data",
"model")`` mesh (2 x 16 x 16 ``("pod", "data", "model")`` with
``multi_pod``) over a world of exactly that many ranks, and
``make_debug_mesh`` any small ``(data, model)`` mesh over the world's
ranks (the tests' and ``chip_smoke.py``'s). ``train_rules`` /
``serve_rules`` are the reference's logical→physical tables, copied as
data; they read a mesh's axis names and sizes, so they take a
``DeviceMesh`` or any description with ``axis_names`` and a ``shape``
dict. Ranks lie on a mesh in row-major order (``init_device_mesh``'s).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.common.sharding import axis_names, axis_size


def init_distributed(device: str = "cuda") -> torch.device:
    """Initialise the default process group from the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them) and return this rank's device: ``cuda``
    takes NCCL on ``cuda:LOCAL_RANK``, ``cpu`` takes gloo. A group that
    is already up is kept."""
    import torch.distributed as dist
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: expected cuda or cpu")
    if kind == "cuda":
        from repro_torch.common.device import resolve_device
        resolve_device("cuda")                 # raises with no card
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        if kind == "cuda":
            dist.init_process_group("nccl", device_id=dev)
        else:
            dist.init_process_group("gloo")
    backend = dist.get_backend()
    if backend != ("nccl" if kind == "cuda" else "gloo"):
        raise RuntimeError(
            f"the process group runs {backend!r}, not the backend of "
            f"device {device!r}")
    return dev


def make_pod_mesh(n_pods: int, devices_per_pod: Optional[int] = None,
                  pod_axis: str = "pod", device_type: str = "cuda"):
    """Two-level ``(pod_axis, "agent")`` mesh of ``n_pods`` rows over the
    process group's ranks, in row-major rank order (global rank ``p ·
    devices_per_pod + a`` at coordinate (p, a)). ``devices_per_pod``
    defaults to the world size over ``n_pods``, which must divide it.
    ``device_type`` follows the device of the run (``cuda``: NCCL,
    ``cpu``: gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "make_pod_mesh needs the process group: call "
            "init_distributed(device) (or run under torchrun) first")
    n_dev = dist.get_world_size()
    if devices_per_pod is None:
        if n_pods < 1 or n_dev % n_pods:
            raise ValueError(
                f"{n_dev} devices do not split into {n_pods} pods — "
                f"pass devices_per_pod explicitly")
        devices_per_pod = n_dev // n_pods
    if n_pods * devices_per_pod != n_dev:
        raise ValueError(
            f"a {n_pods} x {devices_per_pod} mesh needs "
            f"{n_pods * devices_per_pod} devices, the world has {n_dev}")
    return init_device_mesh(device_type, (n_pods, devices_per_pod),
                            mesh_dim_names=(pod_axis, "agent"))


def world_size() -> int:
    """The ranks of the run: the process group's, else ``torchrun``'s
    ``WORLD_SIZE``, else one process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def check_world(shape, axes) -> None:
    """Raise ``ValueError`` unless the run has exactly the ranks a mesh of
    ``shape`` needs, naming that number."""
    need = 1
    for n in shape:
        need *= int(n)
    have = world_size()
    if have != need:
        raise ValueError(
            f"a {' x '.join(str(n) for n in shape)} {tuple(axes)} mesh needs "
            f"{need} devices (one rank each); the world has {have}")


def _mesh_over_world(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    check_world(shape, axes)
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs the process group: call "
            "init_distributed(device) (or run under torchrun) first")
    return init_device_mesh(device_type, tuple(int(n) for n in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16 x 16 = 256 devices over ("data", "model").
    Multi-pod: 2 x 16 x 16 = 512 over ("pod", "data", "model"). A world
    of another size raises ``ValueError`` naming the size it needs."""
    shape, axes = production_shape(multi_pod)
    return _mesh_over_world(shape, axes, device_type)


def make_debug_mesh(shape=(1, 1), axes=("data", "model"),
                    device_type: str = "cuda"):
    """A small mesh over the process group's ranks (tests and the smoke
    run); the world must have exactly prod(shape) ranks."""
    return _mesh_over_world(shape, axes, device_type)


def train_rules(mesh, pod_axis: str = "pod") -> dict:
    """Logical→physical sharding rules for training on ``mesh``
    (``pod_axis`` names the cross-pod axis of a pod mesh)."""
    names = axis_names(mesh)
    has_pod = pod_axis in names
    if has_pod and "agent" in names:
        agent = (pod_axis, "agent")
    else:
        agent = pod_axis if has_pod else None
    return {
        "agent": agent,
        "batch": "data",
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "qkv_fused": "model",
        "ff": "model",
        "experts": "model",
        "ssm_inner": "model",
        "kv_slots": None,        # training: no decode cache
    }


def serve_rules(mesh, global_batch: int) -> dict:
    """Serving has no agent axis; the batch spreads over every non-model
    axis when it divides (pod x data on the multi-pod mesh), and decode
    caches shard their slot dim over "model"."""
    has_pod = "pod" in axis_names(mesh)
    batch_axes = ("pod", "data") if has_pod else ("data",)
    n = axis_size(mesh, batch_axes)
    batch = batch_axes if global_batch % n == 0 else None
    if batch is not None and len(batch) == 1:
        batch = batch[0]
    return {
        "agent": None,
        "batch": batch,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "qkv_fused": "model",
        "ff": "model",
        "experts": "model",
        "ssm_inner": "model",
        "kv_slots": "model",
    }


def fake_world_mesh(shape, axes, coord=None):
    """A ``(shape, axes)`` mesh in a fake world: starts the default
    process group on PyTorch's ``fake`` backend
    (``torch.testing._internal.distributed.fake_pg``) with the mesh's
    world size at the rank of ``coord`` (its coordinate, row-major; the
    origin by default) and builds the mesh with ``device_type="cuda"``.
    No other rank exists: every collective returns at once and moves
    nothing, so one process can run (or trace,
    ``repro_torch.roofline.trace``) that rank's step. The caller
    destroys the group (``torch.distributed.destroy_process_group()``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = tuple(int(n) for n in shape)
    coord = (0,) * len(shape) if coord is None else tuple(coord)
    if len(coord) != len(shape) or not all(
            0 <= c < n for c, n in zip(coord, shape)):
        raise ValueError(f"coordinate {coord} is not on a "
                         f"{' x '.join(map(str, shape))} mesh")
    if dist.is_initialized():
        raise RuntimeError("a process group is already up: destroy it "
                           "before starting a fake world")
    rank, world = 0, 1
    for c, n in zip(coord, shape):
        rank, world = rank * n + c, world * n
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())
    return init_device_mesh("cuda", shape, mesh_dim_names=tuple(axes))


def make_traced_mesh(multi_pod: bool = False, coord=None):
    """The production mesh of ``make_production_mesh`` (16 x 16, or
    2 x 16 x 16 with ``multi_pod``) in a fake world of 256 or 512 ranks,
    seen from the rank at ``coord`` (:func:`fake_world_mesh`)."""
    return fake_world_mesh(*production_shape(multi_pod), coord)
