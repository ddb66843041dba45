"""Device meshes — the port of ``repro.launch.mesh``, its two-level pod
mesh over ``torch.distributed``.

``make_pod_mesh`` builds the ``(pod_axis, "agent")`` ``DeviceMesh`` of
hierarchical DDAL (``repro_torch.core.pod_dispatch``): the ``"agent"``
axis holds a pod's ranks, ``pod_axis`` crosses pods, and only pod
leaders' planes cross it. ``init_distributed`` starts the process group
from ``torchrun``'s environment for the device the caller asked for:
NCCL for ``cuda`` (rank r on ``cuda:LOCAL_RANK``), gloo for ``cpu``. A
failed NCCL start raises; nothing falls back to gloo or the host.

The production ``(data, model)`` / ``(pod, data, model)`` meshes and
their logical rule tables are tensor parallelism and wait for Slice E
part 2: ``make_production_mesh`` and ``make_debug_mesh`` raise
``NotPortedError``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.configs.base import NotPortedError


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


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 ``(data, model)`` (or 2 x 16 x 16 ``(pod,
    data, model)``) mesh: tensor parallelism, not ported."""
    raise NotPortedError(
        f"the production {'(pod, data, model)' if multi_pod else '(data, model)'} "
        f"mesh and its sharding rules wait for Slice E part 2; the port "
        f"places agents on the (pod, agent) mesh (make_pod_mesh)")


def make_debug_mesh(shape=(1, 1), axes=("data", "model")):
    """The reference's small ``(data, model)`` test mesh: not ported."""
    raise NotPortedError(
        f"a {tuple(shape)} mesh over {tuple(axes)} (tensor parallelism) "
        f"waits for Slice E part 2; the port places agents on the (pod, "
        f"agent) mesh (make_pod_mesh)")
