"""The one dispatch rule of the port's kernel wrappers: CUDA tensors
take the kernel, CPU tensors its plain version, and nothing else — a
build or launch failure raises, and ``impl`` can only name the path
the tensors' device implies (``"auto"`` picks it)."""
from __future__ import annotations

import torch

IMPLS = ("auto", "cuda", "plain")


def resolve(impl: str, x: torch.Tensor) -> str:
    """``"cuda"`` or ``"plain"`` for a call on tensor ``x``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    want = "cuda" if x.is_cuda else "plain"
    if impl not in ("auto", want):
        raise ValueError(
            f"impl={impl!r} cannot run on {x.device} tensors: CUDA "
            f"tensors take the kernel, CPU tensors its plain version")
    return want
