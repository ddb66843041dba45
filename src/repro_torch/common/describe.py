"""Blocks whose tensors only describe shapes.

The ``meta`` trees that say what a model's parameters or decode cache
look like (``models.model.param_specs`` / ``cache_specs``) and the
placement plans made from them are bookkeeping: no card ever holds
them. :func:`describing` marks the block that makes them, and a counter
of device memory and traffic (``repro_torch.roofline.trace.
StepCounter``) leaves the ops that :func:`is_describing` reports out.
Any other dispatch mode in force still sees them.
"""
from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


@contextlib.contextmanager
def describing():
    """Mark the ops of the block as shape bookkeeping (nests)."""
    depth = getattr(_STATE, "depth", 0)
    _STATE.depth = depth + 1
    try:
        yield
    finally:
        _STATE.depth = depth


def is_describing() -> bool:
    """Whether the calling thread is inside :func:`describing`."""
    return getattr(_STATE, "depth", 0) > 0
