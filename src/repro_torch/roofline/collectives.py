"""Per-collective byte counts of one rank's traced step — the port of
``repro.roofline.hlo``.

The reference parses a compiled HLO module and sums the OPERAND bytes
of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute. Torch has no module to parse: the collectives a
rank issues are ``torch.distributed`` calls, which reach the
dispatcher as ``c10d`` ops (``c10d.allreduce_``, ``c10d.allgather_``,
…; the functional forms as ``_c10d_functional`` ops).
:class:`CollectiveRecorder`, a ``TorchDispatchMode``, records each one
with its operand bytes as the reference counts them: the tensors a rank
contributes (all-reduce and broadcast: the buffer; all-gather: the
rank's piece; reduce-scatter and all-to-all: the whole input;
``send``: the tensor sent, as a collective-permute's operand; a
``recv`` is its peer's send and adds nothing). ``broadcast`` has no XLA
kind: it has a key of its own and counts in ``total``.

Every layer runs eagerly, so a collective inside a layer loop is
recorded once per layer: nothing is extrapolated.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
               "all-to-all", "collective-permute")
KINDS = COLLECTIVES + ("broadcast",)

# op name → (kind, index of the operand argument)
_OPS = {
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.broadcast_": ("broadcast", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_coalesced_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": (
        "reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_c10d_functional.broadcast": ("broadcast", 0),
}


class Record(NamedTuple):
    """One collective a rank issued: its kind (``KINDS``), the op's
    name and its operand bytes."""
    kind: str
    op: str
    nbytes: int


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def record_of(func, args) -> "Record | None":
    """The ``Record`` of a dispatched op, ``None`` for any op that is no
    collective (a ``recv``, a barrier, a wait, any other op)."""
    name = func.overloadpacket._qualified_op_name.replace("::", ".")
    hit = _OPS.get(name)
    if hit is None:
        return None
    kind, at = hit
    return Record(kind, name, _tensor_bytes(args[at]))


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched while it is active (in
    ``records``, in issue order) and runs each op unchanged."""

    def __init__(self):
        super().__init__()
        self.records: List[Record] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        rec = record_of(func, args)
        if rec is not None:
            self.records.append(rec)
        return func(*args, **(kwargs or {}))


def collective_bytes(records: Iterable[Record]) -> Dict[str, int]:
    """Sum of operand bytes per collective kind over the records (one
    rank's step), plus ``total``."""
    out = {k: 0 for k in KINDS}
    out["total"] = 0
    for r in records:
        out[r.kind] += r.nbytes
        out["total"] += r.nbytes
    return out


def count_ops(records: Iterable[Record], opcode: str) -> int:
    """Records of a kind (``"all-gather"``) or of an op name
    (``"c10d.allgather_"``)."""
    return sum(1 for r in records if opcode in (r.kind, r.op))
