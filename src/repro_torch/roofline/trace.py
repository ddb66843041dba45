"""What one rank's step does, counted on ``meta`` tensors: the dry
run's counterpart of XLA's ``cost_analysis`` and ``memory_analysis``.

:func:`traced` runs a block whose tensors lie on ``meta`` (they carry
shapes and dtypes, take part in autograd and in the collectives of a
fake process group, and allocate and compute nothing) under three
counters:

- ``torch.utils.flop_counter.FlopCounterMode``: the matmul FLOPs
  (``mm``, ``bmm``, ``addmm``, … and the port's kernels through their
  registered formulas, ``kernels.flash_attention.ops`` and
  ``kernels.ssd_scan.ops``);
- :class:`StepCounter`: the bytes accessed (each op's device tensor
  inputs read once and its outputs written once; views, empty
  allocations and collectives move none), the live bytes of every
  device storage from the op that makes it to its last reference (the
  peak is the memory a card needs) and a count of every op by name (a
  kernel op's count is the launches it would make); it leaves out
  the ops of a block that only describes shapes
  (``common.describe.describing``: the ``meta`` trees of
  ``param_specs`` and ``cache_specs``, the placement plans);
- ``collectives.CollectiveRecorder``: the collectives, with their
  operand bytes.

Why ``meta`` and not fake ``cuda`` tensors (``FakeTensorMode``): on a
PyTorch build without CUDA, autograd's bookkeeping and Python's tensor
indexing ask a ``cuda`` tensor, fake or not, for a CUDA device guard
that the build lacks, so a train step could not be traced on a host
with no card. ``meta`` tensors run the same code on either build. The
kernel wrappers send a ``meta`` (or fake) tensor to their kernel's op,
whose shape function answers it (the plain version does not run in its
place).
"""
from __future__ import annotations

import collections
import contextlib
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.common.describe import is_describing
from repro_torch.roofline.collectives import CollectiveRecorder

# ops that move no bytes: fresh allocations, aliases, scalar reads,
# metadata (``prim.device``)
_FREE = {"aten.empty", "aten.empty_like", "aten.empty_strided",
         "aten.new_empty", "aten.new_empty_strided", "aten.detach",
         "aten.alias", "aten.lift_fresh", "aten._local_scalar_dense",
         "aten._unsafe_view", "aten._reshape_alias", "prim.device"}


def device_tensors(tree) -> list:
    """The device tensors in a nest of lists, tuples and dicts (host
    tensors are no device traffic and hold no device memory)."""
    out = []
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "cpu":
            out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            out += device_tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            out += device_tensors(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Bytes accessed, live and peak bytes and op counts of the ops
    dispatched while it is active (see the module's docstring), and
    ``op_bytes``, the bytes accessed by op name. Every card tensor an
    op returns is live from then on, so ``live`` right after the step's
    inputs are made is the bytes of its arguments."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.ops: Dict[str, int] = collections.Counter()
        self.op_bytes: Dict[str, int] = collections.Counter()
        self._sizes: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def _hold(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count the storages of ``tensors`` live (each once)."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._sizes:
                continue
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if is_describing():
            return func(*args, **kwargs)
        name = str(func.overloadpacket._qualified_op_name).replace("::", ".")
        self.ops[name] += 1
        out = func(*args, **kwargs)
        if not (func.is_view or name in _FREE
                or name.startswith(("c10d.", "_c10d_functional."))):
            ins = {id(t): t for t in device_tensors((args, kwargs))}
            n = (sum(_nbytes(t) for t in ins.values())
                 + sum(_nbytes(t) for t in device_tensors(out)))
            self.bytes_accessed += n
            self.op_bytes[name] += n
        if not func.is_view:
            self._hold(device_tensors(out))
        return out


class Trace:
    """The counters of one traced block (:func:`traced`)."""

    def __init__(self, flops, counter, recorder):
        self.flop_counter = flops
        self.counter = counter
        self.recorder = recorder

    @property
    def flops(self) -> int:
        return self.flop_counter.get_total_flops()


@contextlib.contextmanager
def traced():
    """Run the block under the counters; yields a :class:`Trace`. Make
    the step's inputs inside the block (``meta`` tensors): they count
    as live from then on."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    counter, recorder = StepCounter(), CollectiveRecorder()
    with flops, counter, recorder:
        yield Trace(flops, counter, recorder)
