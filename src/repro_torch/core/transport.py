"""Transport faults — a seeded, planned-up-front message-fault
injector for the knowledge exchange — the port of
``repro.core.transport``.

An individual knowledge piece travelling one edge of the gossip graph
can be **lost** (with retransmit backoff turning some losses into
extra delay), **duplicated** (re-delivered one epoch later),
**corrupted** in flight, or arrive **late** (jitter). The whole fault
history is rolled up front by :func:`transport_schedule`, a copy of the
reference's numpy planner, into ``(horizon, n, k)`` arrays that are
bitwise the reference's for the same seed. The self-loop edge (an
agent's own piece) is exempt from every fault.

The port's send plan (``repro_torch.core.knowledge``) is worked out on
the host, so ``Transport.at`` hands it host (n, k) slices: drops,
extra delay and duplicates fold into which planes a send writes, with
no device read. Corruption garbles the payload after a checksum is
stamped, and ``sparse_deliver`` quarantines the piece (payload zeroed,
``valid`` cleared).

**Checksums.** :func:`plane_checksum` is the reference's position-
weighted sum ``Σ_p (1 + p % 13)·x_p`` taken **per leaf**, with the
weights restarting at every leaf, the per-leaf sums added in leaf
order, then the int8 scales' per-leaf sums after them. The port's
agents are one flat row (``PlaneLayout``), so the weights restart at
each leaf offset (a single ``arange`` over the row would give another
``chk`` plane). The per-leaf sums are one product with a block-diagonal
weight matrix, run with TF32 off; int8 payload sums are exact in fp32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.exchange.registry import TRANSPORTS

#: additive garbage for fp32 payload corruption — huge against any
#: gradient scale, and finite (0·garbage = 0, never NaN)
CORRUPT_BIAS = 1e6
#: checksum verification tolerance: absolute + relative slack between
#: the send-side and the deliver-side fp32 reductions
CHK_ABS_TOL = 1e-4
CHK_REL_TOL = 1e-5
#: period of the position weights (1 + pos % 13), which keep the int8
#: NOT-flip visible on planes whose value multiset is symmetric
_CHK_PERIOD = 13


class TransportPlan(NamedTuple):
    """One planned fault history — plain numpy, shape (horizon, n, k).

    ``drop``: lost after the retransmit budget (never delivered).
    ``extra``: extra delivery delay (jitter + retransmit backoff).
    ``dup``: a second copy arrives one epoch after the first.
    ``corrupt``: payload garbled in flight (checksum will catch it).
    """
    drop: np.ndarray      # bool
    extra: np.ndarray     # int32
    dup: np.ndarray       # bool
    corrupt: np.ndarray   # bool

    @property
    def horizon(self) -> int:
        return self.drop.shape[0]


def transport_schedule(seed: int, n: int, k: int, horizon: int, *,
                       loss: float = 0.0, dup: float = 0.0,
                       corrupt: float = 0.0, jitter: int = 0,
                       retransmit: int = 0) -> TransportPlan:
    """Plan a deterministic per-edge fault history (see module doc).

    The plan replays cyclically: epoch ``e`` uses row ``e % horizon``.
    Probabilities are per message per edge; ``jitter`` is the maximum
    uniform extra delay; ``retransmit`` is the per-message retry
    budget (backoff 1, 2, 4, … epochs, resolved here into either a
    late delivery or a final drop).
    """
    for name, p in (("loss", loss), ("dup", dup), ("corrupt", corrupt)):
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"transport {name} probability must be in [0, 1], "
                f"got {p}")
    if jitter < 0:
        raise ValueError(f"transport jitter must be >= 0, got {jitter}")
    if retransmit < 0:
        raise ValueError(
            f"retransmit budget must be >= 0, got {retransmit}")
    if horizon < 1:
        raise ValueError(f"transport horizon must be >= 1, got {horizon}")
    rng = np.random.default_rng(seed)
    shape = (horizon, n, k)
    drop = rng.random(shape) < loss
    dup_m = rng.random(shape) < dup
    corrupt_m = rng.random(shape) < corrupt
    extra = (rng.integers(0, jitter + 1, shape).astype(np.int32)
             if jitter > 0 else np.zeros(shape, np.int32))
    if retransmit > 0 and loss > 0:
        backoff = 0
        for attempt in range(1, retransmit + 1):
            backoff += 1 << (attempt - 1)
            saved = drop & (rng.random(shape) >= loss)
            extra = np.where(saved, extra + backoff, extra)
            drop &= ~saved
    return TransportPlan(drop=drop, extra=extra, dup=dup_m,
                         corrupt=corrupt_m)


class TransportFaults(NamedTuple):
    """One epoch's fault slice — host (n, k) numpy arrays, folded into
    the send plan of ``repro_torch.core.knowledge.sparse_send``."""
    drop: np.ndarray
    extra: np.ndarray
    dup: np.ndarray
    corrupt: np.ndarray


class Transport:
    """A :class:`TransportPlan` and the knob-derived delay-line headroom
    (jitter + full retransmit backoff + the duplicate's +1), which does
    not depend on the faults the seed realised."""

    def __init__(self, plan: TransportPlan, *, extra_delay: int):
        self.plan = plan
        self.horizon = plan.horizon
        self.extra_delay = int(extra_delay)

    def at(self, epoch: int) -> TransportFaults:
        """The (n, k) fault slice in force at ``epoch``: plan row
        ``epoch % horizon``."""
        e = int(epoch) % self.horizon
        return TransportFaults(drop=self.plan.drop[e],
                               extra=self.plan.extra[e],
                               dup=self.plan.dup[e],
                               corrupt=self.plan.corrupt[e])

    def deliver_mask(self, step: int, nbr) -> np.ndarray:
        """The streaming trainer's view: host (n, k) bool, True where
        this share round's message survives. Lost and corrupted
        messages are alike there (a quarantined window adds exactly 0);
        duplicates and jitter do nothing to window sums with no delay
        line. Self-loops always survive."""
        f = self.at(step)
        nbr = np.asarray(nbr)
        self_edge = nbr == np.arange(nbr.shape[0])[:, None]
        return self_edge | ~(f.drop | f.corrupt)


# ---------------------------------------------------------------------
# wire integrity: position-weighted payload checksums
# ---------------------------------------------------------------------
class LeafTable:
    """Where the leaves of a flat row lie, for the per-leaf checksum:
    ``leaves`` (offset, size) of each parameter leaf in the row and,
    for int8 planes, ``scale_leaves`` (offset, size) of each leaf's
    scale columns. The block-diagonal weight matrices are built once
    per device."""

    def __init__(self, leaves: Sequence[Tuple[int, int]],
                 scale_leaves: Optional[Sequence[Tuple[int, int]]] = None):
        self.leaves = tuple((int(o), int(s)) for o, s in leaves)
        self.scale_leaves = (None if scale_leaves is None else
                             tuple((int(o), int(s)) for o, s in scale_leaves))
        self._on: dict = {}

    @classmethod
    def of(cls, p: int, layout=None, blocks=None) -> "LeafTable":
        """The table of a row of ``p`` elements: the leaves of
        ``layout`` (a ``PlaneLayout``; one leaf when ``None``) and, with
        an int8 ``blocks`` (``BlockLayout``), their scale columns."""
        if layout is None:
            leaves = [(0, p)]
        else:
            leaves = list(zip(layout.offsets, layout.sizes))
        scale_leaves = None
        if blocks is not None:
            nbs = [-(-s // blocks.q_block) for s in blocks.sizes]
            scale_leaves = list(zip(blocks.scale_offsets, nbs))
        return cls(leaves, scale_leaves)

    @staticmethod
    def _weights(leaves, width: int) -> torch.Tensor:
        W = torch.zeros((width, len(leaves)), dtype=torch.float32)
        for j, (off, size) in enumerate(leaves):
            W[off:off + size, j] = (torch.arange(size) % _CHK_PERIOD
                                    + 1).to(torch.float32)
        return W

    def weights(self, device, p: int, nb: int = 0):
        key = (str(torch.device(device)), p, nb)
        if key not in self._on:
            W = self._weights(self.leaves, p).to(device)
            Ws = (None if self.scale_leaves is None else
                  self._weights(self.scale_leaves, nb).to(device))
            self._on[key] = (W, Ws)
        return self._on[key]


def _per_leaf(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(rows, L) per-leaf weighted sums of ``x`` (rows, width), with
    TF32 off on the card."""
    x = x.to(torch.float32)
    if not x.is_cuda:
        return x @ W
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ W
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def plane_checksum(pieces: torch.Tensor, scales: Optional[torch.Tensor],
                   table: LeafTable) -> torch.Tensor:
    """Per-row payload checksum of flat rows ``pieces`` (..., P), fp32
    or int8, plus their int8 ``scales`` (..., nb) when given: each
    leaf's ``Σ (1 + i % 13)·x_i`` with ``i`` counted from the leaf's
    start, added in leaf order, then the scale leaves' sums. Returns
    the leading shape."""
    lead = pieces.shape[:-1]
    W, Ws = table.weights(pieces.device, pieces.shape[-1],
                          0 if scales is None else scales.shape[-1])
    parts = _per_leaf(pieces.reshape(-1, pieces.shape[-1]), W)
    if scales is not None:
        parts = torch.cat([parts, _per_leaf(
            scales.reshape(-1, scales.shape[-1]), Ws)], dim=1)
    total = parts[:, 0]
    for j in range(1, parts.shape[1]):
        total = total + parts[:, j]
    return total.reshape(lead)


def checksum_ok(carried: torch.Tensor, recomputed: torch.Tensor
                ) -> torch.Tensor:
    """Elementwise integrity verdict (True = intact)."""
    return (torch.abs(recomputed - carried)
            <= CHK_ABS_TOL + CHK_REL_TOL * torch.abs(carried))


def corrupt_planes(pieces: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """Garble the rows of ``pieces`` (..., P) where ``mask`` (...) is
    set: fp32 rows take ``CORRUPT_BIAS - x``, int8 rows the bitwise NOT
    ``-1 - x``. Both stay finite."""
    m = mask[..., None]
    if pieces.dtype == torch.int8:
        return torch.where(m, (-1 - pieces).to(torch.int8), pieces)
    return torch.where(m, (CORRUPT_BIAS - pieces).to(pieces.dtype), pieces)


# ---------------------------------------------------------------------
# registry strategies + spec resolution
# ---------------------------------------------------------------------
def _any_fault_knob(spec) -> bool:
    return (spec.transport_loss > 0 or spec.transport_dup > 0
            or spec.transport_corrupt > 0 or spec.transport_jitter > 0)


def transport_key(spec) -> str:
    """The spec's transport strategy key (``"auto"``: ``"faulty"`` when
    any fault rate is nonzero)."""
    key = spec.exchange_transport
    if key != "auto":
        return key
    return "faulty" if _any_fault_knob(spec) else "none"


def transport_enabled(spec) -> bool:
    return transport_key(spec) == "faulty"


@TRANSPORTS.register("none")
def _make_none_transport(*, spec, shape) -> None:
    """Perfect delivery: no checksum or send-epoch planes, no fault
    ops."""
    del spec, shape
    return None


@TRANSPORTS.register(
    "faulty",
    params={"loss": ("transport_loss", float),
            "dup": ("transport_dup", float),
            "corrupt": ("transport_corrupt", float),
            "jitter": ("transport_jitter", int),
            "retransmit": ("transport_retransmit", int),
            "transport_seed": ("transport_seed", int),
            "transport_horizon": ("transport_horizon", int),
            "max_staleness": ("max_staleness", int),
            "staleness_decay": ("transport_decay", float)})
def _make_faulty_transport(*, spec, shape) -> Transport:
    """The seeded planned injector over the ``transport_*`` knobs;
    ``shape`` is the base topology's (n, k) edge table shape."""
    n, k = shape
    plan = transport_schedule(
        spec.transport_seed, n, k, spec.transport_horizon,
        loss=spec.transport_loss, dup=spec.transport_dup,
        corrupt=spec.transport_corrupt, jitter=spec.transport_jitter,
        retransmit=spec.transport_retransmit)
    extra = (spec.transport_jitter + ((1 << spec.transport_retransmit) - 1)
             + (1 if spec.transport_dup > 0 else 0))
    return Transport(plan, extra_delay=extra)


def make_transport(spec, shape) -> Optional[Transport]:
    """The spec's transport model for an (n, k) edge table — ``None``
    for perfect delivery."""
    return TRANSPORTS.get(transport_key(spec))(spec=spec, shape=shape)
