"""Multi-tenant group serving — the port of ``repro.serving.group``:
one engine serves every agent's policy of a group.

GARL's premise is many separate agents with separate policies; at
serving time the group is a natural multi-tenant batch. Requests carry
an ``agent_id``, a :class:`Router` assigns them to continuous-batching
slots, and one decode step advances every live slot, each under its own
agent's weights from the **stacked per-agent parameter planes** (leaves
(A, ...), the layout the DDAL trainer keeps). The reference gathers
every slot's whole parameter set and vmaps a B = 1 decode; here each
layer's weights are gathered for the B slots just before that layer
runs (``model.decode(..., agents)``), so the transient is B copies of
one layer, not of the model, and the step is one batched pass whatever
the mix of agents.

Train→serve hot-swap: a :class:`ParamStore` holds the published planes
double-buffered with a monotonic version counter. ``publish`` never
writes into a buffer: it installs new tensors in the back slot and
flips, so a reader that acquired a buffer keeps it intact for as long
as it holds it. ``publish`` copies the planes it is given, so a trainer
that goes on updating its tensors in place changes nothing that is
served; ``donate=True`` hands them over without a copy (the caller must
not write them again). The engine acquires the live buffer at each
step boundary; a request admitted after a publish serves the new planes
from its first prefill. The store checkpoints through
``repro_torch.checkpoint.npz`` with the version in ``__step__``, under
the reference's keys, so a store saved by either package loads in the
other.

On a ``(pod, "agent")`` mesh (``mesh=``, every rank of the process
group running the same engine) the store places each publish by
``group_plane_partition_specs``: a rank keeps its agents' rows of every
plane (``repro_torch.launch.shardings.AgentPlanes``), the trainer's
placement, so a publish from an agent-sharded trainer moves no plane.
Every rank runs the same router and slots. An admission's B = 1 prefill
runs on the rank that holds the request's agent, which broadcasts the
next-token logits and the prompt's cache; each decode step takes every
slot's layer rows from the rank that holds the slot's agent (an
owner-masked all-reduce, one per gathered leaf:
``common.pytree.pick_rows``). So every rank sees the same logits and
draws the same tokens. A ``(data, model)`` mesh raises
``NotPortedError``: the reference places group planes over its agent
axes only.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import npz
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (agent_rows, tree_leaves_with_paths,
                                       tree_map)
from repro_torch.configs.base import ArchConfig, NotPortedError
from repro_torch.models import get_model
from repro_torch.serving.api import Sampler, ServeConfig, StopCriteria
from repro_torch.serving.continuous import (SlotBatch, device_of,
                                           prefill_logits, prefill_one)
from repro_torch.serving.metrics import ServeMetrics


@dataclasses.dataclass(frozen=True)
class GroupRequest:
    """One tenant request: which agent's policy, and its prompt."""
    rid: int
    agent_id: int
    prompt: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(self.prompt))


# ---------------------------------------------------------------------
# router: queued requests → freed slots
# ---------------------------------------------------------------------
class Router:
    """Assigns queued requests to freed continuous-batching slots.

    ``fifo`` (default) is strict arrival order — lowest latency when
    tenants are well-behaved. ``fair`` keeps one queue per agent and
    round-robins across non-empty agents, so one chatty tenant cannot
    starve the rest of the group. Both are deterministic in the
    submission order.
    """

    def __init__(self, policy: str = "fifo"):
        if policy not in ("fifo", "fair"):
            raise ValueError(
                f"unknown router policy {policy!r}; expected 'fifo' "
                f"or 'fair'")
        self.policy = policy
        self._fifo: deque = deque()
        self._per_agent: "OrderedDict[int, deque]" = OrderedDict()

    def push(self, req: GroupRequest) -> None:
        if self.policy == "fifo":
            self._fifo.append(req)
        else:
            self._per_agent.setdefault(req.agent_id, deque()).append(req)

    def pop(self) -> Optional[GroupRequest]:
        if self.policy == "fifo":
            return self._fifo.popleft() if self._fifo else None
        for aid in list(self._per_agent):
            q = self._per_agent.pop(aid)
            req = q.popleft()
            if q:       # rotate: agent re-queues at the back
                self._per_agent[aid] = q
            return req
        return None

    def __len__(self) -> int:
        if self.policy == "fifo":
            return len(self._fifo)
        return sum(len(q) for q in self._per_agent.values())

    def depth(self, agent_id: int) -> int:
        """Queued requests for one tenant (observability)."""
        if self.policy == "fifo":
            return sum(1 for r in self._fifo if r.agent_id == agent_id)
        return len(self._per_agent.get(agent_id, ()))


# ---------------------------------------------------------------------
# publish/acquire hot-swap store
# ---------------------------------------------------------------------
def _np_template(leaf) -> np.ndarray:
    """A leaf's shape and dtype as a numpy view that holds no memory
    (``npz.restore`` reads only these): the leaf itself if it is a
    numpy array, else a zero-stride array (a tensor, e.g. on ``meta``)."""
    if isinstance(leaf, np.ndarray):
        return leaf
    dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.broadcast_to(np.zeros((), dtype), tuple(leaf.shape))


class ParamStore:
    """Double-buffered stacked per-agent parameter planes + version.

    ``publish`` installs the incoming planes in the *back* slot, flips
    the live index and bumps the version; it never writes into a
    tensor, so a reader that acquired a buffer keeps a complete plane
    set for as long as it holds it (the initial two slots alias one
    buffer, as in the reference, and nothing ever copies into either).
    The store keeps the live buffer and the previous one. ``acquire``
    returns ``(planes, version)`` of the live buffer. The planes given
    to the constructor or to ``publish`` are copied, unless
    ``donate=True`` hands them over. ``placer`` (the reference's: a
    ``repro_torch.launch.shardings.AgentPlanes``) places each set of
    planes before it is kept: on a pod mesh the rank's rows only;
    ``n_agents`` stays the group's.
    """

    def __init__(self, planes: Any, donate: bool = False, placer=None):
        self._placer = placer
        self._n_agents = (placer.n_agents if placer is not None else int(
            tree_leaves_with_paths(planes)[0][1].shape[0]))
        planes = self._take(planes, donate)
        self._buf: List[Any] = [planes, planes]
        self._live = 0
        self._version = 0

    def _take(self, planes, donate: bool):
        placed = planes if self._placer is None else self._placer(planes)
        return tree_map(lambda t, given: t if donate and t is given
                        else t.detach().clone(), placed, planes)

    @property
    def version(self) -> int:
        return self._version

    @property
    def n_agents(self) -> int:
        return self._n_agents

    def publish(self, planes: Any, donate: bool = False) -> int:
        """Install fresh planes (e.g. a trainer's post-exchange
        ``state.params``), copied unless ``donate``; returns the new
        version."""
        back = 1 - self._live
        # let go of the buffer two publishes old before the copy is
        # made, so the store never holds three plane sets
        self._buf[back] = None
        self._buf[back] = self._take(planes, donate)
        self._live = back
        self._version += 1
        return self._version

    def acquire(self) -> Tuple[Any, int]:
        """The live planes and their version (no copy)."""
        return self._buf[self._live], self._version

    # -- checkpointing (repro_torch.checkpoint.npz) --------------------
    def save(self, path: str) -> None:
        """Write the live planes and their version. With a placer the
        ranks' rows are gathered first (every rank calls it) and the
        process group's rank 0 writes the file."""
        planes, version = self.acquire()
        if self._placer is not None:
            import torch.distributed as dist

            from repro_torch.core.sharded_ddal import gather_rows
            ranks = self._n_agents // self._placer.block
            planes = tree_map(lambda t: gather_rows(t, ranks, None), planes)
            if dist.get_rank() != 0:
                return
        npz.save(path, planes, step=version)

    @classmethod
    def load(cls, path: str, template: Any, device=None,
             placer=None) -> "ParamStore":
        """Rebuild a store from a published checkpoint (written by
        either package). ``template`` is a matching nest of numpy
        arrays or tensors (``meta`` tensors allocate nothing): only its
        shapes and dtypes are read. The planes land on ``device``
        (``None``: the card), placed by ``placer``."""
        dev = resolve_device(device)
        tree = npz.restore(path, tree_map(_np_template, template))
        planes = tree_map(lambda a: torch.from_numpy(a).to(dev), tree)
        store = cls(planes, donate=True, placer=placer)
        store._version = npz.restore_step(path) or 0
        return store


def publish_from_trainer(store: ParamStore, state) -> int:
    """Push a live trainer's current per-agent parameter planes
    (``state.params``, a nest with a leading agent axis) into the
    serving store, copied. On a pod mesh an agent-sharded trainer's
    state (``launch.shardings.agent_sharded_state``) holds the rank's
    rows, which the store's placer takes as they are: no plane crosses
    ranks."""
    return store.publish(state.params)


def _plane_placer(mesh, pod_axis: str, n_agents: int):
    """The ``AgentPlanes`` of ``mesh``: a ``(pod_axis, "agent")`` mesh;
    a ``(data, model)`` mesh raises ``NotPortedError``, anything that is
    not a device mesh ``ValueError``."""
    from repro_torch.common.sharding import axis_names
    from repro_torch.launch.shardings import AgentPlanes
    names = axis_names(mesh)
    if not names or not hasattr(mesh, "get_group"):
        raise ValueError(
            f"GroupServeEngine(mesh={mesh!r}): expected a DeviceMesh over "
            f"({pod_axis!r}, 'agent')")
    if "model" in names or "data" in names:
        raise NotPortedError(
            f"GroupServeEngine on a {names} mesh: the reference places "
            f"group planes over its agent axes only ({pod_axis!r}, "
            f"'agent'); a model axis for the group engine is not in it")
    return AgentPlanes.on(mesh, n_agents, pod_axis)


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------
@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    agent_id: int = 0
    tokens: Optional[list] = None
    done: bool = True


class GroupServeEngine:
    """Continuous batching across every tenant of a group.

    ``planes`` is either a :class:`ParamStore` or a stacked-params nest
    (leaves ``(A, *param)``, on the serving device), which is wrapped in
    a fresh store (copied). ``mesh`` (a ``(pod_axis, "agent")``
    ``DeviceMesh`` over the whole process group, every rank running the
    same engine): the store places each publish over the agent axes and
    the steps gather per-slot rows from their owners (module docstring).
    Temperature sampling draws from each rank's generator, seeded alike
    from ``seed``, so the ranks agree.

    Incremental API (what the load bench drives)::

        engine.submit(GroupRequest(rid, agent_id, prompt))
        finished = engine.step()     # refill + one batched decode step
        engine.drain()               # step() until idle → all results

    ``run(requests)`` is the batch convenience wrapper.
    """

    def __init__(self, cfg: ArchConfig, planes, serve: ServeConfig,
                 batch_size: int, prompt_pad: int = 32,
                 router: Optional[Router] = None,
                 metrics: Optional[ServeMetrics] = None,
                 mesh=None, pod_axis: str = "pod", seed: int = 0):
        self.cfg = cfg
        self.serve = serve
        self.B = batch_size
        self.prompt_pad = prompt_pad
        self.model = get_model(cfg)
        self.sampler = Sampler(serve.temperature)
        self.stop = StopCriteria.from_serve(serve)
        self.metrics = metrics
        self.router = router if router is not None else Router()
        self._seed = seed
        self._placement = None
        if isinstance(planes, ParamStore):
            self.store = planes
        else:
            placer = None
            if mesh is not None:
                placer = _plane_placer(mesh, pod_axis, int(
                    tree_leaves_with_paths(planes)[0][1].shape[0]))
            self.store = ParamStore(planes, placer=placer)
        self.n_agents = self.store.n_agents
        if mesh is not None:
            placer = self.store._placer
            if placer is None:
                _plane_placer(mesh, pod_axis, self.n_agents)  # the checks
                raise ValueError(
                    "GroupServeEngine(mesh=...) with a ParamStore of whole "
                    "planes: build the store with placer=AgentPlanes.on("
                    "mesh, n_agents)")
            self._placement = placer
        self.reset()

    # -- host state ----------------------------------------------------
    def reset(self) -> None:
        """Fresh slots/caches/results (the router and store persist)."""
        planes, _ = self.store.acquire()
        self.device = device_of(planes)
        self._slots = [_Slot() for _ in range(self.B)]
        self._state = SlotBatch(self.cfg, self.model, self.B,
                                self.serve.max_len, self.device)
        self._gen = torch.Generator(self.device).manual_seed(self._seed)
        self.results: Dict[int, List[int]] = {}

    # -- public --------------------------------------------------------
    def submit(self, req: GroupRequest, at: Optional[float] = None
               ) -> None:
        """Queue a request; ``at`` backdates its enqueue timestamp to
        the scheduled (open-loop) arrival time, so queueing delay
        between arrival and admission is part of measured latency."""
        if not 0 <= req.agent_id < self.n_agents:
            raise ValueError(
                f"request {req.rid}: agent_id {req.agent_id} outside "
                f"the group (n_agents={self.n_agents})")
        self.router.push(req)
        if self.metrics is not None:
            self.metrics.enqueue(req.rid, req.agent_id, at=at)

    @property
    def live(self) -> int:
        return sum(1 for s in self._slots if not s.done)

    @property
    def idle(self) -> bool:
        return self.live == 0 and len(self.router) == 0

    def _finish(self, rid: int, tokens: List[int]) -> None:
        self.results[rid] = tokens
        if self.metrics is not None:
            self.metrics.finish(rid, len(tokens))

    @torch.no_grad()
    def _refill(self) -> None:
        for i, s in enumerate(self._slots):
            if not s.done:
                continue
            req = self.router.pop()
            if req is None:
                return
            planes, version = self.store.acquire()
            n = len(req.prompt)
            if self.metrics is not None:
                self.metrics.admitted(req.rid, version=version)
            first, one = self._prefill(planes, req)
            if self.metrics is not None:
                self.metrics.first_token(req.rid)
            if self.stop.should_stop(1, first, n):
                self._finish(req.rid, [first])
                continue
            self._state.admit(i, one, first, n, agent=req.agent_id)
            self._slots[i] = _Slot(request_id=req.rid,
                                   agent_id=req.agent_id,
                                   tokens=[first], done=False)

    def _prefill(self, planes, req: GroupRequest) -> Tuple[int, Any]:
        """The B = 1 prefill of ``req`` under its agent's weights (views
        of its row of every plane) → (its first token, its cache). On a
        mesh the rank that holds the agent runs it and broadcasts the
        next-token logits and the cache to every rank, and each samples
        the same token."""
        if self._placement is None:
            params = tree_map(lambda p: p[req.agent_id], planes)
            return prefill_one(self.cfg, self.model, params, req.prompt,
                               self.prompt_pad, self.serve.max_len,
                               self.sampler, self._gen)
        import torch.distributed as dist

        from repro_torch.common.sharding import count
        owner = req.agent_id // self._placement.block
        if owner == dist.get_rank():
            params = tree_map(
                lambda p: p[req.agent_id - self._placement.first], planes)
            nl, one = prefill_logits(self.cfg, self.model, params,
                                     req.prompt, self.prompt_pad,
                                     self.serve.max_len)
        else:
            one = self.model.make_cache(self.cfg, 1, self.serve.max_len,
                                        device=self.device)
            nl = torch.empty((1, self.cfg.vocab_size), device=self.device,
                             dtype=self.cfg.dtype("compute"))
        for t in [nl] + [x for _, x in tree_leaves_with_paths(one)]:
            count("prefill_bcast")
            dist.broadcast(t, owner)
        return int(self.sampler(nl, self._gen)[0]), one

    def decode_step(self, planes, batch, cache):
        """The model's batched decode of every slot, each under its own
        agent's weights (``self._state.agents``; on a mesh each slot's
        rows from the rank that holds its agent)."""
        with agent_rows(self._placement):
            return self.model.decode(self.cfg, planes, batch, cache,
                                     self._state.agents)

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """Refill freed slots from the router, then advance every live
        slot by one batched decode step; returns the requests finished
        during this step ({rid: tokens})."""
        before = set(self.results)
        self._refill()
        if self.metrics is not None:
            self.metrics.observe_step(len(self.router), self.live)
        live = [i for i, s in enumerate(self._slots) if not s.done]
        if not live:
            return {r: self.results[r]
                    for r in set(self.results) - before}

        planes, _ = self.store.acquire()
        # the step's one device→host copy (the sampled tokens)
        nxt_h = self._state.step(
            lambda batch, cache: self.decode_step(planes, batch, cache),
            self.sampler, self._gen, live)
        for i in live:
            s = self._slots[i]
            t = int(nxt_h[i])
            s.tokens.append(t)
            if self.stop.should_stop(len(s.tokens), t,
                                     int(self._state.pos[i])):
                self._finish(s.request_id, s.tokens)
                s.done = True
                self._state.release(i)
        return {r: self.results[r] for r in set(self.results) - before}

    def drain(self) -> Dict[int, List[int]]:
        """step() until no queued or in-flight work remains."""
        while not self.idle:
            self.step()
        return self.results

    def run(self, requests: Sequence[GroupRequest]
            ) -> Dict[int, List[int]]:
        """Batch convenience: submit everything, drain, return
        {rid: tokens}."""
        for req in requests:
            self.submit(req)
        return self.drain()
