"""Communication topologies for DDAL — the port of
``repro.core.topology``, the pod placement of the ``hierarchical``
graph included (``PodLayout``, ``hierarchical_layout``,
``edge_pod_ids``, ``cross_pod_mask``: host numpy, as the reference's,
read by ``repro_torch.core.pod_dispatch``).

A ``Topology`` is a neighbor index table: for every destination agent
``i``, ``nbr[i, j]`` names the source feeding its ``j``-th incoming
edge slot, with a validity ``mask`` for non-uniform in-degrees and
per-edge ``delay`` / ``relevance`` annotations. The reference builds
these tables on the host with numpy, and so does the port, with the
same code: the tables are bitwise-equal and stay numpy arrays, which
the delay-line code reads on the host. Every constructor includes the
self-loop edge.

Time-varying gossip (``DynamicTopology``) redraws a k-regular table
every ``resample_every`` epochs with ``sample_gossip``. Torch cannot
draw threefry's streams, so the round's uniforms come from the hook
``gossip_uniforms`` (a test replaces it with the reference's recorded
``jax.random.uniform(fold_in(PRNGKey(seed), round), (n, n))``); its
default draws them from a CPU ``torch.Generator`` seeded by
``(seed, round)``, so a run replays. The table stays a host array, as
the delay line's send plan reads it there: resampling reads nothing
back from the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class Topology(NamedTuple):
    """Sparse communication graph over ``n`` agents.

    nbr:       (n, k) int32 — ``nbr[i, j]`` = source agent of dst i's
               j-th incoming edge (arbitrary value where masked out).
    mask:      (n, k) bool — which edge slots are real edges.
    delay:     (n, k) int32 — per-edge delivery delay in epochs.
    relevance: (n, k) float32 — per-edge relevance R[src→dst].
    """
    nbr: np.ndarray
    mask: np.ndarray
    delay: np.ndarray
    relevance: np.ndarray

    @property
    def n_agents(self) -> int:
        return self.nbr.shape[0]

    @property
    def degree(self) -> int:
        """Max in-degree k (the padded edge-slot count)."""
        return self.nbr.shape[1]

    @property
    def n_edges(self) -> int:
        return int(self.mask.sum())

    @property
    def max_delay(self) -> int:
        return int(np.max(self.delay * self.mask))

    def with_delay(self, delay, per_edge: bool = False) -> "Topology":
        """Attach delays: a scalar, an (n, n) src→dst matrix (gathered
        onto the edge table), or an (n, k) per-edge array; with k == n
        the dense reading wins unless ``per_edge=True``."""
        n, k = self.nbr.shape
        d = np.asarray(delay).astype(np.int32)
        if d.ndim == 0:
            d = np.full((n, k), d, np.int32)
        elif d.shape == (n, n) and not per_edge:
            d = d[self.nbr, np.arange(n)[:, None]]
        elif d.shape != (n, k):
            raise ValueError(f"delay shape {d.shape} != (), ({n},{n}) "
                             f"or ({n},{k})")
        return self._replace(delay=np.where(self.mask, d, 0)
                             .astype(np.int32))

    def with_relevance(self, relevance,
                       per_edge: bool = False) -> "Topology":
        """Attach relevance: an (n, n) matrix R[src, dst] (gathered
        onto the edge table) or an (n, k) per-edge array."""
        n, k = self.nbr.shape
        r = np.asarray(relevance).astype(np.float32)
        if r.shape == (n, n) and not per_edge:
            r = r[self.nbr, np.arange(n)[:, None]]
        elif r.shape != (n, k):
            raise ValueError(f"relevance shape {r.shape} != ({n},{n}) "
                             f"or ({n},{k})")
        return self._replace(relevance=np.where(self.mask, r, 0.0)
                             .astype(np.float32))


def _from_neighbor_lists(nbrs: Sequence[Sequence[int]]) -> Topology:
    """A padded (n, k) table from per-dst in-neighbor lists. A repeated
    source would double-count its plane in every eq. 4 sum, so it is a
    construction error."""
    n = len(nbrs)
    k = max(1, max(len(v) for v in nbrs))
    nbr = np.zeros((n, k), np.int32)
    mask = np.zeros((n, k), bool)
    for i, v in enumerate(nbrs):
        if len(set(v)) != len(v):
            raise ValueError(
                f"duplicate in-neighbor for destination {i}: {v} — "
                f"a repeated source double-counts its plane in eq. 4")
        nbr[i, :len(v)] = v
        mask[i, :len(v)] = True
    return Topology(nbr=nbr, mask=mask,
                    delay=np.zeros((n, k), np.int32),
                    relevance=mask.astype(np.float32))


def full(n: int) -> Topology:
    """All-to-all: k = n, ``nbr[i, j] = j``."""
    return _from_neighbor_lists([list(range(n)) for _ in range(n)])


def ring(n: int) -> Topology:
    """Bidirectional ring: each agent hears itself and its two ring
    neighbours."""
    return _from_neighbor_lists(
        [sorted({(i - 1) % n, i, (i + 1) % n}) for i in range(n)])


def torus2d(rows: int, cols: int) -> Topology:
    """2-D torus (rows × cols, wrap-around): self + the 4-mesh
    neighbourhood."""
    n = rows * cols
    nbrs = []
    for i in range(n):
        r, c = divmod(i, cols)
        nbrs.append(sorted({
            i,
            ((r - 1) % rows) * cols + c,
            ((r + 1) % rows) * cols + c,
            r * cols + (c - 1) % cols,
            r * cols + (c + 1) % cols,
        }))
    return _from_neighbor_lists(nbrs)


def star(n: int, hub: int = 0) -> Topology:
    """Hub-and-spoke: every leaf exchanges with the hub only."""
    nbrs = []
    for i in range(n):
        if i == hub:
            nbrs.append(list(range(n)))
        else:
            nbrs.append(sorted({i, hub}))
    return _from_neighbor_lists(nbrs)


def random_k(n: int, k: int, seed: int = 0) -> Topology:
    """Seeded gossip graph: each destination hears itself plus k−1
    distinct uniformly drawn other agents (numpy's generator, so the
    table is the reference's bit for bit)."""
    if k < 1:
        raise ValueError("random_k needs k >= 1 (the self-loop)")
    k = min(k, n)
    rng = np.random.default_rng(seed)
    nbrs = []
    for i in range(n):
        others = np.delete(np.arange(n), i)
        pick = rng.choice(others, size=k - 1, replace=False)
        nbrs.append(sorted({i, *pick.tolist()}))
    return _from_neighbor_lists(nbrs)


def hierarchical(n: int, pod_size: int = 4) -> Topology:
    """Pods-of-pods: all-to-all inside each pod; the first agent of each
    pod is a leader, also wired all-to-all with the other leaders."""
    pod_size = max(1, min(pod_size, n))
    leaders = list(range(0, n, pod_size))
    nbrs = []
    for i in range(n):
        pod = i // pod_size
        members = list(range(pod * pod_size, min((pod + 1) * pod_size, n)))
        s = set(members) | {i}
        if i in leaders:
            s |= set(leaders)
        nbrs.append(sorted(s))
    return _from_neighbor_lists(nbrs)


# ---------------------------------------------------------------------
# pod placement of the hierarchical graph (the reference's
# ``topology.py:263-321``)
# ---------------------------------------------------------------------
class PodLayout(NamedTuple):
    """Static agent → pod placement of the ``hierarchical`` topology.

    pod_id:      (n,) int32 — pod of each agent.
    leader_mask: (n,) bool  — True for the one leader of each pod.
    leaders:     (pods,) int32 — the leader agent of each pod.
    pod_size:    agents per pod (uniform).

    Host numpy arrays: the layout decides which mesh axis each edge's
    exchange crosses, so it is fixed when the combine is built."""
    pod_id: np.ndarray
    leader_mask: np.ndarray
    leaders: np.ndarray
    pod_size: int

    @property
    def n_agents(self) -> int:
        return int(self.pod_id.shape[0])

    @property
    def n_pods(self) -> int:
        return int(self.leaders.shape[0])


def hierarchical_layout(n: int, pod_size: int) -> PodLayout:
    """The placement of ``hierarchical(n, pod_size)``: contiguous pods
    of ``pod_size`` agents, the first agent of each pod its leader.
    ``pod_size`` must divide ``n`` (uniform pods)."""
    if pod_size < 1 or n % pod_size:
        raise ValueError(
            f"hierarchical_layout needs pod_size >= 1 dividing "
            f"n_agents, got n={n}, pod_size={pod_size}")
    pod_id = (np.arange(n, dtype=np.int32) // pod_size).astype(np.int32)
    leaders = np.arange(0, n, pod_size, dtype=np.int32)
    leader_mask = np.zeros((n,), bool)
    leader_mask[leaders] = True
    return PodLayout(pod_id=pod_id, leader_mask=leader_mask,
                     leaders=leaders, pod_size=pod_size)


def edge_pod_ids(topo: Topology, layout: PodLayout) -> np.ndarray:
    """(n, k) int32 — the pod of each edge slot's source agent
    (arbitrary where masked out, like ``nbr``)."""
    return np.asarray(layout.pod_id)[np.asarray(topo.nbr)]


def cross_pod_mask(topo: Topology, layout: PodLayout) -> np.ndarray:
    """(n, k) bool — the real edges that cross a pod boundary, the only
    ones whose exchange rides the pod axis."""
    src_pod = edge_pod_ids(topo, layout)
    dst_pod = np.asarray(layout.pod_id)[:, None]
    return np.asarray(topo.mask) & (src_pod != dst_pod)


def hop_distances(topo: Topology) -> np.ndarray:
    """All-pairs directed hop count (``dist[src, dst]``) by BFS over the
    table; raises on a disconnected pair."""
    n = topo.n_agents
    out = [[] for _ in range(n)]
    for dst in range(n):
        for j in range(topo.degree):
            if topo.mask[dst, j]:
                out[int(topo.nbr[dst, j])].append(dst)
    dist = np.full((n, n), -1, np.int64)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in out[u]:
                    if dist[s, v] < 0:
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    if (dist < 0).any():
        bad = np.argwhere(dist < 0)[0]
        raise ValueError(
            f"graph is not strongly connected: no path "
            f"{int(bad[0])}→{int(bad[1])}; hop delays are undefined")
    return dist


def delay_from_hops(topo: Topology, latency: int = 1,
                    graph: Optional[Topology] = None) -> Topology:
    """Each edge of ``topo`` gets delay ``hops(src→dst) · latency``,
    measured on ``graph`` (default: ``topo`` itself)."""
    if latency < 0:
        raise ValueError(f"latency must be >= 0, got {latency}")
    hops = hop_distances(topo if graph is None else graph)
    return topo.with_delay((hops * latency).astype(np.int32))


# ---------------------------------------------------------------------
# dynamic gossip (time-varying random_k)
# ---------------------------------------------------------------------
def round_generator(seed: int, rnd: int, stream: int = 0) -> torch.Generator:
    """A CPU generator seeded by ``(seed, rnd, stream)``: the default
    source of a resample round's draws."""
    state = np.random.SeedSequence(
        [int(seed) % 2 ** 32, int(rnd) % 2 ** 32, stream]).generate_state(
            1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) % 2 ** 63)


def host_f32(x) -> torch.Tensor:
    """A tensor or array → a CPU fp32 tensor of its own (arrays are
    copied: a draw handed in may be read-only)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


def gossip_uniforms(seed: int, rnd: int, n: int) -> torch.Tensor:
    """Round ``rnd``'s (n, n) fp32 uniforms in [0, 1) of a
    ``DynamicTopology`` seeded with ``seed`` (the hook tests replace
    with the reference's draws)."""
    return torch.rand((n, n), generator=round_generator(seed, rnd))


def sample_gossip(u, k: int, alive=None) -> np.ndarray:
    """The k-regular gossip table drawn from the uniforms ``u`` (n, n):
    edge slot 0 of every destination is the self-loop and slots 1..k-1
    are k−1 distinct other agents, the first k−1 columns of a stable
    argsort of each row with the diagonal pushed past every real value
    (``u + 2·eye``). ``alive`` ((n,) bool) then adds 3 to dead columns,
    so a dead source is drawn only once fewer than k−1 live others
    exist. The fp32 sums are the reference's, in its order, so the
    same draws give the same table bit for bit. Returns (n, k) int32."""
    u = host_f32(u)
    n = u.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"sample_gossip needs 1 <= k <= n, got k={k}")
    u = u + 2.0 * torch.eye(n, dtype=torch.float32)
    if alive is not None:
        dead = torch.from_numpy(~np.array(alive, bool)).to(torch.float32)
        u = u + 3.0 * dead[None, :]
    order = torch.argsort(u, dim=1, stable=True).numpy().astype(np.int32)
    return np.concatenate([np.arange(n, dtype=np.int32)[:, None],
                           order[:, :k - 1]], axis=1)


class DynamicTopology(NamedTuple):
    """Time-varying gossip graph: a static ``base`` (the
    ``resample_every = 0`` limit, which also fixes every shape) and the
    resampling schedule. Per-edge annotations cannot survive a resample,
    so delays and relevance ride as dense (n, n) src→dst matrices
    (``dense_delay`` / ``dense_relevance``), gathered onto each fresh
    table; ``None`` means the base's uniform delay / unit relevance."""
    base: Topology
    resample_every: int
    seed: int
    dense_delay: Optional[np.ndarray] = None       # (n, n) src→dst
    dense_relevance: Optional[np.ndarray] = None   # (n, n) src→dst

    @property
    def n_agents(self) -> int:
        return self.base.n_agents

    @property
    def degree(self) -> int:
        return self.base.degree

    @property
    def max_delay(self) -> int:
        if self.dense_delay is not None:
            return int(np.asarray(self.dense_delay).max())
        return self.base.max_delay

    def _uniform_base_delay(self) -> int:
        d = np.asarray(self.base.delay)
        if d.size and not (d == d.flat[0]).all():
            raise ValueError(
                "DynamicTopology needs a uniform base delay or a dense "
                "(n, n) dense_delay matrix — per-edge delays cannot be "
                "re-gathered after a resample")
        return int(d.flat[0]) if d.size else 0

    def with_dense(self, delay=None, relevance=None) -> "DynamicTopology":
        """Attach a scalar or dense (n, n) delay and a dense (n, n)
        relevance, the forms that survive a resample; also attached to
        the base, so the static limit carries them."""
        n = self.n_agents
        out = self
        if delay is not None:
            d = np.asarray(delay)
            if d.ndim == 0:
                out = out._replace(base=out.base.with_delay(delay),
                                   dense_delay=None)
            elif d.shape == (n, n):
                out = out._replace(base=out.base.with_delay(delay),
                                   dense_delay=d.astype(np.int32))
            else:
                raise ValueError(
                    f"dynamic topology delay must be scalar or "
                    f"({n},{n}) dense, got {d.shape}")
        if relevance is not None:
            r = np.asarray(relevance)
            if r.shape != (n, n):
                raise ValueError(
                    f"dynamic topology relevance must be ({n},{n}) "
                    f"dense, got {r.shape}")
            out = out._replace(base=out.base.with_relevance(relevance),
                               dense_relevance=r.astype(np.float32))
        return out

    def round_table(self, epoch: int, alive=None) -> np.ndarray:
        """The gossip table of ``epoch``'s resample round: a function of
        ``(seed, epoch // resample_every, alive)``."""
        n, k = self.base.nbr.shape
        rnd = int(epoch) // self.resample_every
        return sample_gossip(gossip_uniforms(self.seed, rnd, n), k, alive)

    def refresh_table(self, epoch: int, nbr, alive=None) -> np.ndarray:
        """The carried table after ``epoch``: redrawn at round
        boundaries (``epoch % resample_every == 0``), else ``nbr``."""
        if self.resample_every <= 0 or int(epoch) % self.resample_every:
            return nbr
        return self.round_table(epoch, alive)

    def with_table(self, nbr) -> Topology:
        """The epoch's ``Topology`` around a gossip table: all-True mask,
        the dense annotations gathered onto the fresh edges."""
        nbr = np.asarray(nbr, np.int32)
        n, k = nbr.shape
        dst = np.arange(n)[:, None]
        if self.dense_delay is not None:
            delay = np.asarray(self.dense_delay, np.int32)[nbr, dst]
        else:
            delay = np.full((n, k), self._uniform_base_delay(), np.int32)
        if self.dense_relevance is not None:
            rel = np.asarray(self.dense_relevance, np.float32)[nbr, dst]
        else:
            rel = np.ones((n, k), np.float32)
        return Topology(nbr=nbr, mask=np.ones((n, k), bool), delay=delay,
                        relevance=rel)

    def at_epoch(self, epoch: int, alive=None) -> Topology:
        """The graph in force at ``epoch``: the base itself when nothing
        resamples."""
        if self.resample_every <= 0:
            return self.base
        return self.with_table(self.round_table(epoch, alive))


def _torus_dims(n: int):
    """Most-square rows × cols factorisation of n."""
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def make_topology(spec, delay=None, relevance=None):
    """The topology named by a ``GroupSpec`` (``topology``, ``degree``,
    ``topology_seed``), with optional dense or per-edge ``delay`` /
    ``relevance`` overrides attached. With ``resample_every > 0``
    (random_k only) it is a ``DynamicTopology`` carrying dense
    overrides."""
    n = spec.n_agents
    name = spec.topology
    if name == "full":
        topo = full(n)
    elif name == "ring":
        topo = ring(n)
    elif name == "torus2d":
        topo = torus2d(*_torus_dims(n))
    elif name == "star":
        topo = star(n)
    elif name == "random_k":
        topo = random_k(n, spec.degree, spec.topology_seed)
    elif name == "hierarchical":
        topo = hierarchical(n, pod_size=spec.degree)
    else:
        raise ValueError(f"unknown topology {name!r}")
    resample = getattr(spec, "resample_every", 0)
    if resample > 0:
        if name != "random_k":
            raise ValueError(
                f"resample_every > 0 needs topology='random_k', "
                f"got {name!r}")
        return DynamicTopology(
            base=topo, resample_every=resample,
            seed=spec.topology_seed).with_dense(delay=delay,
                                                relevance=relevance)
    if relevance is not None:
        topo = topo.with_relevance(relevance)
    if delay is not None:
        topo = topo.with_delay(delay)
    return topo
