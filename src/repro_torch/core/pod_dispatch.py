"""The pod dispatch of hierarchical DDAL — the port of
``repro.core.pod_dispatch``.

The ``hierarchical`` topology is pods-of-pods: dense exchange inside a
pod, leader-to-leader exchange across pods. The flat combine
(``repro_torch.core.sharded_ddal._combine_topo``) reads every agent's
window for every destination; this module splits the edge table by the
mesh axis each edge crosses and runs the two segments apart:

* **intra-pod** — each destination's sum over its pod members, which on
  a two-level ``(pod_axis, "agent")`` mesh gathers the pod's window
  rows over the ``"agent"`` axis only;
* **leader-level** — the cross-pod edges, which connect pod leaders
  only: just each pod's leader planes (tg / rg and the tsum / rsum
  scalars) cross ``pod_axis``, by one ``all_reduce`` when the leader
  clique is complete and unweighted (the leader's own plane subtracted
  back out: it entered through the intra-pod sum) or by one
  point-to-point shift per leader offset otherwise.

Cross-pod traffic per share step is then O(pods · k_leader · |params|)
instead of the flat placement's O(n · k · |params|) (``cross_pod_bytes``
/ ``flat_exchange_bytes``, exact integers, as the reference counts
them; ``relevance_exchange_bytes`` counts the estimator's side).

``make_pod_dispatch`` builds ``combine(know, rel=None, alive=None,
out=None, q_block=0)``. Without a mesh (``_make_reference_dispatch``)
both segments run on one device through ``sharded_ddal``'s
``_edge_weights`` / ``_edge_sums`` / ``_finish_combine``, a column
chunk at a time through ``_eq4`` as ``_combine_topo`` runs, so with one
pod it is ``_combine_topo`` bit for bit. On a mesh
(``_make_sharded_dispatch``) the reference's ``shard_map`` collectives
become ``torch.distributed`` ones on the mesh's groups:

* ``all_gather`` over ``agent_axis`` → ``dist.all_gather`` on
  ``mesh.get_group(agent_axis)``, a column chunk at a time (the int8
  planes and their scales when ``q_block > 0``);
* ``psum`` over ``pod_axis`` → ``dist.all_reduce`` on
  ``mesh.get_group(pod_axis)``;
* the ``ppermute`` rotations → one ``dist.batch_isend_irecv`` of a send
  and a receive per shift, the peers' global ranks from
  ``dist.get_global_rank``;
* ``axis_index`` → ``mesh.get_local_rank(axis)``.

On a ``(pod_axis, "data", "model")`` mesh the reference takes its plain
decomposition, so the one-device dispatch runs on the window's chunks
gathered over ``pod_axis`` and the rank keeps its destination rows
(``_make_reference_dispatch(..., shard)``).

On the two-level mesh each rank returns its block of ``pod_size /
n_agent_dev`` destination rows. Only the ranks whose block holds their pod's leader (one column
of the mesh: the leader is the first agent of every pod) take part in
the leader exchange; the other ranks' rows do not read it. The leader
planes cross the pod axis in the planes' own dtype after the int8 round
trip (fp32 then), not in the int8 wire format that ``cross_pod_bytes``
counts. A dead agent's rows are zeroed before anything crosses a rank,
so a dead leader sends a zero plane.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import NotPortedError
from repro_torch.core import sharded_ddal as SD
from repro_torch.core.topology import PodLayout, Topology, cross_pod_mask


class PodEdges(NamedTuple):
    """The hierarchical edge set split by the mesh axis it crosses.

    intra_mask:  (n, k) bool — edges inside the destination's pod (the
                 slot layout of ``topo.nbr``).
    leader_mask: (n, k) bool — cross-pod edges, leader → leader only.
    ledge:       (pods, pods) bool — leader adjacency ``ledge[src_pod,
                 dst_pod]``, diagonal False (a leader's own plane enters
                 through the intra-pod segment only).
    lslot:       (pods, pods) int32 — the edge slot of the source pod's
                 leader in the destination leader's row (-1: no edge).
    """
    intra_mask: np.ndarray
    leader_mask: np.ndarray
    ledge: np.ndarray
    lslot: np.ndarray


def split_topology(topo: Topology, layout: PodLayout) -> PodEdges:
    """The edge table split into the intra-pod and the leader-level set.
    Raises if a cross-pod edge is not leader → leader: such a graph has
    no two-level placement."""
    n, k = np.asarray(topo.nbr).shape
    if layout.n_agents != n:
        raise ValueError(
            f"layout covers {layout.n_agents} agents, topology has {n}")
    nbr = np.asarray(topo.nbr)
    mask = np.asarray(topo.mask)
    cross = cross_pod_mask(topo, layout)
    intra = mask & ~cross
    is_leader = np.asarray(layout.leader_mask)
    bad = cross & ~(is_leader[nbr] & is_leader[:, None])
    if bad.any():
        dst, slot = np.argwhere(bad)[0]
        raise ValueError(
            f"cross-pod edge {int(nbr[dst, slot])}→{int(dst)} does not "
            f"connect two pod leaders — the topology cannot be "
            f"pod-dispatched (only leader planes may cross the pod "
            f"axis)")
    pods = layout.n_pods
    pod_id = np.asarray(layout.pod_id)
    ledge = np.zeros((pods, pods), bool)
    lslot = np.full((pods, pods), -1, np.int32)
    for dst, slot in np.argwhere(cross):
        sp, dp = int(pod_id[nbr[dst, slot]]), int(pod_id[dst])
        ledge[sp, dp] = True
        lslot[sp, dp] = slot
    return PodEdges(intra_mask=intra, leader_mask=cross, ledge=ledge,
                    lslot=lslot)


# ---------------------------------------------------------------------
# traffic accounting (host integers, the reference's counts)
# ---------------------------------------------------------------------
def _edge_cost(n_params: int, dtype_bytes: int,
               quant_block: int = 0) -> int:
    """Bytes one directed edge moves per share step: the source's two
    planes (tg, rg) and the (tsum, rsum) scalars; with ``quant_block >
    0`` each plane is int8 plus one fp32 scale per block."""
    if quant_block > 0:
        plane = n_params + (-(-n_params // quant_block)) * 4
    else:
        plane = n_params * dtype_bytes
    return 2 * plane + 2 * 4


def cross_pod_bytes(edges: PodEdges, n_params: int,
                    dtype_bytes: int = 4, quant_block: int = 0) -> int:
    """Cross-pod bytes per share step of the dispatched combine: the
    directed leader edges only, O(pods · k_leader · |params|)."""
    return int(edges.ledge.sum()) * _edge_cost(n_params, dtype_bytes,
                                               quant_block)


def relevance_exchange_bytes(n_agents: int, n_params: int,
                             sketch_dim: int,
                             dtype_bytes: int = 4) -> int:
    """Bytes the learned-relevance observation gathers per share step:
    every agent's parameter-sized ``rg`` row for exact ``grad_cos``, its
    (d,) sketch row with ``relevance_sketch_dim > 0``."""
    per_row = n_params if sketch_dim <= 0 else sketch_dim
    return n_agents * per_row * dtype_bytes


def flat_exchange_bytes(topo: Topology, n_params: int,
                        dtype_bytes: int = 4, quant_block: int = 0) -> int:
    """What the flat combine moves between devices: every non-self
    edge's source planes, O(n · k · |params|)."""
    nbr = np.asarray(topo.nbr)
    mask = np.asarray(topo.mask)
    self_edge = nbr == np.arange(nbr.shape[0])[:, None]
    return int((mask & ~self_edge).sum()) * _edge_cost(
        n_params, dtype_bytes, quant_block)


# ---------------------------------------------------------------------
# the dispatched combine
# ---------------------------------------------------------------------
def make_pod_dispatch(topo: Topology, layout: PodLayout, *, mesh=None,
                      pod_axis: str = "pod", agent_axis: str = "agent"):
    """``combine(know, rel=None, alive=None, out=None, q_block=0) -> ḡ``
    for a hierarchical topology placed on pods. ``rel`` overrides the
    topology's per-edge relevance (the learned path; a device tensor);
    ``alive`` ((n,) bool, the group's) zeroes dead agents' rows before
    either segment; ``q_block > 0`` takes the planes through the int8
    round trip; ``out`` receives ḡ. With ``mesh`` (``(pod_axis,
    agent_axis)``) ``know``, ``out`` and the result are the rank's rows.
    On a ``(pod_axis, "data", "model")`` mesh the reference takes its
    plain decomposition (its ``shard_map`` needs an ``"agent"`` axis)
    and GSPMD turns the agent sums into collectives over ``pod``: here
    the one-device dispatch runs on the window's chunks gathered over
    ``pod_axis`` (the int8 codes and scales when ``q_block > 0``), on
    the rank's model-axis slices, and the rank keeps its destination
    rows. A ``(data, model)`` mesh raises ``NotPortedError`` (it places
    no agents: its trainer dispatches on one device)."""
    edges = split_topology(topo, layout)
    kind = SD.mesh_kind(mesh, pod_axis, agent_axis)
    if kind == "pod":
        return _make_sharded_dispatch(topo, layout, edges, mesh, pod_axis,
                                      agent_axis)
    if kind == "model":
        raise NotPortedError(
            f"the pod dispatch places agents on the ({pod_axis!r}, "
            f"{agent_axis!r}) or the ({pod_axis!r}, 'data', 'model') "
            f"mesh; a (data, model) mesh places none (its trainer "
            f"dispatches on one device: mesh=None)")
    shard = (None if kind is None
             else SD.agent_shard(mesh, layout.n_agents, pod_axis))
    return _make_reference_dispatch(topo, layout, edges, shard)


def _masked(rel: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, rel, torch.zeros((), dtype=rel.dtype,
                                              device=rel.device))


def _edge_rel(topo: Topology, rel, device) -> torch.Tensor:
    if rel is None:
        rel = topo.relevance
    return torch.as_tensor(rel, dtype=torch.float32, device=device)


def _make_reference_dispatch(topo: Topology, layout: PodLayout,
                             edges: PodEdges, shard=None):
    """The decomposed combine on one device: the intra-pod edge sums
    plus, with more than one pod, the leader-level ones (added after
    them), then ``_finish_combine``. With one pod the intra set is the
    whole edge set, and this is ``_combine_topo``. ``shard`` (an
    ``AgentShard`` of the ``(pod, data, model)`` mesh) makes it the
    flat combine's mesh form: ``know`` holds the rank's rows, each
    chunk is gathered over the shard's group and the rank keeps its
    rows of ḡ."""
    multi_pod = layout.n_pods > 1

    def combine(know, rel=None, alive=None, out=None, q_block: int = 0):
        dev = know.tsum.device
        nbr, _, _ = SD.topo_tables(topo, dev)
        rel = _edge_rel(topo, rel, dev)
        know_g, local, kw = SD._sharded(know, alive, shard)
        intra = torch.as_tensor(edges.intra_mask, device=dev)
        rel_i = _masked(rel, intra)
        w_i = SD._edge_weights(know_g, nbr, intra, rel_i, alive)
        if multi_pod:
            lead = torch.as_tensor(edges.leader_mask, device=dev)
            rel_l = _masked(rel, lead)
            w_l = SD._edge_weights(know_g, nbr, lead, rel_l, alive)

        def fold(tg, rg):
            chunk = know_g._replace(tg=tg, rg=rg)
            tnum, tden, rnum, rden = SD._edge_sums(chunk, nbr, intra, rel_i,
                                                   w_i)
            if multi_pod:
                lt, ltd, lr, lrd = SD._edge_sums(chunk, nbr, lead, rel_l,
                                                 w_l)
                tnum, rnum = tnum + lt, rnum + lr
                tden, rden = tden + ltd, rden + lrd
            return SD._finish_combine(tnum, tden, rnum, rden)
        return SD._eq4(know, fold, out, local, q_block, **kw)

    return combine


def _make_sharded_dispatch(topo: Topology, layout: PodLayout,
                           edges: PodEdges, mesh, pod_axis: str,
                           agent_axis: str):
    """The decomposed combine over ``torch.distributed`` on a two-level
    mesh. Placement contract (checked, the reference's messages):
    agents lie pod-major over ``(pod_axis, agent_axis)``, pods map 1:1
    onto the pod axis, and the pod size divides over the agent axis."""
    import torch.distributed as dist

    pods, pod_size = layout.n_pods, layout.pod_size
    n_pod_dev, n_agent_dev = SD.mesh_axes(mesh, pod_axis, agent_axis)
    if pods != n_pod_dev:
        raise ValueError(
            f"topology has {pods} pods but mesh axis "
            f"{pod_axis!r} has {n_pod_dev} devices — pods must map "
            f"1:1 onto the pod axis")
    if pod_size % n_agent_dev:
        raise ValueError(
            f"pod size {pod_size} does not divide over the "
            f"{n_agent_dev}-device {agent_axis!r} axis")
    shard = SD.agent_shard(mesh, layout.n_agents, pod_axis)
    blk = pod_size // n_agent_dev
    k = topo.degree
    p = mesh.get_local_rank(pod_axis)
    a = mesh.get_local_rank(agent_axis)

    # the pod's intra edge table, sources renumbered within the pod
    # (indices into the gathered pod rows)
    nbr_g = np.asarray(topo.nbr).reshape(pods, pod_size, k)
    intra_p = np.asarray(edges.intra_mask).reshape(pods, pod_size, k)
    nbr_local = np.where(intra_p,
                         nbr_g - np.arange(pods)[:, None, None] * pod_size, 0)
    if ((nbr_local < 0) | (nbr_local >= pod_size)).any():
        raise ValueError("intra-pod edge escapes its pod — layout and "
                         "topology disagree")
    leader_local = (np.asarray(layout.leaders)
                    - np.arange(pods) * pod_size).astype(np.int64)
    lead_cols = set((leader_local // blk).tolist())
    if pods > 1 and len(lead_cols) != 1:
        raise ValueError(
            f"the pods' leaders sit in agent-axis columns "
            f"{sorted(lead_cols)}; the leader exchange needs them in one")
    complete = pods > 1 and bool(edges.ledge.sum() == pods * (pods - 1))
    rel_static = np.asarray(topo.relevance)
    uniform_leaders = bool(np.all(
        rel_static[np.asarray(edges.leader_mask)] == 1.0))
    lidx = int(leader_local[p])
    exchanges = pods > 1 and lead_cols == {a}
    agent_group = mesh.get_group(agent_axis)
    pod_group = mesh.get_group(pod_axis)
    peers = [dist.get_global_rank(pod_group, q) for q in range(pods)]
    pod_rows = slice(p * pod_size, (p + 1) * pod_size)
    own_rows = slice(a * blk, (a + 1) * blk)

    def gather(x):
        return SD.gather_rows(x, n_agent_dev, agent_group)

    def shift(x, s):
        """Pod q's ``x`` to pod q + s: returns what pod p − s sent."""
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, peers[(p + s) % pods], pod_group),
               dist.P2POp(dist.irecv, got, peers[(p - s) % pods], pod_group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def leader_terms(own, fast, weights):
        """The leader row's cross-pod sums of ``own`` ((2, ...): the T
        and the R part of the leader's own plane or scalars):
        ``weights[s]`` = (mask, relevance) of shift s's edge."""
        if fast:
            tot = own.clone()
            dist.all_reduce(tot, group=pod_group)
            return tot - own
        acc = torch.zeros(own.shape, dtype=torch.float32, device=own.device)
        for s in range(1, pods):
            got = shift(own.contiguous(), s).to(torch.float32)
            e, w = weights[s]
            acc[0] += e * got[0]
            acc[1] += w * got[1]
        return acc

    def combine(know, rel=None, alive=None, out=None, q_block: int = 0):
        # the psum fast path assumes unweighted leader edges: the static
        # table can prove that, an override cannot
        fast = complete and uniform_leaders and rel is None
        dev = know.tsum.device
        rel_p = _edge_rel(topo, rel, dev)[pod_rows]
        nbr_l = torch.as_tensor(nbr_local[p], dtype=torch.int64, device=dev)
        mask_l = torch.as_tensor(intra_p[p], device=dev)
        rel_l = _masked(rel_p, mask_l)
        local = None if alive is None else alive[shard.rows]
        tsum, rsum = SD._scalars(know, local)
        pod = know._replace(tsum=gather(tsum), rsum=gather(rsum))
        M, tden, Rd, rden = SD._edge_weights(pod, nbr_l, mask_l, rel_l)
        weights = {}
        if exchanges:
            for s in range(1, pods):
                src = (p - s) % pods
                e = float(edges.ledge[src, p])
                slot = max(int(edges.lslot[src, p]), 0)
                weights[s] = (e, e * rel_p[lidx, slot])
            xs = leader_terms(torch.stack([pod.tsum[lidx], pod.rsum[lidx]]),
                              fast, weights)
            tden, rden = tden.clone(), rden.clone()
            tden[lidx] += xs[0]
            rden[lidx] += xs[1]
        sums = (M, tden, Rd, rden)

        def fold(tg, rg):
            chunk = pod._replace(tg=tg, rg=rg)
            tnum, _, rnum, _ = SD._edge_sums(chunk, nbr_l, mask_l, rel_l,
                                             sums)
            if exchanges:
                x = leader_terms(torch.stack([tg[lidx], rg[lidx]]), fast,
                                 weights)
                tnum[lidx] += x[0]
                rnum[lidx] += x[1]
            return SD._finish_combine(tnum, tden, rnum, rden)
        return SD._eq4(know, fold, out, local, q_block, gather, own_rows)

    return combine
