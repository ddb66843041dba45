"""Agent placement on the pod mesh — the agent-axis half of the port of
``repro.launch.shardings``.

The reference shards dim 0 of every per-agent leaf of a ``TrainState``
over ``ddal_agent_axis(mesh)``. Here that becomes: each rank keeps its
contiguous, pod-major block of the agents (``sharded_ddal.AgentShard``)
of every leaf with a leading agent axis — the parameters, the AdamW
moments and step counts, the window's ``tg`` / ``rg`` / ``tsum`` /
``rsum`` and sketch ``sk`` — while ``rel``, ``alive`` and ``step`` stay
global (every rank holds the group's). ``gather_agent_state`` is the
inverse, for checkpoints and tests. The parameter partition specs and
the cache / batch rules of the production meshes wait for Slice E
part 2.
"""
from __future__ import annotations

from typing import Union

from repro_torch.common.pytree import tree_map

Axis = Union[None, str, tuple]


def ddal_agent_axis(mesh, pod_axis: str = "pod") -> Axis:
    """The mesh axes the agent dim lies over: both levels of the pod mesh
    (agents pod-major), ``pod_axis`` alone on a one-level mesh, else
    ``None``."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ()
                  ) if mesh is not None else ()
    if pod_axis in names and "agent" in names:
        return (pod_axis, "agent")
    if pod_axis in names:
        return pod_axis
    return None


def _map_agent_leaves(state, fn):
    """``fn`` over every per-agent leaf of a streaming ``TrainState``
    (params, optimiser state, the window's tg / tsum / rg / rsum / sk);
    ``rel``, ``alive`` and ``step`` as they are."""
    know = state.know
    return state._replace(
        params=tree_map(fn, state.params),
        opt_state=tree_map(fn, state.opt_state),
        know=know._replace(
            tg=tree_map(fn, know.tg), rg=tree_map(fn, know.rg),
            tsum=fn(know.tsum), rsum=fn(know.rsum),
            sk=None if know.sk is None else fn(know.sk)))


def agent_sharded_state(state, mesh, pod_axis: str = "pod"):
    """The calling rank's part of a group's ``TrainState`` on ``mesh``:
    its block of rows of every per-agent leaf (each a tensor of its
    own), the global ``rel``, ``alive`` and step. ``mesh=None`` returns
    ``state``."""
    if ddal_agent_axis(mesh, pod_axis) is None:
        return state
    from repro_torch.core.sharded_ddal import agent_shard
    n = state.know.tsum.shape[0]
    rows = agent_shard(mesh, n, pod_axis).rows
    return _map_agent_leaves(state, lambda x: x[rows].clone())


def gather_agent_state(state, mesh, pod_axis: str = "pod"):
    """The inverse of ``agent_sharded_state``: every rank's rows gathered
    into the group's ``TrainState`` on every rank (a collective: all
    ranks call it)."""
    if ddal_agent_axis(mesh, pod_axis) is None:
        return state
    from repro_torch.core.sharded_ddal import agent_shard
    n = state.know.tsum.shape[0] * mesh.size()
    shard = agent_shard(mesh, n, pod_axis)
    return _map_agent_leaves(state, shard.gather)
