"""Per-rank batches — the port of ``repro.data.sharded``.

The reference's ``device_put_sharded_batch`` places a global batch on a
mesh so that no host holds all of it. In the port a rank of the pod mesh
builds only its own agents' rows: ``make_rows_batch`` runs
``synthetic.make_agent_batch`` for the agents in ``rows`` (an
``AgentShard``'s ``rows``), and each row is bitwise the same row of
``make_group_batch``'s global batch. On a ``(data, model)`` mesh every
rank holds every agent and its B/d rows of each agent's batch:
``make_data_batch`` cuts them from the group's batch (the reference's
batch spec shards dim 1, after the agent axis, over ``data``). On a
``(pod, data, model)`` mesh a rank builds its pod's agents only and cuts
its data rows from them (``make_data_batch(..., rows=shard.rows)``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.data.synthetic import (StreamSpec, make_agent_batch,
                                        make_group_batch)


def make_rows_batch(cfg, shape, spec: StreamSpec, rows: slice, step: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """Stacked (len(rows), ...) batch of agents ``rows.start ..
    rows.stop − 1`` at ``step``, on ``device`` (``None``: the card)."""
    batches = [make_agent_batch(cfg, shape, spec, a, step, "cpu")
               for a in range(rows.start, rows.stop)]
    dev = resolve_device(device)
    return {k: torch.stack([b[k] for b in batches]).to(dev)
            for k in batches[0]}


def make_data_batch(cfg, shape, spec: StreamSpec, n_agents: int, step: int,
                    mesh, device=None,
                    rows: Optional[slice] = None) -> Dict[str, torch.Tensor]:
    """The calling rank's rows of the group's (n_agents, B, ...) batch at
    ``step`` on a mesh with a ``data`` axis: rows r·B/d .. (r + 1)·B/d −
    1 of every agent, r the rank's data coordinate, d the data axis's
    size, which must divide B. ``rows`` (an ``AgentShard``'s, on a
    ``(pod, data, model)`` mesh) builds only those agents'
    (``make_agent_batch``) before the data rows are cut; each row is
    bitwise the same row of ``make_group_batch``."""
    names = tuple(mesh.mesh_dim_names)
    d = mesh.size(names.index("data"))
    r = mesh.get_local_rank("data")
    B = shape.global_batch
    if B % d:
        raise ValueError(f"a batch of {B} rows does not split over the "
                         f"{d}-rank data axis")
    if rows is None:
        full = make_group_batch(cfg, shape, spec, n_agents, step, "cpu")
    else:
        full = make_rows_batch(cfg, shape, spec, rows, step, "cpu")
    cut = slice(r * B // d, (r + 1) * B // d)
    dev = resolve_device(device)
    return {k: v[:, cut].contiguous().to(dev) for k, v in full.items()}
