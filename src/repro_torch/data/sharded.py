"""Per-rank batches — the port of ``repro.data.sharded``.

The reference's ``device_put_sharded_batch`` places a global batch on a
mesh so that no host holds all of it. In the port a rank of the pod mesh
builds only its own agents' rows: ``make_rows_batch`` runs
``synthetic.make_agent_batch`` for the agents in ``rows`` (an
``AgentShard``'s ``rows``), and each row is bitwise the same row of
``make_group_batch``'s global batch. On a ``(data, model)`` mesh every
rank holds every agent and its B/d rows of each agent's batch:
``make_data_batch`` cuts them from the group's batch (the reference's
batch spec shards dim 1, after the agent axis, over ``data``).
"""
from __future__ import annotations

from typing import Dict

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
                    mesh, device=None) -> Dict[str, torch.Tensor]:
    """The calling rank's rows of the group's (n_agents, B, ...) batch at
    ``step`` on a ``(data, model)`` mesh: rows r·B/d .. (r + 1)·B/d − 1 of
    every agent, r the rank's data coordinate, d the data axis's size,
    which must divide B."""
    d = mesh.size(mesh.mesh_dim_names.index("data"))
    r = mesh.get_local_rank("data")
    B = shape.global_batch
    if B % d:
        raise ValueError(f"a batch of {B} rows does not split over the "
                         f"{d}-rank data axis")
    full = make_group_batch(cfg, shape, spec, n_agents, step, "cpu")
    rows = slice(r * B // d, (r + 1) * B // d)
    dev = resolve_device(device)
    return {k: v[:, rows].contiguous().to(dev) for k, v in full.items()}
