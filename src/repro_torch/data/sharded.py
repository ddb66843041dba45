"""Per-rank batches — the port of ``repro.data.sharded``.

The reference's ``device_put_sharded_batch`` places a global batch on a
mesh so that no host holds all of it. In the port a rank of the pod mesh
builds only its own agents' rows: ``make_rows_batch`` runs
``synthetic.make_agent_batch`` for the agents in ``rows`` (an
``AgentShard``'s ``rows``), and each row is bitwise the same row of
``make_group_batch``'s global batch.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.device import resolve_device
from repro_torch.data.synthetic import StreamSpec, make_agent_batch


def make_rows_batch(cfg, shape, spec: StreamSpec, rows: slice, step: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """Stacked (len(rows), ...) batch of agents ``rows.start ..
    rows.stop − 1`` at ``step``, on ``device`` (``None``: the card)."""
    batches = [make_agent_batch(cfg, shape, spec, a, step, "cpu")
               for a in range(rows.start, rows.stop)]
    dev = resolve_device(device)
    return {k: torch.stack([b[k] for b in batches]).to(dev)
            for k in batches[0]}
