"""Per-agent synthetic token streams, each agent its own environment
(port of ``repro.data``; the host-sharded placement of
``repro.data.sharded`` waits for Slice E)."""
from repro_torch.data.synthetic import (  # noqa: F401
    StreamSpec,
    make_agent_batch,
    make_group_batch,
    markov_table,
    markov_walk,
)
