"""Per-agent synthetic token streams, each agent its own environment,
and a mesh rank's own rows of them (port of ``repro.data``)."""
from repro_torch.data.sharded import (  # noqa: F401
    make_data_batch,
    make_rows_batch,
)
from repro_torch.data.synthetic import (  # noqa: F401
    StreamSpec,
    make_agent_batch,
    make_group_batch,
    markov_table,
    markov_walk,
)
