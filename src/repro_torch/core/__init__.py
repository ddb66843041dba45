"""DDAL (paper §5): knowledge stores, eq. 4 weighting, delay lines,
topologies and the exchange protocol (port of ``repro.core``). The pod
placement and the pod dispatch are exported here, as the reference
exports them."""
from repro_torch.core.pod_dispatch import (  # noqa: F401
    PodEdges,
    cross_pod_bytes,
    flat_exchange_bytes,
    make_pod_dispatch,
    relevance_exchange_bytes,
    split_topology,
)
from repro_torch.core.topology import (  # noqa: F401
    PodLayout,
    cross_pod_mask,
    edge_pod_ids,
    hierarchical,
    hierarchical_layout,
)
