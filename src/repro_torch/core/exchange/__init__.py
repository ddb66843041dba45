"""The exchange-protocol API for DDAL knowledge exchange (port of
``repro.core.exchange``): strategy registries, the launcher's
``cli_options`` vocabulary and the protocol that both trainers
(``repro_torch.core.ddal.DDAL``, ``repro_torch.core.sharded_ddal``)
loop over."""
from repro_torch.core.exchange.build import (  # noqa: F401
    ExchangeProtocol,
    build_exchange,
)
from repro_torch.core.exchange.registry import (  # noqa: F401
    COMBINERS,
    DELAYS,
    ESTIMATORS,
    REGISTRIES,
    SCHEDULES,
    TRANSPORTS,
    Registry,
    cli_options,
)

# registers the "none" and "faulty" transport strategies
import repro_torch.core.transport  # noqa: E402,F401
