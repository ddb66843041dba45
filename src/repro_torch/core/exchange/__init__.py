"""The exchange-protocol API for DDAL knowledge exchange (port of
``repro.core.exchange``): strategy registries and the protocol that
``repro_torch.core.ddal.DDAL`` loops over."""
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
)

# registers the "none" and "faulty" transport strategies
import repro_torch.core.transport  # noqa: E402,F401
