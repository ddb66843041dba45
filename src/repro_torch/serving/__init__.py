"""Serving (port of ``repro.serving``): batched prefill + decode over
the model's functional caches (``repro_torch.serving.engine``),
continuous batching (``repro_torch.serving.continuous``) and
multi-tenant group serving of every agent's policy
(``repro_torch.serving.group``) with train→serve hot-swap and request
metrics (``repro_torch.serving.metrics``). Shared primitives live in
``repro_torch.serving.api``."""
from repro_torch.serving.api import (  # noqa: F401
    Sampler,
    ServeConfig,
    StopCriteria,
    build_prefill_batch,
    cli_options,
)
from repro_torch.serving.continuous import ContinuousBatcher  # noqa: F401
from repro_torch.serving.engine import (  # noqa: F401
    DecodeState,
    ServeEngine,
    serve_batches,
)
from repro_torch.serving.group import (  # noqa: F401
    GroupRequest,
    GroupServeEngine,
    ParamStore,
    Router,
    publish_from_trainer,
)
from repro_torch.serving.metrics import ServeMetrics  # noqa: F401
