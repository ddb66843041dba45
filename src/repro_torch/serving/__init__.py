"""Serving (port of ``repro.serving``): the fixed-batch engine over the
model's functional cache, with the shared primitives of
``repro_torch.serving.api``. The continuous and group engines are not
ported."""
from repro_torch.serving.api import (  # noqa: F401
    Sampler,
    ServeConfig,
    StopCriteria,
    build_prefill_batch,
    cli_options,
)
from repro_torch.serving.engine import (  # noqa: F401
    DecodeState,
    ServeEngine,
    serve_batches,
)
