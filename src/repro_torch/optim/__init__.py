"""Functional optimisers and learning-rate schedules over flat agent
rows (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    make_optimizer,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_schedule,
    warmup_cosine,
)
