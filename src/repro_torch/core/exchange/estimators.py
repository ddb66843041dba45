"""Relevance estimators — *how much is src's knowledge worth to dst*.
The port has the ``uniform`` estimator of
``repro.core.exchange.estimators`` (the paper's §6 prior, R ≡ 1); the
learning estimators wait for a later slice."""
from __future__ import annotations

import torch

from repro_torch.core.exchange.registry import ESTIMATORS


@ESTIMATORS.register("uniform")
class UniformEstimator:
    """R ≡ 1; ``observe`` returns the state untouched."""

    def init(self, n: int, device=None) -> torch.Tensor:
        return torch.ones((n, n), dtype=torch.float32, device=device)

    def observe(self, state, **kw):
        return state

    def matrix(self, state) -> torch.Tensor:
        return state
