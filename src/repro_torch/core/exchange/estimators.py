"""Relevance estimators — *how much is src's knowledge worth to dst* —
the port of ``repro.core.exchange.estimators`` for the buffer trainer.

``uniform``
    The paper's §6 prior: R ≡ 1, nothing learned, ``observe`` returns
    the state untouched.
``grad_cos``
    Exact pairwise gradient cosines
    (:func:`repro_torch.core.relevance.grad_cosine`) →
    ``to_relevance`` → an EMA over sharing epochs.
``grad_cos+sketch``
    The same on (n, d) sign-JL sketches of the gradients, projected by
    the ``grad_sketch`` CUDA kernel with a seed folded per round from
    ``GroupSpec.topology_seed`` and the epoch, so a replay gives the
    same bits.

Each learning estimator's state is the dense (n, n) ``R[src, dst]`` on
the trainer's device. ``obs_stats`` (observation statistics) waits for
a later slice, and so does the streaming trainer's carried window
sketch (``sketch=`` in the reference's ``observe``).
"""
from __future__ import annotations

import torch

from repro_torch.core import relevance as REL
from repro_torch.core.exchange.registry import ESTIMATORS


@ESTIMATORS.register("uniform")
class UniformEstimator:
    """R ≡ 1; ``observe`` returns the state untouched."""

    learns = False

    @classmethod
    def from_spec(cls, spec) -> "UniformEstimator":
        return cls()

    def init(self, n: int, device=None) -> torch.Tensor:
        return REL.init_relevance(n, device)

    def observe(self, state, **kw):
        return state

    def matrix(self, state) -> torch.Tensor:
        return state


@ESTIMATORS.register("grad_cos")
class GradCosEstimator:
    """Exact pairwise gradient cosines → ``to_relevance`` → EMA."""

    learns = True

    def __init__(self, ema: float):
        self.ema = ema

    @classmethod
    def from_spec(cls, spec) -> "GradCosEstimator":
        return cls(spec.relevance_ema)

    def init(self, n: int, device=None) -> torch.Tensor:
        return REL.init_relevance(n, device)

    def _cosine(self, grads: torch.Tensor, rnd: int) -> torch.Tensor:
        return REL.grad_cosine(grads)

    def observe(self, state: torch.Tensor, *, grads: torch.Tensor,
                rnd: int = 0, enabled: bool = True) -> torch.Tensor:
        # the reference computes the observation on warm-up epochs too
        # and then discards it (``ema_update`` with enabled=False);
        # skipping it gives the same state and spends no card time
        if not enabled:
            return state
        return REL.ema_update(state, REL.to_relevance(
            self._cosine(grads, rnd)), self.ema)

    def matrix(self, state: torch.Tensor) -> torch.Tensor:
        return state


@ESTIMATORS.register("grad_cos+sketch")
class SketchedGradCosEstimator(GradCosEstimator):
    """Gradient cosines on seeded sign-JL sketches: every observed
    epoch streams the gradient rows through that round's projection
    (``fold_seed(seed, rnd)``)."""

    def __init__(self, ema: float, dim: int, seed: int):
        if dim <= 0:
            raise ValueError(
                f"grad_cos+sketch needs relevance_sketch_dim > 0, "
                f"got {dim}")
        super().__init__(ema)
        self.dim = dim
        self.seed = seed

    @classmethod
    def from_spec(cls, spec) -> "SketchedGradCosEstimator":
        return cls(spec.relevance_ema, spec.relevance_sketch_dim,
                   spec.topology_seed)

    def _cosine(self, grads: torch.Tensor, rnd: int) -> torch.Tensor:
        return REL.sketch_cosine(grads, self.dim,
                                 REL.fold_seed(self.seed, rnd))
