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

``obs_stats``
    Observation-statistics relevance: per-agent running observation
    moments, streamed from the agents' episodes
    (:func:`repro_torch.rl.rollout.obs_moments`, ``metrics
    ["obs_moments"]``) and merged by Chan's parallel rule, feed
    :func:`repro_torch.core.relevance.obs_overlap`, EMA-smoothed.

The gradient estimators' state is the dense (n, n) ``R[src, dst]`` on
the trainer's device, ``obs_stats``'s an :class:`ObsStatsState`. Every
``observe`` takes ``alive`` ((n,) bool on the device, elastic
membership): entries touching a dead agent hold.

The streaming trainer (``repro_torch.core.sharded_ddal``) observes its
window-accumulated gradients, a tree of stacked leaves, and a sketched
estimator carries the window's (n, d) sketch instead: every
accumulation step adds ``sketch_step(grads, rnd)`` (one ``grad_sketch``
launch per leaf, seed ``fold_seed(seed, rnd)``) and the share step's
``observe(sketch=...)`` takes ``cosine_rows`` of it (the reference's
``estimators.py:154-172``). ``sketch_dim`` is 0 for every estimator
that does not sketch. On a pod mesh the exchange protocol gathers
the sketch rows before ``observe``, and hands exact ``grad_cos`` a
``gather`` that collects the window's rows a column chunk at a time; on
a ``(data, model)`` mesh it hands them the rank's ``ModelShards``
(partial sketches and cosines, summed over the model axis); on a
``(pod, data, model)`` mesh the gather (over ``pod``) and the
``ModelShards`` together.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import relevance as REL
from repro_torch.core.exchange.registry import ESTIMATORS


@ESTIMATORS.register("uniform")
class UniformEstimator:
    """R ≡ 1; ``observe`` returns the state untouched."""

    learns = False
    wants_obs = False
    sketch_dim = 0

    @classmethod
    def from_spec(cls, spec, obs_dim=None) -> "UniformEstimator":
        return cls()

    def init(self, n: int, device=None) -> torch.Tensor:
        return REL.init_relevance(n, device)

    def observe(self, state, **kw):
        return state

    def matrix(self, state) -> torch.Tensor:
        return state

    def sketch_step(self, grads, rnd, shards=None):
        return None


@ESTIMATORS.register(
    "grad_cos", params={"relevance_ema": ("relevance_ema", float)})
class GradCosEstimator:
    """Exact pairwise gradient cosines → ``to_relevance`` → EMA."""

    learns = True
    wants_obs = False
    sketch_dim = 0

    def __init__(self, ema: float):
        self.ema = ema

    @classmethod
    def from_spec(cls, spec, obs_dim=None) -> "GradCosEstimator":
        return cls(spec.relevance_ema)

    def init(self, n: int, device=None) -> torch.Tensor:
        return REL.init_relevance(n, device)

    def _cosine(self, grads: torch.Tensor, rnd: int) -> torch.Tensor:
        return REL.grad_cosine(grads)

    def observe(self, state: torch.Tensor, *, grads=None, sketch=None,
                aux=None, rnd: int = 0, enabled: bool = True,
                alive=None, gather=None, shards=None) -> torch.Tensor:
        # the reference computes the observation on warm-up epochs too
        # and then discards it (``ema_update`` with enabled=False);
        # skipping it gives the same state and spends no card time
        del aux
        if not enabled:
            return state
        if gather is not None or shards is not None:
            # a mesh: the rank's rows, or its slices, of the window
            obs = REL.grad_cosine(grads, gather=gather, shards=shards)
        else:
            obs = self._observation(grads, sketch, rnd)
        return REL.ema_update(state, REL.to_relevance(obs), self.ema,
                              alive=alive)

    def _observation(self, grads, sketch, rnd: int) -> torch.Tensor:
        del sketch
        return self._cosine(grads, rnd)

    def matrix(self, state: torch.Tensor) -> torch.Tensor:
        return state

    def sketch_step(self, grads, rnd, shards=None):
        return None


@ESTIMATORS.register(
    "grad_cos+sketch",
    params={"relevance_sketch_dim": ("relevance_sketch_dim", int)})
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
        self.sketch_dim = dim

    @classmethod
    def from_spec(cls, spec, obs_dim=None) -> "SketchedGradCosEstimator":
        return cls(spec.relevance_ema, spec.relevance_sketch_dim,
                   spec.topology_seed)

    def _cosine(self, grads: torch.Tensor, rnd: int) -> torch.Tensor:
        return REL.sketch_cosine(grads, self.dim,
                                 REL.fold_seed(self.seed, rnd))

    def _observation(self, grads, sketch, rnd: int) -> torch.Tensor:
        if sketch is not None:
            return REL.cosine_rows(sketch)
        return self._cosine(grads, rnd)

    def sketch_step(self, grads, rnd: int, shards=None) -> torch.Tensor:
        """This step's (n, d) contribution to the window sketch: the
        tree of stacked gradients through round ``rnd``'s projection,
        one kernel launch per leaf (with ``shards``, per leaf the rank
        owns: its partial sketch)."""
        from repro_torch.kernels.grad_sketch import ops as sketch_ops
        return sketch_ops.sketch_pytree(grads, REL.fold_seed(self.seed, rnd),
                                        self.dim, shards=shards)


class ObsStatsState(NamedTuple):
    """Running per-agent observation moments and the derived relevance.

    count: (n,)    — observations accumulated so far.
    mean:  (n, d)  — running mean observation.
    m2:    (n,)    — running sum of squared deviations (isotropic), so
                     the scale is sqrt(m2 / (count·d)).
    rel:   (n, n)  — EMA of the Gaussian-overlap relevance.
    """
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    rel: torch.Tensor


@ESTIMATORS.register("obs_stats")
class ObsStatsEstimator:
    """Relevance from observation-distribution overlap. ``aux`` is the
    episode moment triple ``(obs_sum (n, d), sq_sum (n,), count (n,))``;
    with no ``aux`` the state holds. Every op stays on the device: the
    "any agent observed" gates are device selects, as in the
    reference."""

    learns = True
    wants_obs = True
    sketch_dim = 0

    def __init__(self, ema: float, obs_dim: Optional[int]):
        if obs_dim is None:
            raise ValueError(
                "obs_stats needs the observation dimension: pass "
                "obs_dim= to build_exchange (the rl group entry "
                "points forward env.obs_dim automatically)")
        self.ema = ema
        self.obs_dim = int(obs_dim)

    @classmethod
    def from_spec(cls, spec, obs_dim=None) -> "ObsStatsEstimator":
        return cls(spec.relevance_ema, obs_dim)

    def init(self, n: int, device=None) -> ObsStatsState:
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return ObsStatsState(count=z(n), mean=z(n, self.obs_dim), m2=z(n),
                             rel=REL.init_relevance(n, device))

    def observe(self, state: ObsStatsState, *, grads=None, sketch=None,
                aux=None, rnd: int = 0, enabled: bool = True,
                alive=None) -> ObsStatsState:
        del grads, sketch, rnd
        if aux is None:
            return state
        obs_sum, sq_sum, cnt = (x.to(torch.float32) for x in aux)
        if alive is not None:
            # a corpse streams no observations: a zero batch count makes
            # the Chan merge hold its running moments verbatim
            cnt = torch.where(alive, cnt, 0.0)
            obs_sum = torch.where(alive[:, None], obs_sum, 0.0)
            sq_sum = torch.where(alive, sq_sum, 0.0)
        safe = torch.clamp_min(cnt, 1.0)
        batch_mean = obs_sum / safe[:, None]                  # (n, d)
        batch_m2 = sq_sum - torch.sum(batch_mean * obs_sum, dim=1)
        tot = state.count + cnt
        tot_safe = torch.clamp_min(tot, 1.0)
        delta = batch_mean - state.mean
        mean = state.mean + delta * (cnt / tot_safe)[:, None]
        m2 = (state.m2 + batch_m2
              + torch.sum(delta * delta, dim=1) * state.count * cnt
              / tot_safe)
        scale = torch.sqrt(torch.clamp_min(m2, 0.0)
                           / (tot_safe * self.obs_dim))
        obs = REL.obs_overlap(mean, scale)
        enabled = torch.as_tensor(enabled, device=tot.device)
        rel = REL.ema_update(state.rel, obs, self.ema,
                             enabled & torch.any(tot > 0), alive)
        new = ObsStatsState(count=tot, mean=mean, m2=m2, rel=rel)
        any_obs = torch.any(cnt > 0)               # else hold everything
        return ObsStatsState(*(torch.where(any_obs, x, old)
                               for x, old in zip(new, state)))

    def matrix(self, state: ObsStatsState) -> torch.Tensor:
        return state.rel

    def sketch_step(self, grads, rnd, shards=None):
        return None
