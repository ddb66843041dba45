"""The serving API shared by the engines — the port of
``repro.serving.api`` for the fixed-batch engine:

* :class:`ServeConfig` — the serving knobs every engine shares;
* :func:`build_prefill_batch`, :func:`decode_batch`,
  :func:`last_logits` — batch dicts of the default family (token ids
  and positions) and the next-token slice;
* :func:`prefill` — batch prefill into a fresh cache → each row's
  next-token logits and the filled cache;
* :class:`Sampler`, :class:`StopCriteria` — greedy / temperature
  sampling and the eos / budget / capacity stop logic;
* ``ENGINE_OPTIONS`` and :func:`cli_options` — the ``--serve
  key=value`` vocabulary, the reference's.

The continuous-batching slot plumbing (``cache_batch_dims``,
``splice_cache``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512           # cache capacity
    max_new_tokens: int = 64
    temperature: float = 0.0     # 0 → greedy
    eos_id: int = -1             # -1 → never stops early


def decode_batch(cfg: ArchConfig, tokens: torch.Tensor,
                 positions: torch.Tensor) -> Dict[str, Any]:
    """Wrap a (B, 1) token into the decode-batch dict."""
    return {"tokens": tokens, "positions": positions}


def last_logits(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """(B, V) next-token logits from a decode/prefill output."""
    return logits[:, -1, :]


def build_prefill_batch(cfg: ArchConfig, tokens: torch.Tensor
                        ) -> Dict[str, Any]:
    """(B, P) right-padded prompt ids → the prefill batch."""
    B, P = tokens.shape
    pos = torch.arange(P, dtype=torch.int32,
                       device=tokens.device).expand(B, P)
    return {"tokens": tokens, "positions": pos}


def prefill(cfg: ArchConfig, model, params, tokens: torch.Tensor,
            lengths: torch.Tensor, max_len: int) -> Tuple[torch.Tensor, Any]:
    """Prefill a fresh B-slot cache; next-token logits come from each
    prompt's LAST real token. tokens: (B, P); lengths: (B,).

    As in the reference, the whole right-padded (B, P) block runs
    through the model: a transformer's KV cache also holds the pad
    tokens of a shorter row (at positions past its length, masked until
    decode overwrites them), and an SSM's state after prefill has
    absorbed them, so that row decodes on from there."""
    B = tokens.shape[0]
    cache = model.make_cache(cfg, B, max_len, device=tokens.device)
    logits, cache = model.forward(cfg, params,
                                  build_prefill_batch(cfg, tokens), cache)
    idx = torch.clamp(lengths.long() - 1, min=0)
    nxt = logits[torch.arange(B, device=logits.device), idx, :]
    return nxt, cache


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Greedy (temperature ≤ 0) or temperature sampling over the last
    axis of (B, V) logits. Sampling draws from the explicit
    ``generator``; it gives the reference's distribution, not its
    bits."""
    temperature: float = 0.0

    def __call__(self, logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if generator is None:
            raise ValueError("temperature sampling needs a generator")
        probs = torch.softmax(logits.to(torch.float32) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)


@dataclasses.dataclass(frozen=True)
class StopCriteria:
    """When a slot's generation ends: eos, token budget, or cache
    capacity (pos is the post-increment next absolute position)."""
    eos_id: int = -1
    max_new_tokens: int = 64
    max_len: int = 512

    @classmethod
    def from_serve(cls, serve: ServeConfig) -> "StopCriteria":
        return cls(eos_id=serve.eos_id,
                   max_new_tokens=serve.max_new_tokens,
                   max_len=serve.max_len)

    def eos_done(self, next_tok: torch.Tensor) -> torch.Tensor:
        """The done contribution of one sampled token."""
        return next_tok == self.eos_id

    def should_stop(self, n_generated: int, token: int, pos: int) -> bool:
        """Host-side per-slot verdict after appending ``token`` as the
        ``n_generated``-th output, with the slot's next position at
        ``pos``."""
        return (token == self.eos_id
                or n_generated >= self.max_new_tokens
                or pos >= self.max_len - 1)


# engine-level knobs that live outside ServeConfig; the launcher maps
# them onto engine constructor / mode selection
ENGINE_OPTIONS: Dict[str, type] = {
    "engine": str,        # batch | continuous | group
    "slots": int,         # continuous/group batch slots
    "prompt_pad": int,    # prompt padding granularity
    "agents": int,        # group mode: tenants sharing the mesh
    "router": str,        # group mode: fifo | fair
}


def cli_options() -> Dict[str, Tuple[str, type]]:
    """The full ``--serve key=value`` vocabulary: every
    :class:`ServeConfig` field plus the engine-level knobs, each mapped
    to ``(field, type)``."""
    opts = {f.name: (f.name, type(f.default))
            for f in dataclasses.fields(ServeConfig)}
    opts.update({k: (k, t) for k, t in ENGINE_OPTIONS.items()})
    return opts
