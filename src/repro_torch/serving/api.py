"""The serving API shared by the engines — the port of
``repro.serving.api``:

* :class:`ServeConfig` — the serving knobs every engine shares;
* :func:`build_prefill_batch`, :func:`decode_batch`,
  :func:`last_logits` — batch dicts of the default family (token ids
  and positions) and the next-token slice;
* :func:`prefill` — batch prefill into a fresh cache → each row's
  next-token logits and the filled cache;
* :class:`Sampler`, :class:`StopCriteria` — greedy / temperature
  sampling and the eos / budget / capacity stop logic;
* :func:`cache_batch_dims` / :func:`splice_cache` — each cache
  leaf's batch dim, and a B = 1 cache written into one slot of the
  continuous-style engines' batch cache;
* ``ENGINE_OPTIONS`` and :func:`cli_options` — the ``--serve
  key=value`` vocabulary, the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models import get_model


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
    prompt's LAST real token. tokens: (B, P); lengths: (B,), a tensor
    or host ints. A dense model's KV cache must hold the P positions
    (``ValueError`` naming ``max_len``, checked from the shape).

    As in the reference, the whole right-padded (B, P) block runs
    through the model: a transformer's KV cache also holds the pad
    tokens of a shorter row (at positions past its length, masked until
    decode overwrites them), and an SSM's state after prefill has
    absorbed them, so that row decodes on from there."""
    B = tokens.shape[0]
    cache = model.make_cache(cfg, B, max_len, device=tokens.device)
    logits, cache = model.forward(cfg, params,
                                  build_prefill_batch(cfg, tokens), cache)
    if not torch.is_tensor(lengths):            # host ints
        lengths = torch.from_numpy(np.asarray(lengths, np.int64))
    idx = torch.clamp(lengths.to(logits.device, torch.long,
                                 non_blocking=True) - 1, min=0)
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


# ---------------------------------------------------------------------
# slot-cache plumbing (continuous-style engines)
# ---------------------------------------------------------------------
def cache_batch_dims(cfg: ArchConfig, max_len: int) -> Any:
    """Nest (matching the cache) of each leaf's batch-dim index, found
    as the reference finds it: the cache's shapes at B = 1 and B = 2
    differ in that dim alone. Both caches are built on the ``meta``
    device, so nothing is allocated. Transformer caches are (L, B,
    ...), and so is the Mamba2 state: every leaf gives 1."""
    model = get_model(cfg)
    s1 = model.make_cache(cfg, 1, max_len, device="meta")
    s2 = model.make_cache(cfg, 2, max_len, device="meta")

    def dim(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"no batch dim in {tuple(a.shape)}")

    return tree_map(dim, s1, s2)


def splice_cache(batch_cache, one_cache, bdims, slot: int):
    """Write a B = 1 cache into batch slot ``slot``: an in-place
    ``copy_`` into ``batch_cache``'s tensors, which it returns.

    Ownership: ``one_cache`` is only read. ``batch_cache`` must belong
    to the caller alone. The engines' does: it is the last decode
    step's output, and every decode builds new cache tensors (the KV
    writes clone, the layers are stacked anew), so no tensor a caller
    handed out is written."""
    def put(buf, one, d):
        buf.select(d, slot).copy_(one.select(d, 0))
        return buf

    return tree_map(put, batch_cache, one_cache, bdims)


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
