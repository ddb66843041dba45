"""The serving API shared by the engines — the port of
``repro.serving.api``:

* :class:`ServeConfig` — the serving knobs every engine shares;
* :func:`build_prefill_batch`, :func:`decode_batch`,
  :func:`last_logits` — each family's batch dicts (token ids and
  positions; the audio family's codebooks and zero ``cond``; the VLM's
  zero vision prefix and position triples) and the next-token slice;
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
from repro_torch.common.sharding import mesh_axis, set_mesh
from repro_torch.configs.base import ArchConfig
from repro_torch.models import get_model
from repro_torch.models.transformer import check_fits


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512           # cache capacity
    max_new_tokens: int = 64
    temperature: float = 0.0     # 0 → greedy
    eos_id: int = -1             # -1 → never stops early


def decode_batch(cfg: ArchConfig, tokens: torch.Tensor,
                 positions: torch.Tensor) -> Dict[str, Any]:
    """Wrap a (B, 1) token and (B, 1) positions into the decode-batch
    dict: the audio family's token goes to every codebook (B, C, 1), as
    the reference broadcasts it, and the VLM's position to all three
    M-RoPE rows (B, 3, 1)."""
    B = tokens.shape[0]
    if cfg.family == "audio":
        return {"tokens": tokens[:, None, :].expand(B, cfg.n_codebooks, 1),
                "positions": positions}
    if cfg.family == "vlm":
        return {"tokens": tokens,
                "positions": positions[:, None, :].expand(B, 3, 1)}
    return {"tokens": tokens, "positions": positions}


def last_logits(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """(B, V) next-token logits from a decode/prefill output: the audio
    family samples from codebook 0 of its (B, C, T, V), as the
    reference does."""
    if cfg.family == "audio":
        return logits[:, 0, -1, :]
    return logits[:, -1, :]


def build_prefill_batch(cfg: ArchConfig, tokens: torch.Tensor
                        ) -> Dict[str, Any]:
    """(B, P) right-padded prompt ids → the family's prefill batch. The
    audio family's ids go to every codebook, with a zero ``cond``
    (which a pass with a cache never reads: ``cross_attention``); the
    VLM's follow a zero vision prefix, positions 0 .. P + vision_prefix
    − 1 on all three rows."""
    B, P = tokens.shape
    dev = tokens.device
    pos = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    cdt = cfg.dtype("compute")
    if cfg.family == "audio":
        return {"tokens": tokens[:, None, :].expand(B, cfg.n_codebooks, P),
                "positions": pos,
                "cond": torch.zeros((B, cfg.cond_len, cfg.d_model),
                                    dtype=cdt, device=dev)}
    if cfg.family == "vlm":
        vp = cfg.vision_prefix
        return {"tokens": tokens,
                "vision": torch.zeros((B, vp, cfg.d_model), dtype=cdt,
                                      device=dev),
                "positions": torch.arange(P + vp, dtype=torch.int32,
                                          device=dev).expand(B, 3, P + vp)}
    return {"tokens": tokens, "positions": pos}


def host_ints(lengths) -> np.ndarray:
    """Lengths as a host array: a card tensor is read back (one
    sync), anything else is already on the host."""
    if torch.is_tensor(lengths):
        return lengths.detach().to("cpu").numpy()
    return np.asarray(lengths)


def prefill(cfg: ArchConfig, model, params, tokens: torch.Tensor,
            lengths: torch.Tensor, max_len: int) -> Tuple[torch.Tensor, Any]:
    """Prefill a fresh B-slot cache; next-token logits come from each
    prompt's LAST real token. tokens: (B, P); lengths: (B,), a tensor
    or host ints. A dense model's KV cache must hold the P positions
    (``ValueError`` naming ``max_len``, checked from the shape); the
    hybrid's and a MoE model's must hold each row's real tokens
    (checked only where P passes ``max_len``: then card lengths are
    read back once).

    As in the reference, the whole right-padded (B, P) block runs
    through the model: a transformer's KV cache also holds the pad
    tokens of a shorter row (at positions past its length, masked until
    decode overwrites them), and an SSM's state after prefill has
    absorbed them, so that row decodes on from there. The hybrid's
    Mamba2 states absorb the pads past ``max_len`` too, and a MoE
    model's experts route them, whose KV writes are dropped, as in the
    reference.

    The next-token row is index ``lengths − 1`` of the logits, as in
    the reference: the audio family's codebook 0; the VLM's over the
    whole (vision + text) sequence, so a VLM prompt's row lies
    ``vision_prefix`` rows before its last token's (ROADMAP §3: the
    reference's serving ignores the prefix offset). A VLM's cache must
    hold P + ``vision_prefix`` positions.

    Under ``serve_rules`` and a ``(data, model)`` mesh (``axis_rules``,
    ``set_mesh``) ``tokens`` and ``lengths`` are the rank's rows: the
    global batch's share over the data axis where the rules split it,
    every row where they replicate it. The cache is the rank's slice
    (``shardings.local_cache``) and the logits the full rows, so the
    row select and the sampler see what one device would; every rank of
    a model group then draws the same greedy token."""
    B, P = tokens.shape[:2]
    if P > max_len and model.kv_pos is not None:
        check_fits(cfg, int(np.max(host_ints(lengths))) - 1, max_len)
    data = mesh_axis("batch")
    n = B * (1 if data is None else data.size)
    cache = model.make_cache(cfg, n, max_len, device=tokens.device)
    logits, cache = model.forward(cfg, params,
                                  build_prefill_batch(cfg, tokens), cache)
    if not torch.is_tensor(lengths):            # host ints
        lengths = torch.from_numpy(np.asarray(lengths, np.int64))
    idx = torch.clamp(lengths.to(logits.device, torch.long,
                                 non_blocking=True) - 1, min=0)
    rows = torch.arange(B, device=logits.device)
    if cfg.family == "audio":
        return logits[rows, 0, idx, :], cache
    return logits[rows, idx, :], cache


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Greedy (temperature ≤ 0) or temperature sampling over the last
    axis of (B, V) logits. Sampling draws from the explicit
    ``generator``; it gives the reference's distribution, not its
    bits. On a mesh every rank of a model group must draw the same
    token: greedy does on the same logits, and temperature sampling
    needs the same ``generator`` state on every model rank (seed each
    rank's generator alike and draw on each)."""
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
    ...), and so is the Mamba2 state: every leaf gives 1, MLA's latent
    cache and DeepSeek's ``layer0`` (1, B, ...) too. The hybrid's
    Mamba2 states are (nb, mpb, B, ...), 2, and its KV cache and tail
    states 1."""
    model = get_model(cfg)
    with set_mesh(None):                        # the global shapes
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
