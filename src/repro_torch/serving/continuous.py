"""Continuous batching — the port of ``repro.serving.continuous``: a
fixed-slot decode batch whose finished slots are refilled from a
request queue without stopping the other slots (vLLM-style serving).

Prompts prefill at B = 1 into a slot-shaped cache, the result is
spliced into the batch cache at the freed slot
(``repro_torch.serving.api.splice_cache``), and one decode step
advances every live slot. Each step makes exactly one device→host copy,
the sampled tokens (the reference's ``jax.device_get((nxt, pos))``):
each slot's next position is kept on the host, where the reference only
adds 1 to it, and mirrored on the device without a copy. A finished
slot keeps its position until it is refilled, so its idle decode never
writes past the KV cache (the reference lets it run on; its writes
past the cache are dropped, which the port refuses).

Batch construction, sampling, stop logic and the cache's batch dims
come from ``repro_torch.serving.api``, shared with the fixed-batch
engine and the group engine (``repro_torch.serving.group``, which
runs its slots through the same :class:`SlotBatch`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves_with_paths
from repro_torch.configs.base import ArchConfig
from repro_torch.models import get_model
from repro_torch.serving.api import (
    Sampler,
    ServeConfig,
    StopCriteria,
    cache_batch_dims,
    decode_batch,
    last_logits,
    prefill,
    splice_cache,
)


def pad_prompt(prompt_pad: int, n: int) -> int:
    """Smallest power-of-2 multiple of ``prompt_pad`` holding ``n``
    tokens (the reference bounds its prefill compilations so; here it
    keeps the prefill shapes few)."""
    p = prompt_pad
    while p < n:
        p *= 2
    return p


def prefill_width(cfg: ArchConfig, prompt_pad: int, n: int,
                  max_len: int) -> int:
    """The padded prefill width of an ``n``-token prompt:
    :func:`pad_prompt`'s, cut to the KV cache for a model that has one,
    no window, no recurrent state and no experts (dense, VLM, audio),
    less the VLM's vision prefix, which the prefill puts ahead of the
    prompt. The reference drops the KV writes of pad positions past
    ``max_len``; no real token attends to them, so cutting them off
    gives the same logits.
    The hybrid and the MoE models are not cut: the hybrid's Mamba2
    states run through every pad, and an expert's capacity grows with
    the padded width, so a cut width would route and drop tokens
    otherwise; they prefill the whole width and drop those KV writes as
    the reference does. A prompt longer than the cache is not cut, and
    its prefill raises ``ValueError`` naming ``max_len``."""
    width = pad_prompt(prompt_pad, n)
    if (get_model(cfg).kv_pos is not None and cfg.ssm is None
            and cfg.moe is None and not cfg.sliding_window):
        width = max(n, min(width, max_len - cfg.vision_prefix))
    return width


def device_of(tree) -> torch.device:
    """The device of a parameter tree's first leaf."""
    return tree_leaves_with_paths(tree)[0][1].device


def prefill_logits(cfg: ArchConfig, model, params, prompt: Sequence[int],
                   prompt_pad: int, max_len: int) -> Tuple[torch.Tensor, Any]:
    """B = 1 prefill of one prompt, right-padded to
    :func:`prefill_width`, into a fresh 1-slot cache → (its next-token
    logits (1, V), the cache)."""
    n = len(prompt)
    toks = np.zeros((1, prefill_width(cfg, prompt_pad, n, max_len)),
                    np.int32)
    toks[0, :n] = prompt
    dev = device_of(params)
    return prefill(cfg, model, params,
                   torch.from_numpy(toks).to(dev, non_blocking=True),
                   [n], max_len)


def prefill_one(cfg: ArchConfig, model, params, prompt: Sequence[int],
                prompt_pad: int, max_len: int, sampler: Sampler,
                generator: Optional[torch.Generator]
                ) -> Tuple[int, Any]:
    """:func:`prefill_logits`, then its first token sampled and read back
    to the host → (the token, the cache)."""
    nl, one = prefill_logits(cfg, model, params, prompt, prompt_pad,
                             max_len)
    return int(sampler(nl, generator)[0]), one


class SlotBatch:
    """The device side of ``B`` persistent decode slots — the batch
    cache, each slot's last token, done flag and agent — and each
    slot's next absolute position, kept on the host (``pos``) and
    mirrored on the device (``pos_dev``, advanced there without a
    copy). The engine owns the cache: :meth:`admit` splices into it in
    place."""

    def __init__(self, cfg: ArchConfig, model, batch_size: int,
                 max_len: int, device: torch.device):
        self.cfg, self.model, self.B = cfg, model, batch_size
        self.bdims = cache_batch_dims(cfg, max_len)
        self.cache = model.make_cache(cfg, batch_size, max_len,
                                      device=device)
        self.tokens = torch.zeros((batch_size, 1), dtype=torch.int32,
                                  device=device)
        self.pos = np.zeros((batch_size,), np.int64)
        self.pos_dev = torch.zeros((batch_size,), dtype=torch.int32,
                                   device=device)
        self.done = torch.ones((batch_size,), dtype=torch.bool,
                               device=device)
        self.agents = torch.zeros((batch_size,), dtype=torch.long,
                                  device=device)

    def admit(self, i: int, one_cache, first: int, n: int,
              agent: int = 0) -> None:
        """Slot ``i`` takes a prefilled request: its B = 1 cache, its
        first token, its next position ``n`` (the prompt length) and
        its agent. Scalar writes only: nothing is copied from the host
        and nothing is read back."""
        splice_cache(self.cache, one_cache, self.bdims, i)
        self.tokens[i, 0] = first
        self.pos[i] = n
        self.pos_dev[i] = n
        self.done[i] = False
        self.agents[i] = agent

    def release(self, i: int) -> None:
        self.done[i] = True

    def step(self, decode: Callable, sampler: Sampler,
             generator: Optional[torch.Generator],
             live: Sequence[int]) -> np.ndarray:
        """One decode step for every slot: ``decode(batch, cache) →
        (logits, cache)``; the live slots' positions advance by one
        (host and device). Returns the sampled tokens (B,) on the host:
        the step's one device→host copy."""
        batch = decode_batch(self.cfg, self.tokens, self.pos_dev[:, None])
        logits, self.cache = decode(batch, self.cache)
        nxt = sampler(last_logits(self.cfg, logits), generator)
        nxt = torch.where(self.done, self.tokens[:, 0], nxt)
        self.tokens = nxt[:, None]
        self.pos_dev = self.pos_dev + (~self.done).to(torch.int32)
        self.pos[list(live)] += 1
        return nxt.cpu().numpy()


@dataclasses.dataclass
class _Slot:
    request_id: Optional[int] = None
    tokens: Optional[list] = None          # generated so far
    done: bool = True


class ContinuousBatcher:
    """Serve a request stream through ``batch_size`` persistent slots.

    engine-level API:
        batcher = ContinuousBatcher(cfg, params, serve, batch_size=4)
        results = batcher.run(requests)     # {req_id: [tokens...]}

    ``params`` live on the device the batcher serves from; ``slots``
    is the slot table of the current (or last) run.
    """

    def __init__(self, cfg: ArchConfig, params, serve: ServeConfig,
                 batch_size: int, prompt_pad: int = 32):
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.B = batch_size
        self.prompt_pad = prompt_pad
        self.model = get_model(cfg)
        self.sampler = Sampler(serve.temperature)
        self.stop = StopCriteria.from_serve(serve)
        self.device = device_of(params)

    def _decode(self, batch, cache):
        return self.model.decode(self.cfg, self.params, batch, cache)

    @torch.no_grad()
    def run(self, requests: Sequence[Sequence[int]],
            generator: Optional[torch.Generator] = None
            ) -> Dict[int, List[int]]:
        """{request index: generated tokens}; temperature sampling draws
        from ``generator`` (default: seed 0 on the serving device)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        queue = list(enumerate(requests))
        self.slots = slots = [_Slot() for _ in range(self.B)]
        state = SlotBatch(self.cfg, self.model, self.B, self.serve.max_len,
                          self.device)
        results: Dict[int, List[int]] = {}

        while queue or any(not s.done for s in slots):
            # refill finished slots
            for i, s in enumerate(slots):
                if s.done and queue:
                    rid, req = queue.pop(0)
                    first, one = prefill_one(
                        self.cfg, self.model, self.params, req,
                        self.prompt_pad, self.serve.max_len, self.sampler,
                        generator)
                    # prefill's own token may already end the request
                    # (eos on the first sample, max_new_tokens == 1,
                    # or a prompt that fills the cache)
                    if self.stop.should_stop(1, first, len(req)):
                        results[rid] = [first]
                        continue
                    state.admit(i, one, first, len(req))
                    slots[i] = _Slot(request_id=rid, tokens=[first],
                                     done=False)

            live = [i for i, s in enumerate(slots) if not s.done]
            if not live:
                continue        # every refill finished at prefill time

            # one decode step for every live slot, one device→host copy
            nxt_h = state.step(self._decode, self.sampler, generator, live)
            for i in live:
                s = slots[i]
                t = int(nxt_h[i])
                s.tokens.append(t)
                if self.stop.should_stop(len(s.tokens), t,
                                         int(state.pos[i])):
                    results[s.request_id] = s.tokens
                    s.done = True
                    state.release(i)
        return results
