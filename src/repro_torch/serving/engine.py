"""Batched serving engine — the port of ``repro.serving.engine``:
prefill, then token-by-token decode over the model's functional cache
(the SSM state for Mamba2).

The reference jits the decode as one ``lax.scan``; here it is a Python
loop of ``max_new_tokens − 1`` steps with the same per-slot done
masking, and nothing in it reads a device value back to the host when
the caller passes the prompt lengths from the host (as
:func:`serve_batches` builds them): the KV cache's fit is checked once
per call from those. ``prefill`` and ``decode`` are public steps as
well as ``generate``, so a caller can time them apart.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import get_model
from repro_torch.models.transformer import check_fits
from repro_torch.serving.api import (
    Sampler,
    ServeConfig,
    StopCriteria,
    decode_batch,
    host_ints,
    last_logits,
    prefill,
)


class DecodeState(NamedTuple):
    cache: Any
    tokens: torch.Tensor         # (B, 1) last emitted token
    pos: torch.Tensor            # (B,) next absolute position
    done: torch.Tensor           # (B,) bool


class ServeEngine:
    """One arch, one set of params (on the device the engine serves
    from), one cache capacity."""

    def __init__(self, cfg: ArchConfig, params, serve: ServeConfig):
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.model = get_model(cfg)
        self.sampler = Sampler(serve.temperature)
        self.stop = StopCriteria.from_serve(serve)

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, Any]:
        """prompts: (B, P) right-padded ids; lengths: (B,) → (next-token
        logits (B, V), filled cache)."""
        return prefill(self.cfg, self.model, self.params, prompts, lengths,
                       self.serve.max_len)

    @torch.no_grad()
    def decode(self, first_logits: torch.Tensor, cache: Any, lengths,
               generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """Sample the first token from the prefill's logits, then decode
        ``max_new_tokens − 1`` more. A slot that emitted ``eos_id``
        repeats its last token from then on. Returns (B,
        max_new_tokens) int32.

        ``lengths`` (B,): the prompt lengths, from the host (a list, a
        numpy array or a CPU tensor: then nothing here reads a value
        back from the card) or on the card (then read back once, to
        check the fit). A model's KV cache (dense, hybrid) must hold
        the last position written, max(lengths) + max_new_tokens − 2,
        else ``ValueError`` names ``max_len``, before any step runs."""
        cfg = self.cfg
        dev = first_logits.device
        if self.model.kv_pos is not None and self.serve.max_new_tokens > 1:
            check_fits(cfg, int(np.max(host_ints(lengths)))
                       + self.serve.max_new_tokens - 2,
                       self.model.kv_pos(cache).shape[-1])
        if torch.is_tensor(lengths):
            pos = lengths.to(device=dev, dtype=torch.int32,
                             non_blocking=True)
        else:
            pos = torch.from_numpy(np.asarray(lengths, np.int32)).to(
                dev, non_blocking=True)
        tok0 = self.sampler(first_logits, generator)
        st = DecodeState(cache=cache, tokens=tok0[:, None], pos=pos,
                         done=self.stop.eos_done(tok0))
        out = [tok0]
        for _ in range(self.serve.max_new_tokens - 1):
            batch = decode_batch(cfg, st.tokens, st.pos[:, None])
            logits, cache = self.model.decode(cfg, self.params, batch,
                                              st.cache)
            nxt = self.sampler(last_logits(cfg, logits), generator)
            nxt = torch.where(st.done, st.tokens[:, 0], nxt)
            done = st.done | self.stop.eos_done(nxt)
            st = DecodeState(cache=cache, tokens=nxt[:, None],
                             pos=st.pos + 1, done=done)
            out.append(nxt)
        return torch.stack(out, dim=1)

    def generate(self, prompts: torch.Tensor, lengths,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """prompts: (B, P) right-padded int32; lengths: (B,), as
        :meth:`decode` takes them."""
        first_logits, cache = self.prefill(prompts, lengths)
        return self.decode(first_logits, cache, lengths, generator)


def serve_batches(requests: Sequence[Sequence[int]], batch_size: int,
                  pad_id: int = 0, device=None
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Pack a request list into fixed-(B, P) batches, the tail batch
    padded with ``[pad_id]`` requests; returns [(tokens int32 (B, P),
    lengths int32 (B,)), ...] on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    out = []
    for i in range(0, len(requests), batch_size):
        chunk = list(requests[i:i + batch_size])
        while len(chunk) < batch_size:          # pad the tail batch
            chunk.append([pad_id])
        P = max(len(r) for r in chunk)
        toks = np.full((batch_size, P), pad_id, np.int32)
        lens = np.zeros((batch_size,), np.int32)
        for j, r in enumerate(chunk):
            toks[j, :len(r)] = r
            lens[j] = len(r)
        out.append((torch.from_numpy(toks).to(device),
                    torch.from_numpy(lens).to(device)))
    return out
