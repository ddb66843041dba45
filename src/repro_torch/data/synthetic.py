"""Deterministic per-agent synthetic token streams — the port of
``repro.data.synthetic``: text batches, the audio family's delayed
codebook frames with their conditioning, and the VLM's text behind a
vision prefix.

In GARL every agent has its own environment; at LLM scale an agent's
environment is its data stream. ``kind="markov"``: tokens follow an
order-1 Markov chain over ``min(n_states, vocab)`` states whose
successor table (``branch`` successors per state) is each cell's draw
from a table shared by the group or from the agent's own, chosen per
cell with probability ``similarity`` — different agents see different
chains, the paper's heterogeneous environments. ``kind="uniform"``:
i.i.d. uniform tokens.

torch cannot reproduce JAX's threefry draws, so the streams are the
port's own: every draw comes from a ``torch.Generator`` on the CPU
seeded by a hash of (seed, agent, step) — the reference's
``fold_in(fold_in(key(seed), agent), step)`` structure — and the batch
is then moved to ``device``, so the card and the CPU get the same
tokens. The walk itself is the pure function ``markov_walk(table, s0,
branches)``, which the tests feed the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.common.device import resolve_device

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    seed: int = 0
    kind: str = "markov"         # markov | uniform
    n_states: int = 64           # markov chain order-1 state count
    similarity: float = 0.5      # 0 = fully per-agent, 1 = identical
    branch: int = 4              # out-degree of each markov state


def _mix(*ints: int) -> int:
    """A 63-bit generator seed from integers (splitmix64 steps)."""
    x = 0x9E3779B97F4A7C15
    for v in ints:
        x = (x ^ (int(v) & _MASK64)) & _MASK64
        x = (x + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x >> 1


def _gen(*ints: int) -> torch.Generator:
    return torch.Generator().manual_seed(_mix(*ints))


def markov_table(spec: StreamSpec, vocab: int, agent_id: int
                 ) -> torch.Tensor:
    """(n, branch) int64 successor table, n = min(n_states, vocab): each
    cell the shared table's with probability ``similarity``, else the
    agent's own."""
    n = min(spec.n_states, vocab)
    shape = (n, spec.branch)
    shared = torch.randint(0, n, shape, generator=_gen(spec.seed, 0x5EED))
    local = torch.randint(0, n, shape, generator=_gen(spec.seed, 1,
                                                      agent_id))
    pick_shared = torch.rand(shape, generator=_gen(spec.seed, 0xB1E0D)
                             ) < spec.similarity
    return torch.where(pick_shared, shared, local)


def markov_walk(table: torch.Tensor, s0: torch.Tensor,
                branches: torch.Tensor) -> torch.Tensor:
    """The chain from states ``s0`` (batch,) taking successor
    ``branches[:, t]`` of the current state at step t: (batch, seq)
    tokens, token t the state after step t (the reference's
    ``lax.scan`` body ``nxt = table[s, br]``)."""
    s = s0.to(torch.int64)
    br = branches.to(torch.int64)
    out = torch.empty(br.shape, dtype=torch.int64)
    for t in range(br.shape[1]):
        s = table[s, br[:, t]]
        out[:, t] = s
    return out


def _markov_tokens(spec: StreamSpec, vocab: int, agent_id: int, step: int,
                   batch: int, seq: int) -> torch.Tensor:
    n = min(spec.n_states, vocab)
    g = _gen(spec.seed, 2, agent_id, step)
    s0 = torch.randint(0, n, (batch,), generator=g)
    branches = torch.randint(0, spec.branch, (batch, seq), generator=g)
    return markov_walk(markov_table(spec, vocab, agent_id), s0, branches)


def _tokens(spec: StreamSpec, vocab: int, agent_id: int, step: int,
            batch: int, seq: int, sub: int = 0) -> torch.Tensor:
    """(batch, seq) int32 tokens of stream ``sub`` (the audio family's
    codebook; 0 otherwise) of one agent's step."""
    if spec.kind == "markov":
        t = _markov_tokens(spec, vocab, agent_id, step * 131 + sub, batch,
                           seq)
    else:                       # stream 0 keeps the text family's seed
        g = _gen(spec.seed, 3, agent_id, step, *([sub] if sub else []))
        t = torch.randint(0, vocab, (batch, seq), generator=g)
    return t.to(torch.int32)


def _embeddings(spec: StreamSpec, agent_id: int, step: int, shape,
                dtype: torch.dtype) -> torch.Tensor:
    """Stub front-end embeddings (the audio family's ``cond``, the
    VLM's ``vision``): 0.02 · N(0, 1) in fp32, cast to ``dtype``."""
    g = _gen(spec.seed, 7, agent_id, step)
    return (torch.randn(shape, generator=g) * 0.02).to(dtype)


def make_agent_batch(cfg, shape, spec: StreamSpec, agent_id: int,
                     step: int, device=None) -> Dict[str, torch.Tensor]:
    """One agent's training batch on ``device`` (``None``: the card),
    the reference's layout for each family:

    * text: tokens, labels = tokens, positions 0..S−1; int32, (B, S);
    * audio (MusicGen's delay pattern, arXiv:2306.05284 §2.2): C
      codebook streams, codebook c shifted right by c frames with token
      0 as the delay pad, tokens (B, C, S); labels the same with −100
      where t < c; positions (B, S); ``cond`` (B, cond_len, E) of
      0.02 · N(0, 1) in the compute dtype;
    * VLM: text of S − vision_prefix tokens; ``vision`` (B,
      vision_prefix, E) of 0.02 · N(0, 1); labels (B, S), −100 over the
      prefix and the text after it; positions 0..S−1 on all three M-RoPE
      rows, (B, 3, S)."""
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    V, E, cdt = cfg.vocab_size, cfg.d_model, cfg.dtype("compute")
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    if cfg.family == "audio":
        C = cfg.n_codebooks
        t = torch.zeros((B, C, S), dtype=torch.int32)
        for c in range(C):
            frames = _tokens(spec, V, agent_id, step, B, S, c)
            t[:, c, c:] = frames[:, :S - c]
        delay = torch.arange(S)[None, None, :] < torch.arange(C)[None, :,
                                                                 None]
        labels = torch.where(delay, torch.tensor(-100, dtype=torch.int32), t)
        cond = _embeddings(spec, agent_id, step, (B, cfg.cond_len, E), cdt)
        return {"tokens": t.to(dev), "labels": labels.to(dev),
                "positions": pos.to(dev), "cond": cond.to(dev)}
    if cfg.family == "vlm":
        vp = cfg.vision_prefix
        t = _tokens(spec, V, agent_id, step, B, S - vp)
        labels = torch.cat([torch.full((B, vp), -100, dtype=torch.int32), t],
                           dim=1)
        vision = _embeddings(spec, agent_id, step, (B, vp, E), cdt)
        return {"tokens": t.to(dev), "vision": vision.to(dev),
                "labels": labels.to(dev),
                "positions": pos[:, None, :].expand(B, 3, S).contiguous()
                .to(dev)}
    t = _tokens(spec, V, agent_id, step, B, S)
    return {"tokens": t.to(dev), "labels": t.to(dev), "positions": pos.to(dev)}


def make_group_batch(cfg, shape, spec: StreamSpec, n_agents: int,
                     step: int, device=None) -> Dict[str, torch.Tensor]:
    """Stacked (n_agents, ...) batch — each agent's own stream."""
    batches = [make_agent_batch(cfg, shape, spec, a, step, "cpu")
               for a in range(n_agents)]
    dev = resolve_device(device)
    return {k: torch.stack([b[k] for b in batches]).to(dev)
            for k in batches[0]}
