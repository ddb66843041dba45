"""Deterministic per-agent synthetic token streams — the port of
``repro.data.synthetic`` for the text families (``audio`` and ``vlm``
raise ``NotPortedError``).

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


def make_agent_batch(cfg, shape, spec: StreamSpec, agent_id: int,
                     step: int, device=None) -> Dict[str, torch.Tensor]:
    """One agent's training batch (tokens, labels = tokens, positions
    0..S−1; int32, (B, S)) on ``device`` (``None``: the card)."""
    if cfg.family in ("audio", "vlm"):
        from repro_torch.configs.base import NotPortedError
        raise NotPortedError(
            f"synthetic batches of the {cfg.family!r} family are not "
            f"ported to repro_torch yet")
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    if spec.kind == "markov":
        t = _markov_tokens(spec, cfg.vocab_size, agent_id, step * 131, B, S)
    else:
        t = torch.randint(0, cfg.vocab_size, (B, S),
                          generator=_gen(spec.seed, 3, agent_id, step))
    t = t.to(torch.int32)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    return {"tokens": t.to(dev), "labels": t.to(dev),
            "positions": pos.contiguous().to(dev)}


def make_group_batch(cfg, shape, spec: StreamSpec, n_agents: int,
                     step: int, device=None) -> Dict[str, torch.Tensor]:
    """Stacked (n_agents, ...) batch — each agent's own stream."""
    batches = [make_agent_batch(cfg, shape, spec, a, step, "cpu")
               for a in range(n_agents)]
    dev = resolve_device(device)
    return {k: torch.stack([b[k] for b in batches]).to(dev)
            for k in batches[0]}
