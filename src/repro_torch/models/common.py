"""Shared layer primitives — the port of ``repro.models.common``:
RMSNorm, the parameter initialisers, the embedding rows and heads of
every family (the audio family's codebook tables too), sinusoidal
positions, the position-mask bias, the materialised softmax attention
and the token-mean cross-entropy.

The initialisers draw from a ``torch.Generator``, so they give the
reference's distributions (a truncated normal of fan-in scale, a
normal of std 0.02), not its bits: tests that need both sides on the
same weights carry them across with ``repro_torch.interop``.

The model axis (tensor parallelism, Megatron-style). Under a rule table
and a ``(data, model)`` mesh (``repro_torch.common.sharding``) a layer
of a dense or MoE transformer holds its weights' local slices and
brackets its split work by two autograd functions written here:
``copy_to_model`` (identity forward, all-reduce of the gradient over
the model axis backward) where a replicated tensor enters, and
``reduce_from_model`` (all-reduce forward, identity backward) where
the ranks' partial sums leave. (``torch.distributed.nn``'s all-reduce
all-reduces the gradient too, which would multiply a replicated loss's
gradient by the axis size.) ``split_axis`` gives a layer its axis
(``common.sharding.mesh_axis`` of a logical name where the dim divides
over it), or ``None`` to run the one-device form; every family of the
zoo splits. The embedding lookup and
``cross_entropy`` are vocab-parallel (``vocab=``), and ``cross_entropy``
sums its tokens and their count over the data axis, so every data
rank's loss is the global batch's mean; ``gather_from_model`` puts the
full logits together for scoring and serving.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.common.pytree import pick_rows
from repro_torch.common.sharding import AxisGroup, count, mesh_axis

def split_axis(cfg, logical: str, dim: int) -> Optional[AxisGroup]:
    """The model-axis group ``logical`` resolves to under the installed
    rules and mesh (``common.sharding.mesh_axis``), if a dim of ``dim``
    divides over it (the placement's ``_sanitize``: a dim that does not
    divide stays whole), else ``None``: the one-device form."""
    del cfg
    ax = mesh_axis(logical)
    return ax if ax is not None and dim % ax.size == 0 else None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """A replicated tensor entering split work: the identity forward; its
    gradient, a partial sum on each rank, all-reduced over ``ax``
    backward."""
    return _CopyToModel.apply(x, ax.group)


def reduce_from_model(x: torch.Tensor, ax: AxisGroup,
                      site: str) -> torch.Tensor:
    """The ranks' partial sums leaving split work: all-reduced over
    ``ax`` forward (counted under ``site``); the gradient of the
    replicated result passes through as it is backward."""
    count(site)
    return _ReduceFromModel.apply(x, ax.group)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        import torch.distributed as dist
        ctx.rank, ctx.width = rank, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width], None, None, None


def gather_from_model(x: torch.Tensor, ax: AxisGroup,
                      site: str) -> torch.Tensor:
    """The ranks' column blocks of the last dim put together in rank
    order (an all-gather over ``ax`` forward, counted under ``site``;
    the rank's block of the gradient backward): the full logits of a
    vocab-parallel head."""
    count(site)
    return _GatherFromModel.apply(x, ax.group, ax.size, ax.rank)


def vocab_split(cfg) -> Optional[AxisGroup]:
    """The model axis the vocabulary rows of ``embed`` / columns of
    ``lm_head`` split over, or ``None``."""
    return split_axis(cfg, "vocab", cfg.vocab_size)


def recorded(*tensors: torch.Tensor) -> bool:
    """True when autograd records a pass over ``tensors``: grad mode is
    on and one of them requires grad. Such a pass (a training loss)
    refuses a Pallas ``attention_impl`` / ``ssd_impl``, as the
    reference does (``ArchConfig`` docstring)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_pallas(field: str, impl: str) -> None:
    """A recorded pass asked for a Pallas route, which the reference
    cannot differentiate either: raise naming the field."""
    if impl != "xla":
        from repro_torch.configs.base import NotPortedError
        raise NotPortedError(
            f"ArchConfig.{field}={impl!r} in a pass that autograd records: "
            f"the reference's Pallas kernel has no VJP, so only 'xla' "
            f"trains")


def per_row(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (C,) weight as it is, or a (B, C) weight — one row per batch
    row, the group engine's per-slot weights — shaped to broadcast
    against ``like`` (B, ..., C)."""
    if w.ndim == 1:
        return w
    return w.reshape(w.shape[0], *[1] * (like.ndim - 2), w.shape[-1])


def _rows(table: torch.Tensor, tokens: torch.Tensor,
          agents: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows of a (V, E) table, or with ``agents`` of each batch row's
    agent's table of stacked (A, V, E), for (B, S) tokens."""
    # F.embedding, not indexing: the same rows, and its backward sums a
    # table row's gradients in a fixed order (indexing's accumulates in
    # the order threads get to them on the CPU)
    if agents is None:
        return torch.nn.functional.embedding(tokens.long(), table)
    return pick_rows(table, agents,
                     lambda t, a: t[a[:, None], tokens.long()])


def _split_rows(table: torch.Tensor, tokens: torch.Tensor,
                vocab: AxisGroup) -> torch.Tensor:
    """The rows of a vocab-split (V/m, E) table for (B, S) tokens, or of
    (C, V/m, E) codebook tables for (C, B, S) tokens (codebook c's
    tokens in its table): each rank looks up the tokens its rows hold,
    zeros elsewhere, and one all-reduce over the model axis assembles
    the rows (one nonzero term per row, so the sum is exact)."""
    n = table.shape[-2]
    local = tokens.long() - vocab.rank * n
    inside = (local >= 0) & (local < n)
    local = torch.where(inside, local, torch.zeros_like(local))
    if table.ndim == 2:
        rows = torch.nn.functional.embedding(local, table)
    else:
        rows = torch.stack([torch.nn.functional.embedding(local[c], table[c])
                            for c in range(table.shape[0])])
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows, vocab, "embed")


def embed_rows(cfg, params: dict, tokens: torch.Tensor,
               agents: Optional[torch.Tensor] = None,
               vocab: Optional[AxisGroup] = None) -> torch.Tensor:
    """The embedding rows the tokens pick, cast to the compute dtype
    (the reference casts the whole table first, which gives the same
    values); with ``agents`` (B,), row b's from agent ``agents[b]``'s
    table of stacked planes (A, V, E). The audio family's tokens are
    (B, C, S) over C codebook tables (C, V, E) (per agent (A, C, V,
    E)): the C rows of a position are summed in the compute dtype, in
    codebook order, as the reference sums them. ``vocab`` (the model
    axis): ``embed`` holds the rank's rows of the vocabulary (audio: of
    each codebook's, (C, V/m, E)); each codebook's rows are looked up
    on the rank that holds them, all C of them assembled by one
    all-reduce of the stacked (C, B, S, E) rows, then summed in codebook
    order, so the sum rounds as on one device."""
    cdt = cfg.dtype("compute")
    table = params["embed"]
    if cfg.family != "audio":
        if vocab is not None:
            return _split_rows(table, tokens, vocab).to(cdt)
        return _rows(table, tokens, agents).to(cdt)
    if vocab is not None:
        books = _split_rows(table, tokens.transpose(0, 1), vocab).to(cdt)
    else:
        books = [_rows(table[c] if agents is None else table[:, c],
                       tokens[:, c], agents).to(cdt)
                 for c in range(cfg.n_codebooks)]
    x = 0
    for c in range(cfg.n_codebooks):
        x = x + books[c]
    return x


def head_weight(cfg, params: dict,
                agents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The LM head (E, V) — the embedding's transpose when tied — or,
    with ``agents`` (B,), each row's agent's (B, E, V) from stacked
    planes; the audio family's C codebook heads (C, E, V), per agent
    (B, C, E, V). On a vocab-split model axis each holds the rank's V/m
    columns ((E, V/m), audio (C, E, V/m)). Not yet cast."""
    tied = cfg.tie_embeddings and cfg.family != "audio"
    if agents is None:
        return params["embed"].T if tied else params["lm_head"]
    if tied:
        return pick_rows(params["embed"], agents).transpose(-1, -2)
    return pick_rows(params["lm_head"], agents)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, cast back to ``x``'s dtype;
    ``weight`` is (C,) or per batch row (B, C) (:func:`per_row`)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * per_row(weight, x).to(torch.float32)).to(x.dtype)


def truncated_normal(gen: torch.Generator, shape: Sequence[int],
                     lower: float = -2.0, upper: float = 2.0,
                     device=None) -> torch.Tensor:
    """Standard normal truncated to [lower, upper], fp32, by inverting
    the CDF of a uniform draw (as ``jax.random.truncated_normal``
    does)."""
    device = device if device is not None else gen.device
    sqrt2 = math.sqrt(2.0)
    a, b = math.erf(lower / sqrt2), math.erf(upper / sqrt2)
    u = torch.rand(tuple(shape), generator=gen, device=device,
                   dtype=torch.float32)
    z = sqrt2 * torch.erfinv(a + (b - a) * u)
    return z.clamp_(lower, upper)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): std 1/√shape[0]
    unless ``scale`` is given, truncated at ±2 std."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (truncated_normal(gen, shape, device=device) * std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, device=None) -> torch.Tensor:
    device = device if device is not None else gen.device
    return (torch.randn(tuple(shape), generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int,
                         max_timescale: float = 1e4) -> torch.Tensor:
    """Classic sinusoidal embeddings; positions (..., S) int → (..., S,
    dim) fp32, [sin, cos] of positions × exp(−ln(max_timescale) · j /
    (dim/2)), in the reference's order of operations."""
    half = dim // 2
    freq = torch.exp(-math.log(max_timescale)
                     * torch.arange(half, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def causal_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: Optional[int] = None,
                     k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive attention bias from position comparisons.

    q_pos: (B, Sq) absolute positions of the queries; k_pos: (B, Sk) of
    the keys; window: sliding-window width (None = full causal);
    k_valid: optional (B, Sk) bool marking live cache slots. Returns a
    (B, 1, Sq, Sk) fp32 bias of 0 / −1e30 (broadcast over heads)."""
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        ok &= k_pos[:, None, :] > (q_pos[:, :, None] - window)
    if k_valid is not None:
        ok &= k_valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)[:, None, :, :]


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor, scale: float,
                      scores_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Materialised attention. q: (B, Sq, H, Dk), k: (B, Sk, K, Dk), v:
    (B, Sk, K, Dv) with H = G·K (GQA: k and v gathered onto the H query
    heads, head h reading kv head h // G); bias: (B, 1, Sq, Sk).

    The scores and the softmax are in ``scores_dtype`` (the reference's
    ``attention_scores_dtype``); the probabilities times v accumulate
    in fp32, and the result is cast to q's dtype."""
    H, K = q.shape[2], k.shape[2]
    if H != K:
        idx = torch.arange(H, device=k.device) // (H // K)
        k = k.index_select(2, idx)
        v = v.index_select(2, idx)
    sdt = scores_dtype
    scores = torch.einsum("bqhd,bshd->bhqs", q.to(sdt), k.to(sdt))
    scores = scores * torch.tensor(scale, dtype=sdt) + bias.to(sdt)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", probs.to(torch.float32),
                       v.to(sdt).to(torch.float32))
    return out.to(q.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -100,
                  vocab: Optional[AxisGroup] = None) -> torch.Tensor:
    """Token-mean cross-entropy with an ignore mask; logits (..., V) of
    any float dtype, fp32 math.

    ``vocab`` (the model axis): ``logits`` are the rank's (..., V/m)
    columns. Each rank's log-sum-exp is combined over the axis as
    M + log Σ_r exp(lse_r − M), M the ranks' largest (an all-reduce max,
    no gradient, then an all-reduce sum): on one rank it is lse itself,
    bit for bit. The label's logit comes from the rank that holds it (an
    all-reduce of one nonzero term). Under a data axis (``"batch"`` of
    the installed rules) the token sum and the token count are
    all-reduced over it, so the loss is the global batch's mean on every
    rank (ignored labels make the counts differ between ranks); the
    gradient each rank takes is its own tokens' part."""
    lf = logits.to(torch.float32)
    safe = torch.clamp(labels.long(), min=0)
    if vocab is None:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    else:
        import torch.distributed as dist
        lse = torch.logsumexp(lf, dim=-1)
        top = lse.detach().clone()
        count("ce_max")
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=vocab.group)
        logz = top + torch.log(reduce_from_model(torch.exp(lse - top),
                                                 vocab, "ce_sum"))
        n = lf.shape[-1]
        local = safe - vocab.rank * n
        inside = (local >= 0) & (local < n)
        g = torch.gather(lf, -1, torch.where(
            inside, local, torch.zeros_like(local))[..., None])[..., 0]
        gold = reduce_from_model(torch.where(inside, g, torch.zeros_like(g)),
                                 vocab, "ce_gold")
    mask = (labels != ignore).to(torch.float32)
    num = torch.sum((logz - gold) * mask)
    den = torch.sum(mask)
    data = mesh_axis("batch")
    if data is not None:
        import torch.distributed as dist
        num = reduce_from_model(num, data, "loss_sum")
        count("loss_count")
        dist.all_reduce(den, group=data.group)
    return num / torch.clamp(den, min=1.0)
