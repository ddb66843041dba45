"""Attention layers — the port of ``repro.models.attention``: GQA
self-attention (RoPE, M-RoPE or none, optional sliding window, optional
QKV bias), MusicGen's cross-attention to a conditioning sequence and
DeepSeek-V2's Multi-head Latent Attention.

On the model axis (``repro_torch.models.common.split_axis``) a
cache-free pass runs Megatron-style: ``wq`` / ``wk`` / ``wv`` (and their
biases) are column slices giving the rank H/m query heads and K/m kv
heads (the GQA group H/K kept), the flash kernel runs on those heads,
and ``wo`` is a row slice whose partial product is all-reduced. A
projection whose heads do not divide over the axis is placed whole
(``repro_torch.launch.shardings.placement_spec``): its weight enters
the split work through ``copy_to_model`` and the rank takes the heads
its query heads need (the kv heads they read; with whole query heads,
the output columns that meet its rows of ``wo``).

With a KV cache under ``serve_rules`` the cache's slot dim lies over
the ``"kv_slots"`` axis (the reference's flash-decoding layout: kv head
counts rarely divide the mesh): each rank holds its contiguous block of
every layer's slots, every kv head
(``repro_torch.common.sharding.slot_range``). The split projections'
queries and new keys and values are all-gathered over the axis, each
rank writes the slots it holds and attends every query head over them
(a row max, a row sum and an unnormalised P·V in fp32), and the ranks'
parts meet in a log-sum-exp combine: an all-reduce (max) of the (B, H,
S) maxima, then one all-reduce (sum) of the sums and numerators. The
rank's heads of the result then meet its rows of ``wo``. A layer's
collectives carry O(B·S·H·D) numbers whatever the cache's length. MLA
splits its query and up-projections by head and sweeps its latent cache
the same way (:func:`mla_attention`).

Decode-time KV caches are functional values, as in the reference:
:func:`self_attention` returns a new layer cache and leaves the one it
was given as it was. Cache slots carry their absolute position
(``pos``, −1 = empty), which expresses both full caches and
sliding-window ring buffers.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.sharding import count, mesh_axis, slot_range
from repro_torch.configs.base import DTYPES
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import (causal_mask_bias, copy_to_model,
                                       dense_init, gather_from_model,
                                       per_row, recorded,
                                       reduce_from_model, refuse_pallas,
                                       rms_norm, softmax_attention,
                                       split_axis)


def init_self_attention(cfg, gen: torch.Generator, device=None) -> dict:
    E, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype("param")
    p = {
        "wq": dense_init(gen, (E, H * D), dt, device=device),
        "wk": dense_init(gen, (E, K * D), dt, device=device),
        "wv": dense_init(gen, (E, K * D), dt, device=device),
        "wo": dense_init(gen, (H * D, E), dt, device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * D), ("bk", K * D), ("bv", K * D)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    return p


def init_cross_attention(cfg, gen: torch.Generator, device=None) -> dict:
    """MHA cross-attention's four (E, H·D) / (H·D, E) projections."""
    E, H, D = cfg.d_model, cfg.n_heads, cfg.head_dim
    dt = cfg.dtype("param")
    return {
        "wq": dense_init(gen, (E, H * D), dt, device=device),
        "wk": dense_init(gen, (E, H * D), dt, device=device),
        "wv": dense_init(gen, (E, H * D), dt, device=device),
        "wo": dense_init(gen, (H * D, E), dt, device=device),
    }


def init_mla(cfg, gen: torch.Generator, device=None) -> dict:
    """MLA's weights: the query projection (E, H·(dn + dr)), the joint
    down-projection to the latent and the rotary key (E, r + dr), the
    latent's RMSNorm (r,), the up-projections of keys (r, H·dn) and
    values (r, H·dv), and the output (H·dv, E)."""
    m = cfg.mla
    E, H = cfg.d_model, cfg.n_heads
    dt = cfg.dtype("param")
    qdim = H * (m.qk_nope_dim + m.qk_rope_dim)
    return {
        "wq": dense_init(gen, (E, qdim), dt, device=device),
        "w_dkv": dense_init(gen, (E, m.kv_lora_rank + m.qk_rope_dim), dt,
                            device=device),
        "ln_ckv": torch.ones((m.kv_lora_rank,), dtype=dt, device=device),
        "w_uk": dense_init(gen, (m.kv_lora_rank, H * m.qk_nope_dim), dt,
                           device=device),
        "w_uv": dense_init(gen, (m.kv_lora_rank, H * m.v_dim), dt,
                           device=device),
        "wo": dense_init(gen, (H * m.v_dim, E), dt, device=device),
    }


def make_kv_cache(cfg, batch: int, max_len: int, n_layers: int,
                  dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """Stacked-over-layers KV cache on ``device`` (``None``: the card).
    For sliding-window configs the cache is a ring buffer of ``window``
    slots."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype("compute")
    slots = (min(max_len, cfg.sliding_window) if cfg.sliding_window
             else max_len)
    K, D = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((n_layers, batch, slots, K, D), dtype=dt,
                         device=dev),
        "v": torch.zeros((n_layers, batch, slots, K, D), dtype=dt,
                         device=dev),
        "pos": torch.full((n_layers, batch, slots), -1, dtype=torch.int32,
                          device=dev),
    }


def make_cross_cache(cfg, batch: int, n_layers: int,
                     device=None) -> dict:
    """The stacked layers' cross-attention keys and values (``ck``,
    ``cv``: (n_layers, batch, cond_len, H, D) in the compute dtype),
    zeros, as the reference makes them: a pass with this cache attends
    to them and never projects its ``cond``."""
    dev = resolve_device(device)
    shape = (n_layers, batch, cfg.cond_len, cfg.n_heads, cfg.head_dim)
    dt = cfg.dtype("compute")
    return {"ck": torch.zeros(shape, dtype=dt, device=dev),
            "cv": torch.zeros(shape, dtype=dt, device=dev)}


def make_mla_cache(cfg, batch: int, max_len: int, n_layers: int,
                   dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """Stacked-over-layers MLA cache on ``device`` (``None``: the card):
    the rank-r latent ``ckv`` and the shared rotary key ``k_rope`` of
    every slot (r + dr values a token, the paper's KV compression) and
    the slots' positions."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype("compute")
    m = cfg.mla
    slots = (min(max_len, cfg.sliding_window) if cfg.sliding_window
             else max_len)
    return {
        "ckv": torch.zeros((n_layers, batch, slots, m.kv_lora_rank),
                           dtype=dt, device=dev),
        "k_rope": torch.zeros((n_layers, batch, slots, m.qk_rope_dim),
                              dtype=dt, device=dev),
        "pos": torch.full((n_layers, batch, slots), -1, dtype=torch.int32,
                          device=dev),
    }


def _write_slots(layer_cache: dict, new: dict, slot_idx: torch.Tensor,
                 drop_past: bool = False,
                 start: Optional[int] = None) -> dict:
    """A copy of the layer cache's leaves named in ``new`` (each (B, Smax,
    ...)) with the per-batch rows ``new[name]`` (B, T, ...) scattered
    into slots ``slot_idx`` (B, T), the index worked out once for them
    all. Slots must lie in [0, Smax): the reference drops writes beyond
    the cache silently, torch indexing does not, so callers check first
    (``transformer_forward``). With ``drop_past`` the writes at slots
    past the cache are dropped, as the reference's are: they go to one
    spare row past the copy, which is cut off. ``start`` (a rank's block
    of a cache split over the slot axis): global slot s goes to local
    slot s − start, and the writes to the slots other ranks hold are
    dropped the same way."""
    B, T = slot_idx.shape
    s = slot_idx.long()
    smax = layer_cache["pos"].shape[1]
    dev = slot_idx.device
    if not drop_past and start is None:
        bidx = torch.arange(B, device=dev)[:, None].expand(B, T)

        def put(buf, x):
            out = buf.clone()
            out[bidx, s] = x.to(buf.dtype)
            return out
    else:
        keep = s < smax
        if start is not None:
            s = s - start
            keep = (s >= 0) & (s < smax)
        rows = torch.where(keep, torch.arange(B, device=dev)[:, None] * smax
                           + s, B * smax)

        def put(buf, x):
            rest = tuple(buf.shape[2:])
            flat = buf.new_empty((B * smax + 1,) + rest)
            flat[:-1] = buf.reshape((B * smax,) + rest)
            flat[rows] = x.to(buf.dtype)
            return flat[:-1].view(buf.shape)
    return {name: put(layer_cache[name], x) for name, x in new.items()}


def _slot_start(layer_cache: dict, key: str, sw) -> Optional[int]:
    """The global slot of the rank's first local slot on the slot axis
    ``sw`` (``None``: no axis): r·T_r for T_r local slots
    (``slot_range`` of m·T_r). A whole cache (slots not dividing the
    axis) thus lies on rank 0: every other rank's block starts past it.
    (A MoE prefill's writes past such a cache, positions T .. m·T − 1,
    land in those empty copies, where the causal mask hides them from
    every position below T.)"""
    if sw is None:
        return None
    return slot_range(layer_cache[key].shape[-1] * sw.size, sw)[0]


def _sweep(scores: torch.Tensor, values: torch.Tensor, eq: str,
           sw) -> torch.Tensor:
    """Softmax attention over every rank's slots of the slot axis ``sw``:
    ``scores`` (B, H, S, T_r) fp32 over the rank's slots, the mask
    added; ``values`` as ``eq`` reads them against the probabilities.
    M, the ranks' largest score per (b, h, q), is all-reduced (max);
    then Σ exp(s − M) (B, H, S) and the numerator Σ exp(s − M)·v (B, S,
    H, Dv) go through one all-reduce (sum). Returns the numerator over
    the sum (fp32). A rank whose slots a row may not see adds exp(−1e30
    − M) = 0."""
    import torch.distributed as dist
    top = scores.detach().amax(dim=-1)
    count("kv_max")
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=sw.group)
    p = torch.exp(scores - top[..., None])
    den = p.sum(dim=-1)
    num = torch.einsum(eq, p, values)
    both = reduce_from_model(torch.cat([den.reshape(-1), num.reshape(-1)]),
                             sw, "kv_sum")
    den = both[:den.numel()].view(den.shape)
    num = both[den.numel():].view(num.shape)
    return num / den.transpose(1, 2)[..., None]


def _weight(p: dict, name: str, split: bool, tp) -> torch.Tensor:
    """``p[name]``: the rank's slice where it is ``split``; a weight
    placed whole enters the split work of the model axis ``tp`` through
    ``copy_to_model`` (its gradient all-reduced)."""
    w = p[name]
    return w if split or tp is None else copy_to_model(w, tp)


def _gather_heads(t: torch.Tensor, ax, site: str) -> torch.Tensor:
    """(..., n, d) per-head values of the rank's n heads → (..., m·n, d)
    of every head, in head order (the ranks hold contiguous heads)."""
    lead, (n, d) = t.shape[:-2], t.shape[-2:]
    full = gather_from_model(t.reshape(lead + (n * d,)), ax, site)
    return full.reshape(lead + (-1, d))


def _slots_for(cfg, positions: torch.Tensor) -> torch.Tensor:
    """Map absolute positions → cache slots (ring for sliding window)."""
    if cfg.sliding_window:
        return positions % cfg.sliding_window
    return positions


def self_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                   layer_cache: Optional[dict] = None,
                   drop_past: bool = False):
    """GQA self-attention.

    x: (B, S, E); positions: (B, S), or (B, 3, S) for M-RoPE, whose
    rotation takes the triples while the cache slots, their ``pos`` and
    the mask take the w row ``positions[:, -1, :]``, as the reference's
    do; layer_cache: this layer's slice of the KV cache (prefill /
    decode) or None (a full-sequence pass).
    Returns (out, new_layer_cache). Every weight in ``p`` may carry a
    leading batch axis, one row's weights each (the group engine's
    per-slot weights: (B, E, F) products and (B, F) biases).

    Without a cache it calls the flash attention, as the reference's
    ``_maybe_pallas`` does: causal by index, ``window =
    cfg.sliding_window``, scale 1/√D, so it assumes each row's positions
    are 0..S−1 (``ArchConfig`` docstring); the tensors' device chooses
    the CUDA kernel or its plain version. A pass that autograd records (a training loss) goes
    through ``flash_attention_with_vjp``, whose backward is the plain
    version's, and refuses an ``attention_impl`` other than ``"xla"``
    with ``NotPortedError`` (the reference's Pallas kernel has no VJP).
    With a cache it writes the new keys and values into their slots,
    then attends over the slots with ``causal_mask_bias`` by position
    and ``softmax_attention``; ``drop_past`` drops the writes at slots
    past the cache instead of requiring that none be made (the hybrid's
    right-padded prefill, whose pads past ``max_len`` still run on).
    On a model axis a cache-free pass runs the rank's heads and returns
    the all-reduced output; with a cache under ``serve_rules`` the rank
    writes and sweeps the slots it holds (module docstring).
    """
    B, S, _ = x.shape
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = cfg.dtype("compute")
    tp = split_axis(cfg, "heads", H * D)
    sw = None if layer_cache is None else mesh_axis("kv_slots")
    # the rank's query heads h0 .. h0 + n_q − 1 (all of them on one
    # device, or where wq is placed whole)
    q_split = kv_split = True
    n_q, h0 = H, 0
    if tp is not None:
        m, r = tp.size, tp.rank
        q_split, kv_split = H % m == 0, K % m == 0
        if q_split:
            n_q, h0 = H // m, r * (H // m)
        x = copy_to_model(x, tp)

    def weight(name, split):
        return _weight(p, name, split, tp)
    xq = x @ weight("wq", q_split).to(cdt)
    xk = x @ weight("wk", kv_split).to(cdt)
    xv = x @ weight("wv", kv_split).to(cdt)
    if cfg.qkv_bias:
        xq = xq + per_row(weight("bq", q_split), xq).to(cdt)
        xk = xk + per_row(weight("bk", kv_split), xk).to(cdt)
        xv = xv + per_row(weight("bv", kv_split), xv).to(cdt)
    if tp is not None and layer_cache is not None:
        # a cache holds every kv head and the sweep runs every query
        # head: the split projections are all-gathered, in one call
        split = [t for t, ok in ((xq, q_split), (xk, kv_split),
                                 (xv, kv_split)) if ok]
        if split:
            widths = [t.shape[-1] for t in split]
            full = gather_from_model(torch.cat(split, dim=-1), tp,
                                     "qkv_gather")
            parts = full.unflatten(-1, (m, sum(widths))).split(widths, -1)
            parts = iter(t.flatten(-2) for t in parts)
            if q_split:
                xq, n_q, h0 = next(parts), H, 0
            if kv_split:
                xk, xv = next(parts), next(parts)
    elif not kv_split:
        # the whole projection: keep the kv heads the rank's query heads
        # read
        first, n, ids = _kv_heads_of(h0, n_q, H // K)
        if ids is None:
            xk = xk[..., first * D:(first + n) * D]
            xv = xv[..., first * D:(first + n) * D]
        else:
            cols = torch.tensor([i * D + d for i in ids for d in range(D)],
                                device=x.device)
            xk, xv = xk.index_select(-1, cols), xv.index_select(-1, cols)
    n_kv = xk.shape[-1] // D
    q = rope_lib.apply_rope(cfg, xq.reshape(B, S, n_q, D), positions)
    k = rope_lib.apply_rope(cfg, xk.reshape(B, S, n_kv, D), positions)
    v = xv.reshape(B, S, n_kv, D)
    flat_pos = positions[:, -1, :] if positions.ndim == 3 else positions

    scale = 1.0 / (D ** 0.5)
    new_cache = layer_cache
    if layer_cache is None:
        if recorded(q, k, v):
            refuse_pallas("attention_impl", cfg.attention_impl)
        out = fa_ops.flash_attention_with_vjp(
            q, k, v, window=cfg.sliding_window, scale=scale)
    else:
        slots = _slots_for(cfg, flat_pos)
        start = _slot_start(layer_cache, "pos", sw)
        new_cache = _write_slots(layer_cache,
                                 {"k": k, "v": v, "pos": flat_pos}, slots,
                                 drop_past, start)
        kc, vc, pc = new_cache["k"], new_cache["v"], new_cache["pos"]
        bias = causal_mask_bias(flat_pos, pc, cfg.sliding_window, pc >= 0)
        sdt = DTYPES[cfg.attention_scores_dtype]
        if sw is None:
            out = softmax_attention(q, kc, vc, bias, scale, sdt)
        else:
            out = _slot_attention(q, kc, vc, bias, scale, sdt, sw)
    out = out.reshape(B, S, n_q * D)
    if tp is None:
        return out @ p["wo"].to(cdt), new_cache
    if n_q == H:
        # every query head: the columns that meet the rank's rows of wo
        width = H * D // m
        out = out[..., r * width:(r + 1) * width]
    return (reduce_from_model(out @ p["wo"].to(cdt), tp, "attn_out"),
            new_cache)


def _slot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, scale: float,
                    scores_dtype: torch.dtype, sw) -> torch.Tensor:
    """``softmax_attention``'s scores (GQA heads gathered onto the query
    heads, the scores and mask in ``scores_dtype``) over the rank's
    slots, combined over the slot axis ``sw`` by :func:`_sweep` in fp32;
    cast to q's dtype."""
    H, K = q.shape[2], k.shape[2]
    if H != K:
        idx = torch.arange(H, device=k.device) // (H // K)
        k = k.index_select(2, idx)
        v = v.index_select(2, idx)
    sdt = scores_dtype
    scores = torch.einsum("bqhd,bshd->bhqs", q.to(sdt), k.to(sdt))
    scores = scores * torch.tensor(scale, dtype=sdt) + bias.to(sdt)
    out = _sweep(scores.to(torch.float32),
                 v.to(sdt).to(torch.float32), "bhqs,bshd->bqhd", sw)
    return out.to(q.dtype)


def _kv_heads_of(h0: int, n_q: int, group: int):
    """The kv heads that query heads h0 .. h0 + n_q − 1 read (GQA group
    ``group``): (first, count) when each reads kv head first + j //
    (n_q / count), else the per-query-head list."""
    ids = [(h0 + j) // group for j in range(n_q)]
    first, n = ids[0], ids[-1] - ids[0] + 1
    if n_q % n == 0 and ids == [first + j // (n_q // n) for j in range(n_q)]:
        return first, n, None
    return first, n, ids


def cross_attention(cfg, p: dict, x: torch.Tensor,
                    cond: Optional[torch.Tensor],
                    layer_cache: Optional[dict] = None):
    """MHA cross-attention to a (B, Lc, E) conditioning sequence. x:
    (B, S, E); layer_cache: this layer's ``{"ck", "cv"}`` or None.
    Returns (out, ``{"ck", "cv"}``).

    As in the reference, a cache's keys and values are taken whenever
    there is one, and ``cond`` is then not read (the serving engines'
    caches hold zeros); without one, k and v are ``cond``'s projections.
    The scores are fp32 whatever ``attention_scores_dtype`` says (the
    reference passes it no scores dtype), unmasked. Every weight may
    carry a leading batch axis (the group engine's per-slot weights).

    On the model axis, where the heads divide over it, ``wq`` / ``wk`` /
    ``wv`` are the rank's heads' columns, ``wo`` their rows and the
    cache's ``ck`` / ``cv`` their keys and values: the rank attends its
    heads and its partial product is all-reduced. Where they do not,
    every weight and the cache are whole on every rank and the layer
    runs its one-device form (``shardings.placement_spec``)."""
    B, S, _ = x.shape
    H, D = cfg.n_heads, cfg.head_dim
    cdt = cfg.dtype("compute")
    tp = split_axis(cfg, "heads", H)
    n = H if tp is None else H // tp.size
    if tp is not None:
        x = copy_to_model(x, tp)
    q = (x @ p["wq"].to(cdt)).reshape(B, S, n, D)
    if layer_cache is not None:
        k, v = layer_cache["ck"], layer_cache["cv"]
    else:
        Lc = cond.shape[1]
        k = (cond @ p["wk"].to(cdt)).reshape(B, Lc, n, D)
        v = (cond @ p["wv"].to(cdt)).reshape(B, Lc, n, D)
    bias = torch.zeros((B, 1, S, k.shape[1]), dtype=torch.float32,
                       device=x.device)
    out = softmax_attention(q, k, v, bias, 1.0 / (D ** 0.5))
    out = out.reshape(B, S, n * D) @ p["wo"].to(cdt)
    if tp is not None:
        out = reduce_from_model(out, tp, "xattn_out")
    return out, {"ck": k, "cv": v}


def _heads(w: torch.Tensor, r: int, H: int, d: int) -> torch.Tensor:
    """An up-projection (r, H·d), or per row (B, r, H·d), as (…, r, H,
    d)."""
    return w.reshape(w.shape[:-2] + (r, H, d))


def mla_attention(cfg, p: dict, x: torch.Tensor, positions: torch.Tensor,
                  layer_cache: Optional[dict] = None,
                  drop_past: bool = False):
    """DeepSeek-V2 Multi-head Latent Attention. x: (B, S, E);
    positions: (B, S); layer_cache: this layer's ``{"ckv", "k_rope",
    "pos"}`` or None. Returns (out, new_layer_cache). Every weight may
    carry a leading batch axis, one row's weights each (the group
    engine's slots): the up-projections then read (B, r, H, d) and the
    absorbed products gain a ``b``.

    The queries split into a no-rope part and a rotary part; the
    latent ``ckv`` (RMSNorm of the down-projection's first r columns)
    and the one shared rotary key are what a cache keeps. With a cache
    whose T slots outnumber the S queries and ``cfg.mla_absorb`` (a
    decode step, or a prefill into a wider cache), it takes the
    absorbed branch: the query scored against the latent directly,
    (q_nope W_ukᵀ)·ckv + q_rope·k_rope, in fp32 whatever
    ``attention_scores_dtype`` says, and the context (probs·ckv) W_uv.
    Otherwise (a cache-free pass, a cache no wider than the pass, or
    ``mla_absorb=False``) it re-expands per-head keys and values from
    the latent and calls ``softmax_attention`` with
    ``attention_scores_dtype``. Both are the reference's branches and
    round differently in bf16, so the condition is the reference's.
    Neither reaches the flash kernel (Dk = dn + dr differs from Dv).
    ``drop_past`` drops the cache writes at slots past the cache, as
    :func:`self_attention`'s.

    On the model axis ``wq``, ``w_uk`` and ``w_uv`` hold the rank's heads
    (whole where the heads do not divide the axis) and ``wo`` its rows;
    ``w_dkv`` and ``ln_ckv`` stay replicated, so each rank computes the
    latent and the rotary key whole. Both branches run the rank's heads.
    With a cache under ``serve_rules`` the latent cache's slots lie over
    the ``"kv_slots"`` axis: the absorbed branch all-gathers the rank's
    heads' ``q_lat`` and rotary queries, scores every head against the
    slots it holds and combines over the axis (the module docstring's
    sweep), then takes its heads' context through ``w_uv``; the
    expanded branch, which needs every head's keys, all-gathers the
    split ``w_uk`` / ``w_uv`` as well. The branch condition reads the
    cache's width as its local slots times the axis size, the global
    width of a split cache."""
    mc = cfg.mla
    B, S, _ = x.shape
    H, r = cfg.n_heads, mc.kv_lora_rank
    dn, dr, dv = mc.qk_nope_dim, mc.qk_rope_dim, mc.v_dim
    cdt = cfg.dtype("compute")
    f32 = torch.float32
    tp = split_axis(cfg, "heads", H * dv)
    sw = None if layer_cache is None else mesh_axis("kv_slots")
    split, n_h, h0 = False, H, 0
    if tp is not None:
        split = H % tp.size == 0
        if split:
            n_h, h0 = H // tp.size, tp.rank * (H // tp.size)
        x = copy_to_model(x, tp)

    def weight(name, split):
        return _weight(p, name, split, tp)

    q = (x @ weight("wq", split).to(cdt)).reshape(B, S, n_h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope_lib.rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ weight("w_dkv", False).to(cdt)
    ckv = rms_norm(dkv[..., :r], weight("ln_ckv", False), cfg.norm_eps)
    k_rope = dkv[..., r:][:, :, None, :]                  # 1 shared head
    k_rope = rope_lib.rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]

    new_cache = layer_cache
    if layer_cache is not None:
        slots = _slots_for(cfg, positions)
        start = _slot_start(layer_cache, "pos", sw)
        new_cache = _write_slots(
            layer_cache, {"ckv": ckv, "k_rope": k_rope, "pos": positions},
            slots, drop_past, start)
        ckv_all, k_rope_all, k_pos = (new_cache["ckv"], new_cache["k_rope"],
                                      new_cache["pos"])
        k_valid = k_pos >= 0
    else:
        ckv_all, k_rope_all, k_pos, k_valid = ckv, k_rope, positions, None

    T = ckv_all.shape[1]
    width = T if sw is None else T * sw.size
    bias = causal_mask_bias(positions, k_pos, cfg.sliding_window, k_valid)
    scale = 1.0 / ((dn + dr) ** 0.5)
    wuk = weight("w_uk", split)
    wuv = weight("w_uv", split)
    b = "b" if wuk.ndim == 3 else ""

    if cfg.mla_absorb and layer_cache is not None and S < width:
        q_lat = torch.einsum(f"bqhd,{b}rhd->bqhr", q_nope,
                             _heads(wuk.to(cdt), r, n_h, dn))
        if sw is None:
            s_nope = torch.einsum("bqhr,btr->bhqt", q_lat.to(f32),
                                  ckv_all.to(f32))
            s_rope = torch.einsum("bqhd,btd->bhqt", q_rope.to(f32),
                                  k_rope_all.to(f32))
            probs = torch.softmax((s_nope + s_rope) * scale + bias, dim=-1)
            ctx = torch.einsum("bhqt,btr->bqhr", probs, ckv_all.to(f32))
        else:
            if split:
                q_lat, q_rope = _gather_heads(
                    torch.cat([q_lat, q_rope], dim=-1), tp,
                    "q_gather").split([r, dr], dim=-1)
            s_nope = torch.einsum("bqhr,btr->bhqt", q_lat.to(f32),
                                  ckv_all.to(f32))
            s_rope = torch.einsum("bqhd,btd->bhqt", q_rope.to(f32),
                                  k_rope_all.to(f32))
            ctx = _sweep((s_nope + s_rope) * scale + bias, ckv_all.to(f32),
                         "bhqt,btr->bqhr", sw)[:, :, h0:h0 + n_h]
        out = torch.einsum(f"bqhr,{b}rhv->bqhv", ctx.to(cdt),
                           _heads(wuv.to(cdt), r, n_h, dv))
    else:
        sdt = DTYPES[cfg.attention_scores_dtype]
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        if sw is not None and split:
            qfull = _gather_heads(qfull, tp, "q_gather")
            wuk = gather_from_model(wuk, tp, "w_gather")
            wuv = gather_from_model(wuv, tp, "w_gather")
        n = qfull.shape[2]
        k_nope = (ckv_all @ wuk.to(cdt)).reshape(B, T, n, dn)
        vv = (ckv_all @ wuv.to(cdt)).reshape(B, T, n, dv)
        k = torch.cat([k_nope, k_rope_all[:, :, None, :].expand(
            B, T, n, dr)], dim=-1)
        if sw is None:
            out = softmax_attention(qfull, k, vv, bias, scale, sdt)
        else:
            out = _slot_attention(qfull, k, vv, bias, scale, sdt, sw)
    n = out.shape[2]
    out = out.reshape(B, S, n * dv)
    if tp is None:
        return out @ p["wo"].to(cdt), new_cache
    if n == H:
        # every head: the columns that meet the rank's rows of wo
        cols = H * dv // tp.size
        out = out[..., tp.rank * cols:(tp.rank + 1) * cols]
    return (reduce_from_model(out @ p["wo"].to(cdt), tp, "attn_out"),
            new_cache)
