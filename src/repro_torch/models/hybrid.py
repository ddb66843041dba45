"""Zamba2-style hybrid — the port of ``repro.models.hybrid``: super-blocks
of Mamba2 layers, each followed by one call of a SHARED attention/MLP
block whose seven weights take a per-call-site LoRA delta
(arXiv:2411.15242), then tail Mamba2 layers.

Parameters keep the reference's pytree: ``{"embed", "final_norm",
"lm_head", "shared": {"ln1", "attn", "ln2", "mlp"}, "mamba_blocks":
{"ln", "mamba"} (leaves (nb, mpb, ...)), "lora": {name: {"a", "b"}}
(leaves (nb, ...)), "tail": {"ln", "mamba"} (leaves (tail, ...))}``, and
so does the cache (``{"mamba": (nb, mpb, B, ...), "kv": {"k", "v",
"pos"} (nb, B, ...), "tail": (tail, B, ...)}``). The reference scans
over the super-blocks and the layers; here Python loops take each
one's views.

Every cache-free pass runs the SSD kernel in each Mamba2 sub-layer and
the flash attention in each call of the shared block
(``repro_torch.models.attention``); a pass with a cache attends over
its slots instead, as the reference does.

On a model axis the Mamba2 layers run their rank's SSD heads
(``repro_torch.models.mamba2``), the shared block runs the split
attention (its KV cache's slots over ``"kv_slots"`` when serving) and
the split SwiGLU, the embedding and head are vocab-parallel (the full
logits gathered, the loss vocab-parallel), and a cache is the rank's
slice (``shardings.local_cache``). The reference forms W + a·b at each
call site with W split and the LoRA factors whole; here each rank forms
its slice of the sum (:func:`_merge_lora`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.sharding import mesh_axis
from repro_torch.common.pytree import (init_stacked, layer, pick_rows,
                                       sliced, slot_layer, stack_layers,
                                       tree_map, unstack_layers)
from repro_torch.models import attention as attn
from repro_torch.models.common import (copy_to_model, cross_entropy,
                                       dense_init, embed_init, embed_rows,
                                       gather_from_model,
                                       rms_norm, split_axis, vocab_split)
from repro_torch.models.mamba2 import (init_mamba2, make_mamba_state,
                                       mamba2_decode, mamba2_forward)
from repro_torch.models.mlp import init_swiglu, swiglu

_LORA_TARGETS = {
    "attn": ("wq", "wk", "wv", "wo"),
    "mlp": ("w_gate", "w_up", "w_down"),
}


def _lora_shapes(cfg) -> dict:
    E, H, K, D, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.head_dim, cfg.d_ff)
    return {
        "wq": (E, H * D), "wk": (E, K * D), "wv": (E, K * D),
        "wo": (H * D, E),
        "w_gate": (E, F), "w_up": (E, F), "w_down": (F, E),
    }


def _init_lora(cfg, gen: torch.Generator, shapes: dict, device) -> dict:
    """One call site's factors: ``a`` (din, r) of fan-in scale, ``b``
    (r, dout) zero, so the delta starts at 0, as in the reference."""
    r = cfg.hybrid.lora_rank
    dt = cfg.dtype("param")
    return {name: {"a": dense_init(gen, (din, r), dt, device=device),
                   "b": torch.zeros((r, dout), dtype=dt, device=device)}
            for name, (din, dout) in shapes.items()}


def _merge_lora(shared: dict, lora: dict, cdt: torch.dtype,
                tp=None) -> dict:
    """Effective weights for one call site: W + A·B, each cast to the
    compute dtype first and the sum formed in it, as the reference
    does. With per-row weights (leaves (B, ...), the group engine's
    slots) the products are batched, one row's delta each. On the model
    axis ``tp`` a split W is the rank's slice and takes the same slice
    of the delta: A·B[:, cols] for a column target (``wq``, ``wk``,
    ``wv``, ``w_gate``, ``w_up``), A[rows]·B for a row target (``wo``,
    ``w_down``); their factors enter through ``copy_to_model``, so their
    gradients sum the ranks' parts. A target placed whole takes the
    whole delta (the layer that reads it sums its gradient)."""
    out = dict(shared)
    out["attn"] = dict(shared["attn"])
    out["mlp"] = dict(shared["mlp"])
    for grp, names in _LORA_TARGETS.items():
        for n in names:
            w, a, b = shared[grp][n], lora[n]["a"], lora[n]["b"]
            if tp is not None and w.shape[-1] < b.shape[-1]:
                c = w.shape[-1]
                a = copy_to_model(a, tp)
                b = copy_to_model(b, tp)[..., tp.rank * c:(tp.rank + 1) * c]
            elif tp is not None and w.shape[-2] < a.shape[-2]:
                r = w.shape[-2]
                a = copy_to_model(a, tp)[..., tp.rank * r:(tp.rank + 1) * r,
                                         :]
                b = copy_to_model(b, tp)
            out[grp][n] = w.to(cdt) + a.to(cdt) @ b.to(cdt)
    return out


def init_hybrid(cfg, gen: Optional[torch.Generator], device=None) -> dict:
    """The parameters on ``device`` (``None``: the card); ``gen`` must
    live on that device. The nested stacks are filled one layer at a
    time (22.7 GB of fp32 weights at zamba2-7b). Under ``common.pytree.
    slicing`` each drawn tree is cut to the rank's slice at once."""
    hy = cfg.hybrid
    dev = resolve_device(device)
    dt = cfg.dtype("param")
    E = cfg.d_model

    def ones():
        return torch.ones((E,), dtype=dt, device=dev)

    params = {
        "embed": sliced(("embed",), embed_init(
            gen, (cfg.vocab_size, E), dt, dev)),
        "final_norm": sliced(("final_norm",), ones()),
        "lm_head": sliced(("lm_head",), dense_init(
            gen, (E, cfg.vocab_size), dt, device=dev)),
    }
    params["shared"] = sliced(("shared",), {
        "ln1": ones(),
        "attn": attn.init_self_attention(cfg, gen, dev),
        "ln2": ones(),
        "mlp": init_swiglu(gen, E, cfg.d_ff, dt, dev),
    })

    def one_mamba():
        return {"ln": ones(), "mamba": init_mamba2(cfg, gen, dev)}

    params["mamba_blocks"] = init_stacked(
        (hy.n_super_blocks, hy.mamba_per_block), one_mamba,
        ("mamba_blocks",))
    shapes = _lora_shapes(cfg)
    params["lora"] = init_stacked(
        hy.n_super_blocks, lambda: _init_lora(cfg, gen, shapes, dev),
        ("lora",))
    if hy.tail_mamba:
        params["tail"] = init_stacked(hy.tail_mamba, one_mamba, ("tail",))
    return params


def _shared_block(cfg, weights: dict, x: torch.Tensor,
                  positions: torch.Tensor, kv_cache: Optional[dict],
                  decode: bool):
    h = rms_norm(x, weights["ln1"], cfg.norm_eps)
    a, new_kv = attn.self_attention(cfg, weights["attn"], h, positions,
                                    kv_cache, drop_past=not decode)
    x = x + a
    h2 = rms_norm(x, weights["ln2"], cfg.norm_eps)
    x = x + swiglu(weights["mlp"], h2, cfg.dtype("compute"),
                   split_axis(cfg, "ff", cfg.d_ff))
    return x, new_kv


def _mamba_sublayer(cfg, lp: dict, x: torch.Tensor,
                    lstate: Optional[dict], decode: bool):
    h = rms_norm(x, lp["ln"], cfg.norm_eps)
    fn = mamba2_decode if decode else mamba2_forward
    o, new_state = fn(cfg, lp["mamba"], h, lstate)
    return x + o, new_state


def _run(cfg, params: dict, batch: dict, cache: Optional[dict],
         decode: bool, agents: Optional[torch.Tensor]):
    """:func:`hybrid_forward`'s pass: (the logits as the rank holds
    them, the new cache or None, the vocab's model axis or None)."""
    hy = cfg.hybrid
    nb, mpb, nt = hy.n_super_blocks, hy.mamba_per_block, hy.tail_mamba
    cdt = cfg.dtype("compute")
    positions = batch["positions"]
    want_cache = cache is not None
    vocab = vocab_split(cfg) if agents is None else None
    tp = mesh_axis("ff") if agents is None else None
    x = embed_rows(cfg, params, batch["tokens"], agents, vocab)
    if agents is None:
        shared = params["shared"]
        blocks = [unstack_layers(b, mpb) for b in
                  unstack_layers(params["mamba_blocks"], nb)]
        loras = unstack_layers(params["lora"], nb)
        tails = unstack_layers(params["tail"], nt) if nt else []
    else:
        shared = slot_layer(params["shared"], agents)

    def state(key, *index):
        """This layer's slice of ``cache[key]``, None without a cache."""
        if not want_cache:
            return None
        tree = cache[key]
        for i in index:
            tree = layer(tree, i)
        return tree

    new_m, new_kv = [], []
    for i in range(nb):
        states = []
        for j in range(mpb):
            lp = (blocks[i][j] if agents is None
                  else slot_layer(params["mamba_blocks"], agents, i, j))
            x, st = _mamba_sublayer(cfg, lp, x, state("mamba", i, j),
                                    decode)
            states.append(st)
        lora = (loras[i] if agents is None
                else slot_layer(params["lora"], agents, i))
        x, kv = _shared_block(cfg, _merge_lora(shared, lora, cdt, tp), x,
                              positions, state("kv", i), decode)
        new_m.append(states)
        new_kv.append(kv)

    new_tail = []
    for j in range(nt):
        lp = (tails[j] if agents is None
              else slot_layer(params["tail"], agents, j))
        x, st = _mamba_sublayer(cfg, lp, x, state("tail", j), decode)
        new_tail.append(st)

    norm, head = params["final_norm"], params["lm_head"]
    if agents is not None:
        norm, head = pick_rows(norm, agents), pick_rows(head, agents)
    x = rms_norm(x, norm, cfg.norm_eps)
    if vocab is not None:
        x = copy_to_model(x, vocab)
    logits = x @ head.to(cdt)
    new_cache = None
    if want_cache:
        new_cache = {"mamba": stack_layers([stack_layers(s)
                                            for s in new_m]),
                     "kv": stack_layers(new_kv),
                     "tail": stack_layers(new_tail) if nt else None}
    return logits, new_cache, vocab


def hybrid_forward(cfg, params: dict, batch: dict,
                   cache: Optional[dict] = None, decode: bool = False,
                   agents: Optional[torch.Tensor] = None):
    """Full-sequence pass (scoring / prefill), or with ``decode`` one
    token. Returns (logits, aux = 0, new cache or None). A prefill into
    a cache runs its whole right-padded width, which may pass the KV
    slots: the KV writes past them are dropped, as the reference's are,
    while the pads run on through the Mamba2 states, which keep them.
    The caller checks that the real tokens fit (``api.prefill``), and a
    decode step's caller checks the fit too. With ``agents`` (B,) (long, on the planes' device),
    ``params`` are stacked planes (leaves (A, ...)) and row b runs under
    agent ``agents[b]``'s weights, each gathered at its own depth just
    before it runs: the shared block once a step, a call site's LoRA
    factors and each Mamba2 layer as they come (B copies of one). On a
    model axis the logits are the full rows on every rank."""
    logits, new_cache, vocab = _run(cfg, params, batch, cache, decode,
                                    agents)
    if vocab is not None:
        logits = gather_from_model(logits, vocab, "logits")
    return logits, torch.zeros((), dtype=torch.float32), new_cache


def hybrid_decode(cfg, params: dict, batch: dict, cache: dict,
                  agents: Optional[torch.Tensor] = None):
    """One-token decode. batch: tokens (B, 1), positions (B, 1), which
    the caller has checked against the cache (``check_fits``): nothing
    here reads a value back from the card. ``agents``: as
    :func:`hybrid_forward`."""
    logits, _, new_cache = hybrid_forward(cfg, params, batch, cache,
                                          decode=True, agents=agents)
    return logits, new_cache


def hybrid_loss(cfg, params: dict, batch: dict) -> torch.Tensor:
    """Token-mean cross-entropy of a cache-free pass over ``labels``
    (−100 ignored; vocab-parallel on a model axis) plus the aux term
    (0)."""
    logits, _, vocab = _run(cfg, params, batch, None, False, None)
    return cross_entropy(logits, batch["labels"], vocab=vocab)


def make_hybrid_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """The Mamba2 states, the shared block's KV caches and the tail's
    states; under installed rules and a mesh the rank's slice of a
    global ``batch``'s (``shardings.local_cache``)."""
    from repro_torch.launch.shardings import local_cache
    local = local_cache(cfg, batch, max_len, device)
    if local is not None:
        return local
    hy = cfg.hybrid
    nb, mpb = hy.n_super_blocks, hy.mamba_per_block
    return {
        "mamba": tree_map(
            lambda x: x.reshape((nb, mpb) + tuple(x.shape[1:])),
            make_mamba_state(cfg, batch, nb * mpb, device=device)),
        "kv": attn.make_kv_cache(cfg, batch, max_len, nb, device=device),
        "tail": make_mamba_state(cfg, batch, hy.tail_mamba, device=device),
    }


def kv_pos(cache: dict) -> torch.Tensor:
    """The KV cache's slot positions (nb, B, slots)."""
    return cache["kv"]["pos"]
