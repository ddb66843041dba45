"""Port parity: the audio family (``family="audio"``: summed codebook
embeddings, sinusoidal positions, cross-attention to a conditioning
sequence in every layer, a GELU MLP and one head per codebook) at
musicgen-medium ``reduced()`` (2 layers, d_model 256, 4 heads of 32,
MHA, 4 codebooks of 512, cond_len 8, fp32), against ``repro.models``
and ``repro.serving`` on the reference's own weights, carried across by
``repro_torch.interop``. The reference runs ``attention_impl="xla"``.

Tolerances, as ``tests/test_torch_transformer.py`` states them:

* sinusoidal positions: atol = 1e-6 + 2.5e-7 · the largest position.
  XLA's fp32 ``exp`` is not correctly rounded (15 of 128 frequencies at
  dim 256 are one unit in the last place off the fp64 value; torch's,
  3), and the angle position × frequency carries that relative 1.2e-7
  (two units: 2.5e-7) times the position;
* blocks (the GELU MLP, cross-attention), logits, caches and losses in
  fp32: rtol = atol = 1e-4 (the same fp32 ops, summed in other orders);
* tokens: equal.

What is held: ``sinusoidal_positions``; ``gelu_mlp`` (GELU's tanh
approximation, which ``jax.nn.gelu`` takes by default, not torch's
exact default); ``cross_attention`` without a cache and with a filled
one, and with per-row weights; the scoring pass's logits (B, C, S, V)
and loss over a delay-pattern batch with a non-zero ``cond``;
``ServeEngine`` prefill logits, cache (``xkv`` included) and greedy
tokens; the ``ContinuousBatcher`` and ``GroupServeEngine`` tokens;
per-slot weights; the cache carried both ways; decode with every tensor
read patched to raise; and the reference's behaviours the port
reproduces on purpose (ROADMAP §3): serving never reads ``cond``, and
decode feeds one token to every codebook and samples codebook 0.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as r_attn  # noqa: E402
from repro.models import common as r_common  # noqa: E402
from repro.models import mlp as r_mlp  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.common.pytree import layer, tree_map  # noqa: E402
from repro_torch.models import (attention, common, get_model,  # noqa: E402
                                mlp, transformer)
from repro_torch.serving import api  # noqa: E402
from test_torch_vlm import (PROMPTS, TOL, _np, agents_decode_matches_own,  # noqa: E402,E501
                            both_params, cache_both_ways, cfgs, close_tree,
                            continuous_both, decode_reads_nothing_back,
                            group_both, score_both, serve_both)

ARCH = "musicgen-medium"
MAX_LEN = 48


# ---------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dim", [256, 1536])
def test_sinusoidal_positions_match_reference(dim):
    """Positions up to 1500 (MusicGen's 30 s at 50 Hz), within 1e-6 +
    2.5e-7 · 1500 (the module docstring); [sin | cos] halves."""
    pos = np.random.default_rng(dim).integers(0, 1500, (2, 30)).astype(
        np.int32)
    want = r_common.sinusoidal_positions(jnp.asarray(pos), dim)
    got = common.sinusoidal_positions(torch.from_numpy(pos), dim)
    assert got.shape == (2, 30, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 + 2.5e-7 * pos.max())
    zero = common.sinusoidal_positions(torch.zeros((1, 1), dtype=torch.int32),
                                       dim)
    assert torch.equal(zero[0, 0], torch.cat([torch.zeros(dim // 2),
                                              torch.ones(dim // 2)]))


def _mlp_params(rng, E=64, F=96):
    return {"w1": rng.normal(size=(E, F)).astype(np.float32) * 0.3,
            "b1": rng.normal(size=(F,)).astype(np.float32),
            "w2": rng.normal(size=(F, E)).astype(np.float32) * 0.1,
            "b2": rng.normal(size=(E,)).astype(np.float32)}


def test_gelu_mlp_matches_reference_with_the_tanh_gelu():
    """``gelu_mlp`` within 1e-4 of the reference's, whose
    ``jax.nn.gelu`` is the tanh approximation; torch's exact default
    parts from it by more than that tolerance on these inputs."""
    rng = np.random.default_rng(1)
    p = _mlp_params(rng)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    want = np.asarray(r_mlp.gelu_mlp({k: jnp.asarray(v) for k, v in
                                      p.items()}, jnp.asarray(x),
                                     jnp.float32))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = mlp.gelu_mlp(tp, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    h = torch.from_numpy(x) @ tp["w1"] + tp["b1"]
    exact = torch.nn.functional.gelu(h) @ tp["w2"] + tp["b2"]
    assert np.abs(exact.numpy() - want).max() > 5 * TOL["atol"]


def test_per_row_gelu_weights_match_each_rows_own():
    """Weights with a leading batch axis (the group engine's slots):
    row b under its own weights, biases included."""
    rows = [_mlp_params(np.random.default_rng(s)) for s in (2, 3)]
    stacked = {k: torch.stack([torch.from_numpy(r[k]) for r in rows])
               for k in rows[0]}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 5, 64)).astype(np.float32))
    got = mlp.gelu_mlp(stacked, x, torch.float32)
    for b, r in enumerate(rows):
        want = mlp.gelu_mlp({k: torch.from_numpy(v) for k, v in r.items()},
                            x[b:b + 1], torch.float32)
        torch.testing.assert_close(got[b:b + 1], want, rtol=1e-5, atol=1e-5)


def _xattn_case(cached):
    rcfg, cfg = cfgs(ARCH)
    ref, _ = both_params(ARCH)
    p = jax.tree.map(lambda a: a[0], ref["layers"]["xattn"])
    rng = np.random.default_rng(5)
    H, D, Lc = cfg.n_heads, cfg.head_dim, cfg.cond_len
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    cond = rng.normal(size=(2, Lc, cfg.d_model)).astype(np.float32)
    cache = ({"ck": rng.normal(size=(2, Lc, H, D)).astype(np.float32),
              "cv": rng.normal(size=(2, Lc, H, D)).astype(np.float32)}
             if cached else None)
    want, wcache = r_attn.cross_attention(
        rcfg, p, jnp.asarray(x), jnp.asarray(cond),
        None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, gcache = attention.cross_attention(
        cfg, tree_map(lambda a: torch.from_numpy(np.array(a)), p),
        torch.from_numpy(x), torch.from_numpy(cond),
        None if cache is None else tree_map(torch.from_numpy, cache))
    return (got, gcache), (want, wcache), cache


@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_matches_reference(cached):
    """Without a cache k and v are ``cond``'s projections; with one,
    the cache's ``ck`` / ``cv`` are taken (``cond`` unread) and handed
    back: out and keys within 1e-4."""
    (got, gcache), (want, wcache), cache = _xattn_case(cached)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    close_tree(tree_map(lambda t: t.numpy(), gcache),
               jax.tree.map(np.asarray, wcache))
    if cached:
        assert np.array_equal(gcache["ck"].numpy(), cache["ck"])


def test_per_row_cross_attention_weights_match_each_rows_own():
    _, cfg = cfgs(ARCH)
    _, pp = both_params(ARCH)
    _, pp1 = both_params(ARCH, 1)
    rows = [layer(pp["layers"]["xattn"], 0), layer(pp1["layers"]["xattn"], 1)]
    stacked = tree_map(lambda a, b: torch.stack([a, b]), *rows)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 3, cfg.d_model)).astype(
        np.float32))
    cond = torch.from_numpy(rng.normal(size=(2, cfg.cond_len, cfg.d_model))
                            .astype(np.float32))
    got, _ = attention.cross_attention(cfg, stacked, x, cond)
    for b in range(2):
        want, _ = attention.cross_attention(cfg, rows[b], x[b:b + 1],
                                            cond[b:b + 1])
        torch.testing.assert_close(got[b:b + 1], want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# the model: scoring
# ---------------------------------------------------------------------
def _audio_batch(cfg, S=20, seed=1):
    """B = 2 delay-pattern rows: codebook c shifted right by c behind
    token 0, labels −100 where t < c, positions 0..S−1, a non-zero
    ``cond`` (normal)."""
    rng = np.random.default_rng(seed)
    C = cfg.n_codebooks
    toks = np.zeros((2, C, S), np.int32)
    for c in range(C):
        toks[:, c, c:] = rng.integers(0, cfg.vocab_size, (2, S - c))
    delay = np.arange(S)[None, None, :] < np.arange(C)[None, :, None]
    return {"tokens": toks,
            "labels": np.where(delay, -100, toks).astype(np.int32),
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (2, S)).copy(),
            "cond": rng.normal(size=(2, cfg.cond_len, cfg.d_model)
                               ).astype(np.float32)}


def test_scoring_logits_and_loss_match_reference():
    """The cache-free pass: logits (B, C, S, V) and the loss over every
    codebook's labels within 1e-4; ``cond`` moves them."""
    _, cfg = cfgs(ARCH)
    batch = _audio_batch(cfg)
    (got, got_loss), (want, want_loss) = score_both(ARCH, batch)
    assert got.shape == (2, cfg.n_codebooks, 20, cfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_loss, want_loss, **TOL)
    (other, _), _ = score_both(ARCH, {**batch, "cond": batch["cond"] * 0})
    assert not np.allclose(other, got, **TOL)


def test_embedding_sums_the_codebooks_in_order():
    """The input rows: the C codebook tables' rows summed in codebook
    order plus the sinusoidal positions."""
    _, cfg = cfgs(ARCH)
    _, pp = both_params(ARCH)
    b = {k: torch.from_numpy(v) for k, v in _audio_batch(cfg).items()}
    x = transformer._embed(cfg, pp, b)
    want = 0
    for c in range(cfg.n_codebooks):
        want = want + pp["embed"][c][b["tokens"][:, c].long()]
    want = want + common.sinusoidal_positions(b["positions"], cfg.d_model)
    assert torch.equal(x, want)


# ---------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------
def test_serve_engine_prefill_and_decode_match_reference():
    """ServeEngine on 2 right-padded prompts: codebook 0's next-token
    logits and every cache leaf (``kv`` and the zero ``xkv``) within
    1e-4, greedy tokens equal."""
    (nxt, cache, toks), (rnxt, rcache, rtoks) = serve_both(ARCH)
    np.testing.assert_allclose(nxt, rnxt, **TOL)
    assert sorted(cache["layers"]) == ["kv", "xkv"]
    close_tree(cache, rcache)
    np.testing.assert_array_equal(toks, rtoks)


def test_continuous_batcher_matches_reference():
    got, want = continuous_both(ARCH, [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10,
                                                    11, 12], [14, 15]])
    assert got == want


def test_group_engine_matches_reference():
    got, want = group_both(ARCH, [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12],
                                  [14, 15]])
    assert got == want


def test_agents_decode_matches_each_agents_own_decode():
    agents_decode_matches_own(ARCH)


def test_cache_carries_both_ways():
    cache_both_ways(ARCH)


def test_decode_reads_nothing_back():
    decode_reads_nothing_back(ARCH)


def test_cache_batch_dims_of_the_cross_attention_cache():
    """The slot plumbing finds batch dim 1 in ``ck`` / ``cv``
    (n_layers, B, cond_len, H, D)."""
    _, cfg = cfgs(ARCH)
    dims = api.cache_batch_dims(cfg, 16)
    assert dims["layers"]["xkv"] == {"ck": 1, "cv": 1}
    cache = get_model(cfg).make_cache(cfg, 3, 16, device="cpu")
    assert cache["layers"]["xkv"]["ck"].shape == (
        cfg.n_layers, 3, cfg.cond_len, cfg.n_heads, cfg.head_dim)


# ---------------------------------------------------------------------
# the reference's behaviours, reproduced on purpose (ROADMAP §3)
# ---------------------------------------------------------------------
def test_serving_never_reads_cond():
    """A pass with a cache takes the cache's zero ``ck`` / ``cv``
    whatever ``cond`` it is given, as the reference's does: a prefill
    with a random ``cond`` gives bitwise the logits and cache of the
    zero ``cond`` ``build_prefill_batch`` makes, and the reference's
    with the same random ``cond``."""
    rcfg, cfg = cfgs(ARCH)
    rp, pp = both_params(ARCH)
    model = get_model(cfg)
    toks, _ = serving.serve_batches(PROMPTS, 2, device="cpu")[0]
    batch = api.build_prefill_batch(cfg, toks)
    assert not bool(batch["cond"].any())
    cond = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(batch["cond"].shape)).astype(np.float32))
    with torch.no_grad():
        zero, zcache = model.forward(cfg, pp, batch, model.make_cache(
            cfg, 2, MAX_LEN, device="cpu"))
        rand, rcache = model.forward(cfg, pp, {**batch, "cond": cond},
                                     model.make_cache(cfg, 2, MAX_LEN,
                                                      device="cpu"))
    assert torch.equal(zero, rand)
    assert not bool(rcache["layers"]["xkv"]["ck"].any())
    rmodel = r_model.get_model(rcfg)
    want, _ = rmodel.forward(rcfg, rp, {
        "tokens": jnp.asarray(batch["tokens"].numpy()),
        "positions": jnp.asarray(batch["positions"].numpy()),
        "cond": jnp.asarray(cond.numpy())}, rmodel.make_cache(rcfg, 2,
                                                              MAX_LEN))
    np.testing.assert_allclose(_np(rand), np.asarray(want), **TOL)


def test_decode_feeds_one_token_to_every_codebook():
    """The decode batch repeats the sampled token in every codebook
    (B, C, 1) and the engines sample codebook 0's logits: the
    ServeEngine's tokens are codebook 0's greedy picks step by step."""
    _, cfg = cfgs(ARCH)
    _, pp = both_params(ARCH)
    model = get_model(cfg)
    toks, lens = serving.serve_batches(PROMPTS, 2, device="cpu")[0]
    b = api.decode_batch(cfg, torch.tensor([[3], [4]], dtype=torch.int32),
                         lens[:, None])
    assert b["tokens"].shape == (2, cfg.n_codebooks, 1)
    assert bool((b["tokens"] == torch.tensor([3, 4])[:, None, None]).all())
    assert b["positions"].shape == (2, 1)
    eng = serving.ServeEngine(cfg, pp, serving.ServeConfig(
        max_len=MAX_LEN, max_new_tokens=4))
    nxt, cache = eng.prefill(toks, lens)
    got = eng.decode(nxt, cache, lens)
    with torch.no_grad():
        tok = torch.argmax(nxt, -1).to(torch.int32)
        want = [tok]
        for t in range(3):
            logits, cache = model.decode(cfg, pp, api.decode_batch(
                cfg, tok[:, None], (lens + t)[:, None]), cache)
            assert logits.shape == (2, cfg.n_codebooks, 1, cfg.vocab_size)
            tok = torch.argmax(logits[:, 0, -1], -1).to(torch.int32)
            want.append(tok)
    assert torch.equal(got, torch.stack(want, 1))
