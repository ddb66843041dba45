"""Port parity: the VLM family (``family="vlm"``: M-RoPE and the vision
prefix) at qwen2-vl-72b ``reduced()`` (2 layers, d_model 256, 4 heads
of 32, M-RoPE sections (4, 6, 6), a vision prefix of 8, fp32), against
``repro.models`` and ``repro.serving`` on the reference's own weights,
carried across by ``repro_torch.interop``. The reference runs
``attention_impl="xla"``, as the transformer tests run it.

Tolerances, each as ``tests/test_torch_transformer.py`` states them:

* M-RoPE: rtol = atol = 1e-6 (torch's and XLA's fp32 ``sin``, ``cos``
  and ``pow`` differ by one unit in the last place on some arguments);
* logits, caches and losses in fp32: rtol = atol = 1e-4 (the same fp32
  ops, matmuls summed in other orders);
* tokens: equal.

What is held: ``mrope`` (t, h and w rows that differ) at the reduced
sections and at the published (16, 24, 24) with D = 128; the scoring
pass's logits and loss over a vision prefix with t and h rows that
differ from w; ``ServeEngine`` prefill logits, cache and greedy tokens;
the ``ContinuousBatcher`` and ``GroupServeEngine`` tokens; per-slot
weights; the cache carried both ways; decode with every tensor read
patched to raise; and the reference's behaviours the port reproduces
on purpose (ROADMAP §3): serving ignores the prefix offset, and the
cache-free pass masks by index where the reference's ``"xla"`` branch
masks by the w row. The audio file (``test_torch_audio.py``) imports
this file's helpers.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as r_serving  # noqa: E402
from repro.configs import get_arch_config as r_get_arch_config  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import rope as r_rope  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402
from repro.serving import api as r_api  # noqa: E402
from repro_torch import interop, serving  # noqa: E402
from repro_torch.common.pytree import (tree_leaves_with_paths,  # noqa: E402
                                       tree_map)
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.models import get_model, rope, transformer  # noqa: E402
from repro_torch.serving import api, continuous  # noqa: E402
from test_torch_serving_nosync import no_reads  # noqa: E402

ARCH = "qwen2-vl-72b"
TOL = dict(rtol=1e-4, atol=1e-4)
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
PROMPTS = [[5, 9, 200, 31, 7, 77, 301, 12, 4, 66], [11, 400, 3]]
MAX_LEN, NEW = 48, 5


def _np(x):
    return x.detach().float().numpy()


def cfgs(arch):
    """(reference, port) ``reduced()`` configs of ``arch``."""
    return r_get_arch_config(arch).reduced(), get_arch_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def ref_params(arch, seed=0):
    """The reference's ``reduced()`` weights of ``arch`` (numpy)."""
    rcfg, _ = cfgs(arch)
    return jax.tree.map(np.asarray, r_model.get_model(rcfg).init(
        rcfg, jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def ref_planes(arch, n_agents):
    """Stacked (A, ...) reference weights of agents 0 .. A − 1 (seeds
    0, 1, ...), numpy."""
    return jax.tree.map(lambda *xs: np.stack(xs),
                        *[ref_params(arch, a) for a in range(n_agents)])


def both_params(arch, seed=0):
    ref = ref_params(arch, seed)
    return jax.tree.map(jnp.asarray, ref), interop.transformer_params(ref)


def close_tree(got, want):
    """Every leaf of two nests (numpy) within TOL, by path."""
    gl, wl = tree_leaves_with_paths(got), tree_leaves_with_paths(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(g, w, err_msg=str(path), **TOL)


def score_both(arch, batch):
    """(port logits, loss), (reference logits, loss) of the cache-free
    pass over a numpy ``batch``."""
    rcfg, cfg = cfgs(arch)
    rp, pp = both_params(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, _, _ = jax.jit(lambda p, b: r_tf.transformer_forward(rcfg, p, b))(
        rp, jb)
    want_loss = jax.jit(lambda p, b: r_model.get_model(rcfg).loss(
        rcfg, p, b))(rp, jb)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with torch.no_grad():
        got, _, cache = transformer.transformer_forward(cfg, pp, tb)
        got_loss = get_model(cfg).loss(cfg, pp, tb)
    assert cache is None
    return ((_np(got), float(got_loss)),
            (np.asarray(want), float(want_loss)))


def serve_both(arch, prompts=PROMPTS, max_len=MAX_LEN, new=NEW):
    """Both ServeEngines on one right-padded batch: (port (next-token
    logits, cache as numpy, tokens), reference's)."""
    rcfg, cfg = cfgs(arch)
    rp, pp = both_params(arch)
    toks, lens = serving.serve_batches(prompts, len(prompts), device="cpu")[0]
    kw = dict(max_len=max_len, max_new_tokens=new)
    ref = r_serving.ServeEngine(rcfg, rp, r_serving.ServeConfig(**kw))
    jt, jl = jnp.asarray(toks.numpy()), jnp.asarray(lens.numpy())
    rnxt, rcache = ref._prefill(rp, jt, jl)
    rtoks = np.asarray(ref.generate(jt, jl))
    eng = serving.ServeEngine(cfg, pp, serving.ServeConfig(**kw))
    nxt, cache = eng.prefill(toks, lens)
    ptoks = eng.decode(nxt, cache, [len(p) for p in prompts])
    return ((_np(nxt), interop.kv_cache_to_numpy(cache), ptoks.numpy()),
            (np.asarray(rnxt), jax.tree.map(np.asarray, rcache), rtoks))


def continuous_both(arch, reqs, max_len=MAX_LEN, new=NEW):
    """{request: tokens} of the port's and the reference's
    ContinuousBatcher, 2 slots, prompt_pad 8."""
    rcfg, cfg = cfgs(arch)
    rp, pp = both_params(arch)
    kw = dict(max_len=max_len, max_new_tokens=new)
    want = r_serving.ContinuousBatcher(
        rcfg, rp, r_serving.ServeConfig(**kw), batch_size=2,
        prompt_pad=8).run(reqs)
    got = serving.ContinuousBatcher(
        cfg, pp, serving.ServeConfig(**kw), batch_size=2,
        prompt_pad=8).run(reqs)
    return got, {k: [int(t) for t in v] for k, v in want.items()}


def group_both(arch, reqs, max_len=MAX_LEN, new=NEW):
    """{request: tokens} of the port's and the reference's
    GroupServeEngine over 2 agents' planes, 2 slots, request i on agent
    i % 2."""
    rcfg, cfg = cfgs(arch)
    planes = ref_planes(arch, 2)
    kw = dict(max_len=max_len, max_new_tokens=new)
    want = r_serving.GroupServeEngine(
        rcfg, jax.tree.map(jnp.asarray, planes), r_serving.ServeConfig(**kw),
        batch_size=2, prompt_pad=8).run(
            [r_serving.GroupRequest(i, i % 2, r) for i, r in enumerate(reqs)])
    got = serving.GroupServeEngine(
        cfg, interop.transformer_params(planes), serving.ServeConfig(**kw),
        batch_size=2, prompt_pad=8).run(
            [serving.GroupRequest(i, i % 2, r) for i, r in enumerate(reqs)])
    return got, {k: [int(t) for t in v] for k, v in want.items()}


def cache_both_ways(arch, prompts=PROMPTS, max_len=MAX_LEN):
    """One decode step (the token after each prompt, at position
    ``lengths``) from the reference's prefill cache carried into the
    port and from the port's carried into the reference: both sides'
    logits and new caches, each against the other side's own step."""
    rcfg, cfg = cfgs(arch)
    rp, pp = both_params(arch)
    rmodel, model = r_model.get_model(rcfg), get_model(cfg)
    toks, lens = serving.serve_batches(prompts, len(prompts), device="cpu")[0]
    _, rcache = r_api.prefill(rcfg, rmodel, rp, jnp.asarray(toks.numpy()),
                              jnp.asarray(lens.numpy()), max_len)
    with torch.no_grad():
        _, pcache = api.prefill(cfg, model, pp, toks, lens, max_len)
    nxt = np.array([[p[0]] for p in prompts], np.int32)
    pos = lens.numpy()[:, None].astype(np.int32)
    rdec = jax.jit(lambda p, b, c: rmodel.decode(rcfg, p, b, c))
    rb = r_api.decode_batch(rcfg, jnp.asarray(nxt), jnp.asarray(pos))
    pb = api.decode_batch(cfg, torch.from_numpy(nxt), torch.from_numpy(pos))
    for from_ref in (True, False):
        if from_ref:
            src = jax.tree.map(np.asarray, rcache)
            with torch.no_grad():
                got, gcache = model.decode(cfg, pp, pb,
                                           interop.kv_cache(src))
            want, wcache = rdec(rp, rb, rcache)
        else:
            src = interop.kv_cache_to_numpy(pcache)
            want, wcache = rdec(rp, rb, jax.tree.map(jnp.asarray, src))
            with torch.no_grad():
                got, gcache = model.decode(cfg, pp, pb, pcache)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        close_tree(interop.kv_cache_to_numpy(gcache),
                   jax.tree.map(np.asarray, wcache))


def agents_decode_matches_own(arch):
    """``decode(..., agents)`` of 3 rows under agents [1, 0, 1] (each
    row's weights gathered per layer from stacked planes) equals each
    row's agent's own decode: logits and every cache leaf."""
    _, cfg = cfgs(arch)
    model = get_model(cfg)
    planes = interop.transformer_params(ref_planes(arch, 2))
    agents = torch.tensor([1, 0, 1])
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 6), dtype=np.int32))
    with torch.no_grad():
        caches = [api.prefill(cfg, model, tree_map(lambda t: t[a], planes),
                              toks[b:b + 1], [6], 32)[1]
                  for b, a in enumerate(agents.tolist())]
        bdims = api.cache_batch_dims(cfg, 32)
        cache = model.make_cache(cfg, 3, 32, device="cpu")
        for b, one in enumerate(caches):
            api.splice_cache(cache, one, bdims, b)
        step = api.decode_batch(cfg, toks[:, -1:],
                                torch.full((3, 1), 6, dtype=torch.int32))
        got, got_cache = model.decode(cfg, planes, step, cache, agents)
        for b, a in enumerate(agents.tolist()):
            want, want_cache = model.decode(
                cfg, tree_map(lambda t: t[a], planes),
                {k: v[b:b + 1] for k, v in step.items()}, caches[b])
            torch.testing.assert_close(got[b:b + 1], want, rtol=1e-5,
                                       atol=1e-5)
            for (path, g), (_, w), (_, d) in zip(
                    tree_leaves_with_paths(got_cache),
                    tree_leaves_with_paths(want_cache),
                    tree_leaves_with_paths(bdims)):
                torch.testing.assert_close(g.select(d, b), w.select(d, 0),
                                           rtol=1e-5, atol=1e-5,
                                           msg=str(path))


def decode_reads_nothing_back(arch):
    """``ServeEngine.decode`` from host lengths and one group step's
    batched decode, with every tensor→host read patched to raise: the
    same tokens and logits as unpatched (the card runs them under
    ``set_sync_debug_mode("error")``)."""
    _, cfg = cfgs(arch)
    _, params = both_params(arch)
    eng = serving.ServeEngine(cfg, params, serving.ServeConfig(
        max_len=MAX_LEN, max_new_tokens=6))
    toks, lens = serving.serve_batches(PROMPTS, 2, device="cpu")[0]
    logits, cache = eng.prefill(toks, lens)
    want = eng.decode(logits, cache, lens)
    host = [len(p) for p in PROMPTS]
    with no_reads():
        got = eng.decode(logits, cache, host)
    assert torch.equal(got, want)
    planes = interop.transformer_params(ref_planes(arch, 2))
    grp = serving.GroupServeEngine(
        cfg, planes, serving.ServeConfig(max_len=MAX_LEN, max_new_tokens=6),
        batch_size=2, prompt_pad=8)
    for rid in range(2):
        grp.submit(serving.GroupRequest(rid, rid, [3 + rid, 7, 11]))
    grp.step()
    slots = grp._state
    batch = api.decode_batch(cfg, slots.tokens, slots.pos_dev[:, None])
    live, _ = grp.store.acquire()
    want, _ = grp.decode_step(live, batch, slots.cache)
    with no_reads():
        got, _ = grp.decode_step(live, batch, slots.cache)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------
@pytest.mark.parametrize("sections,D", [((4, 6, 6), 32),
                                        ((16, 24, 24), 128)])
def test_mrope_matches_reference(sections, D):
    """t, h and w rows that differ; rtol = atol = 1e-6."""
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 40, 3, D)).astype(np.float32)
    pos3 = rng.integers(0, 5000, (2, 3, 40)).astype(np.int32)
    assert not (pos3[:, 0] == pos3[:, 1]).all()
    want = r_rope.mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    got = rope.mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                     sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)
    cfg = get_arch_config(ARCH).with_(head_dim=D, mrope_sections=sections)
    torch.testing.assert_close(rope.apply_rope(cfg, torch.from_numpy(x),
                                               torch.from_numpy(pos3)), got)
    # equal rows: M-RoPE is RoPE, up to the last bit of a frequency
    # (torch's pow rounds a vector's elements by where they fall in its
    # SIMD lanes): positions 0..39, atol 1e-5
    flat = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 3, 40)).copy()
    np.testing.assert_allclose(
        rope.mrope(torch.from_numpy(x), torch.from_numpy(flat), 1e6,
                   sections).numpy(),
        rope.rope(torch.from_numpy(x), torch.from_numpy(flat[:, 0]),
                  1e6).numpy(), rtol=0, atol=1e-5)


def test_mrope_sections_must_sum_to_half_the_head_dim():
    """Checked at the rotation, as the reference asserts it there: a
    ``ValueError`` naming the sections and the head dim."""
    x = torch.zeros((1, 2, 1, 32))
    pos3 = torch.zeros((1, 3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(4, 6, 7\).*16.*32"):
        rope.mrope(x, pos3, 1e6, (4, 6, 7))
    assert get_arch_config(ARCH).reduced().mrope_sections == (4, 6, 6)
    assert get_arch_config(ARCH).mrope_sections == (16, 24, 24)


# ---------------------------------------------------------------------
# the model: scoring
# ---------------------------------------------------------------------
def _vlm_batch(cfg, S=24, seed=1, w=None):
    """B = 2 rows of S positions: a vision prefix (normal × 0.5), text
    ids, labels −100 over the prefix, and positions whose t and h rows
    differ from the w row (``w``, default 0..S−1)."""
    rng = np.random.default_rng(seed)
    vp = cfg.vision_prefix
    toks = rng.integers(0, cfg.vocab_size, (2, S - vp), dtype=np.int32)
    ar = np.arange(S, dtype=np.int32)
    pos = np.stack([ar // 2, ar % 5, ar if w is None else w])
    return {"tokens": toks,
            "vision": (rng.normal(size=(2, vp, cfg.d_model)) * 0.5
                       ).astype(np.float32),
            "labels": np.concatenate(
                [np.full((2, vp), -100, np.int32), toks], axis=1),
            "positions": np.broadcast_to(pos, (2, 3, S)).copy()}


def test_scoring_logits_and_loss_match_reference():
    """The cache-free pass over (vision + text): logits (B, S, V) and
    the loss (the prefix's labels ignored) within 1e-4."""
    _, cfg = cfgs(ARCH)
    (got, got_loss), (want, want_loss) = score_both(ARCH, _vlm_batch(cfg))
    assert got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_loss, want_loss, **TOL)


def test_vision_rows_lead_the_sequence():
    """``vision`` is concatenated ahead of the text's embedding rows; a
    decode batch without ``vision`` embeds the text alone."""
    _, cfg = cfgs(ARCH)
    _, pp = both_params(ARCH)
    b = {k: torch.from_numpy(v) for k, v in _vlm_batch(cfg).items()}
    x = transformer._embed(cfg, pp, b)
    assert x.shape == (2, 24, cfg.d_model)
    torch.testing.assert_close(x[:, :cfg.vision_prefix], b["vision"])
    torch.testing.assert_close(x[:, cfg.vision_prefix:],
                               pp["embed"][b["tokens"].long()])
    assert transformer._embed(cfg, pp, {"tokens": b["tokens"]}).shape == \
        (2, 16, cfg.d_model)


# ---------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------
def test_serve_engine_prefill_and_decode_match_reference():
    """ServeEngine on 2 right-padded prompts: next-token logits and
    every cache leaf after the prefill within 1e-4, greedy tokens
    equal."""
    (nxt, cache, toks), (rnxt, rcache, rtoks) = serve_both(ARCH)
    np.testing.assert_allclose(nxt, rnxt, **TOL)
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


def test_prefill_must_fit_the_vision_prefix():
    """The prefill writes P + vision_prefix positions: a cache of fewer
    raises ``ValueError`` naming ``max_len``; the slot engines' padded
    width is cut to ``max_len − vision_prefix``."""
    _, cfg = cfgs(ARCH)
    _, pp = both_params(ARCH)
    toks = torch.ones((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len=17"):
        api.prefill(cfg, get_model(cfg), pp, toks, [10], 17)
    api.prefill(cfg, get_model(cfg), pp, toks, [10], 18)
    assert continuous.prefill_width(cfg, 8, 9, 24) == 16
    assert continuous.prefill_width(cfg, 8, 9, 22) == 14


# ---------------------------------------------------------------------
# the reference's behaviours, reproduced on purpose (ROADMAP §3)
# ---------------------------------------------------------------------
def test_prefill_row_ignores_the_vision_prefix():
    """``prefill`` takes the next-token row at index ``lengths − 1`` of
    the (vision + text) logits, as the reference does: for the 3-token
    prompt (shorter than the prefix of 8) that row is a vision row,
    not its last token's (index vision_prefix + 2)."""
    _, cfg = cfgs(ARCH)
    _, pp = both_params(ARCH)
    toks, lens = serving.serve_batches(PROMPTS, 2, device="cpu")[0]
    with torch.no_grad():
        nxt, _ = api.prefill(cfg, get_model(cfg), pp, toks, lens, MAX_LEN)
        full, _, _ = transformer.transformer_forward(
            cfg, pp, api.build_prefill_batch(cfg, toks))
    vp = cfg.vision_prefix
    for b, p in enumerate(PROMPTS):
        torch.testing.assert_close(nxt[b], full[b, len(p) - 1])
        assert not torch.allclose(nxt[b], full[b, vp + len(p) - 1])
    assert len(PROMPTS[1]) - 1 < vp


def test_decode_starts_at_the_prompt_length_over_the_prefix():
    """Decode starts at position ``lengths`` (the reference's
    ``pos=lengths``), so its first step overwrites the slot of an
    earlier position of the (vision + text) prefill, and attends only
    to slots whose position is at most ``lengths``: changing a later
    slot's key changes nothing, changing an earlier one does. The
    reference's step on the same cache agrees (``cache_both_ways``)."""
    _, cfg = cfgs(ARCH)
    _, pp = both_params(ARCH)
    model = get_model(cfg)
    toks, lens = serving.serve_batches(PROMPTS, 2, device="cpu")[0]
    with torch.no_grad():
        _, cache = api.prefill(cfg, model, pp, toks, lens, MAX_LEN)
        step = api.decode_batch(cfg, toks[:, :1], lens[:, None])
        logits, new = model.decode(cfg, pp, step, cache)
        kv, nkv = cache["layers"]["kv"], new["layers"]["kv"]
        P = toks.shape[1] + cfg.vision_prefix
        for b, n in enumerate(lens.tolist()):
            assert int(kv["pos"][0, b, n]) == n            # written before
            assert not torch.equal(nkv["k"][:, b, n], kv["k"][:, b, n])
            assert bool((nkv["pos"][0, b, :P] == torch.arange(P)).all())

        def poked(slot):
            c = tree_map(lambda t: t.clone(), cache)
            c["layers"]["kv"]["k"][:, :, slot] += 3.0
            return model.decode(cfg, pp, step, c)[0]
        late = int(lens.max()) + 1
        assert late < P
        torch.testing.assert_close(poked(late), logits, rtol=0, atol=0)
        assert not torch.allclose(poked(0), logits)


@pytest.mark.parametrize("w", ["0..S-1", "permuted"])
def test_cache_free_pass_masks_by_index(w):
    """The port's cache-free pass masks by index (the flash kernel, its
    plain version here), as the reference's Pallas route does; the
    reference's ``"xla"`` route masks by the w row. On the batches the
    repo builds (w = 0..S−1) every route agrees within 1e-4; on a
    permuted w row the port still equals the Pallas route and parts
    from the ``"xla"`` one."""
    rcfg, cfg = cfgs(ARCH)
    rp, pp = both_params(ARCH)
    S = 24
    wrow = (np.arange(S, dtype=np.int32) if w == "0..S-1"
            else np.random.default_rng(3).permutation(S).astype(np.int32))
    batch = _vlm_batch(cfg, S, seed=2, w=wrow)
    with torch.no_grad():
        got, _, _ = transformer.transformer_forward(
            cfg, pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    routes = {impl: np.asarray(r_tf.transformer_forward(
        rcfg.with_(attention_impl=impl), rp, jb)[0])
        for impl in ("xla", "pallas_interpret")}
    np.testing.assert_allclose(_np(got), routes["pallas_interpret"], **TOL)
    if w == "0..S-1":
        np.testing.assert_allclose(_np(got), routes["xla"], **TOL)
    else:
        assert not np.allclose(_np(got), routes["xla"], **TOL)
