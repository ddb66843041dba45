"""Port parity: the Zamba2-style hybrid (``repro_torch.models.hybrid``)
against ``repro.models.hybrid`` at zamba2-7b ``reduced()`` widths (fp32),
on the reference's own weights carried across by
``repro_torch.interop.hybrid_params``.

Two configurations: ``2x2`` — 2 super-blocks of 2 Mamba2 layers and a
tail layer, so the nested (nb, mpb, ...) stacks are exercised, held
here; ``d112`` — zamba2's head dim of 112 in the shared block (d_model
224, 2 heads), where the cache-free pass runs the plain attention at
D = 112, held by the same tests in ``tests/test_torch_hybrid_d112.py``
(so that each file stays short). The
reference draws every LoRA ``b`` as zeros, which would leave the merge
untested: both sides get drawn ``b`` factors instead.

Both sides run the same fp32 ops and differ in the order of the
matmuls' and the chunk recurrence's sums, so the loss, logits, every
cache leaf and 4 decode steps are held at rtol = atol = 2e-4, the SSD's
tolerance (``tests/test_torch_mamba2.py``). The per-slot paths (``agents``
decode, the slot engines) run the port on both sides.
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
from repro.configs.base import HybridConfig as RHybrid  # noqa: E402
from repro.models import hybrid as r_hybrid  # noqa: E402
from repro_torch import interop, serving  # noqa: E402
from repro_torch.common.pytree import (tree_leaves_with_paths,  # noqa: E402
                                       tree_map)
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import HybridConfig  # noqa: E402
from repro_torch.models import get_model, hybrid  # noqa: E402
from repro_torch.serving import api, continuous  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(rtol=2e-4, atol=2e-4)
B, S, MAX_LEN, STEPS = 2, 40, 64, 4
VARIANTS = {
    "2x2": dict(hybrid=(2, 2, 1, 8)),
    "d112": dict(hybrid=(2, 1, 1, 8), d_model=224, n_heads=2, n_kv_heads=2,
                 head_dim=112),
}


def _cfgs(name):
    kw = dict(VARIANTS[name])
    hy = kw.pop("hybrid")
    return (r_get_arch_config(ARCH).reduced().with_(hybrid=RHybrid(*hy),
                                                     **kw),
            get_arch_config(ARCH).reduced().with_(hybrid=HybridConfig(*hy),
                                                  **kw))


def _ref_params(rcfg, seed):
    """The reference's init with every LoRA ``b`` drawn (N(0, 0.05²))."""
    ref = jax.tree.map(np.asarray, r_hybrid.init_hybrid(
        rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for fac in ref["lora"].values():
        fac["b"] = (rng.normal(size=fac["b"].shape) * 0.05).astype(
            np.float32)
    return ref


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
            "positions": pos}


def _np(x):
    return x.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _run(name):
    """Both sides' loss, prefill (logits, cache) and STEPS greedy decode
    steps (logits each, the last cache), on the reference's weights."""
    rcfg, cfg = _cfgs(name)
    ref = _ref_params(rcfg, 0)
    rp = jax.tree.map(jnp.asarray, ref)
    pp = interop.hybrid_params(ref)
    batch = _batch(cfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {"ref": {}, "port": {}}
    out["ref"]["loss"] = float(jax.jit(
        lambda p, b: r_hybrid.hybrid_loss(rcfg, p, b))(rp, jb))
    fwd = jax.jit(lambda p, b, c: r_hybrid.hybrid_forward(rcfg, p, b, c))
    dec = jax.jit(lambda p, b, c: r_hybrid.hybrid_decode(rcfg, p, b, c))
    lg, _, cache = fwd(rp, {"tokens": jb["tokens"],
                            "positions": jb["positions"]},
                       r_hybrid.make_hybrid_cache(rcfg, B, MAX_LEN))
    out["ref"]["prefill"] = (np.asarray(lg), jax.tree.map(np.asarray, cache))
    with torch.no_grad():
        out["port"]["loss"] = float(hybrid.hybrid_loss(cfg, pp, tb))
        plg, _, pcache = hybrid.hybrid_forward(
            cfg, pp, {"tokens": tb["tokens"], "positions": tb["positions"]},
            hybrid.make_hybrid_cache(cfg, B, MAX_LEN, device="cpu"))
    out["port"]["prefill"] = (_np(plg), interop.hybrid_cache_to_numpy(pcache))
    nxt = np.argmax(np.asarray(lg)[:, -1], -1).astype(np.int32)[:, None]
    rsteps, psteps = [], []
    for t in range(STEPS):
        pos = np.full((B, 1), S + t, np.int32)
        lg, cache = dec(rp, {"tokens": jnp.asarray(nxt),
                             "positions": jnp.asarray(pos)}, cache)
        with torch.no_grad():
            plg, pcache = hybrid.hybrid_decode(
                cfg, pp, {"tokens": torch.from_numpy(nxt),
                          "positions": torch.from_numpy(pos)}, pcache)
        rsteps.append(np.asarray(lg))
        psteps.append(_np(plg))
        nxt = np.argmax(np.asarray(lg)[:, -1], -1).astype(np.int32)[:, None]
    out["ref"]["decode"] = (rsteps, jax.tree.map(np.asarray, cache))
    out["port"]["decode"] = (psteps, interop.hybrid_cache_to_numpy(pcache))
    return out


def _close_cache(got, want):
    for (path, g), (_, w) in zip(
            tree_leaves_with_paths(got),
            tree_leaves_with_paths(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(g, w, err_msg=str(path), **TOL)


@pytest.mark.parametrize("name", ["2x2"])
def test_loss_matches_reference(name):
    r = _run(name)
    np.testing.assert_allclose(r["port"]["loss"], r["ref"]["loss"], **TOL)


@pytest.mark.parametrize("name", ["2x2"])
def test_prefill_logits_match_reference(name):
    r = _run(name)
    np.testing.assert_allclose(r["port"]["prefill"][0],
                               r["ref"]["prefill"][0], **TOL)


@pytest.mark.parametrize("name", ["2x2"])
def test_prefill_cache_matches_reference(name):
    """Every leaf: the Mamba2 states (nb, mpb, B, ...), the KV cache
    (nb, B, slots, ...) with its positions, the tail states."""
    r = _run(name)
    got, want = r["port"]["prefill"][1], r["ref"]["prefill"][1]
    assert sorted(got) == sorted(want) == ["kv", "mamba", "tail"]
    _close_cache(got, want)


@pytest.mark.parametrize("name", ["2x2"])
def test_decode_steps_match_reference(name):
    r = _run(name)
    for t, (g, w) in enumerate(zip(r["port"]["decode"][0],
                                   r["ref"]["decode"][0])):
        np.testing.assert_allclose(g, w, err_msg=f"step {t}", **TOL)
    _close_cache(r["port"]["decode"][1], r["ref"]["decode"][1])


def test_merge_lora_matches_reference_and_per_row():
    """W + A·B per call site, as the reference forms it; with per-row
    factors (the group engine's slots) row b gets its own delta."""
    rcfg, cfg = _cfgs("2x2")
    ref = _ref_params(rcfg, 3)
    lora0 = jax.tree.map(lambda x: x[0], ref["lora"])
    want = r_hybrid._merge_lora(jax.tree.map(jnp.asarray, ref["shared"]),
                                jax.tree.map(jnp.asarray, lora0),
                                jnp.float32)
    shared = interop.hybrid_params(ref)["shared"]
    lora = tree_map(lambda x: torch.from_numpy(np.array(x)), lora0)
    got = hybrid._merge_lora(shared, lora, torch.float32)
    for grp, names in hybrid._LORA_TARGETS.items():
        for n in names:
            np.testing.assert_allclose(_np(got[grp][n]),
                                       np.asarray(want[grp][n]),
                                       rtol=1e-6, atol=1e-6)
            assert not torch.equal(got[grp][n], shared[grp][n])
    rows = hybrid._merge_lora(
        tree_map(lambda t: torch.stack([t, 2 * t]), shared),
        tree_map(lambda t: torch.stack([t, 3 * t]), lora), torch.float32)
    np.testing.assert_allclose(_np(rows["attn"]["wq"][0]),
                               _np(got["attn"]["wq"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(rows["attn"]["wq"][1]),
        _np(2 * shared["attn"]["wq"]
            + 9 * (lora["wq"]["a"] @ lora["wq"]["b"])),
        rtol=1e-6, atol=1e-6)


def _port_planes(cfg, n_agents):
    """Stacked planes of ``n_agents`` port inits, LoRA ``b`` drawn."""
    planes = []
    for a in range(n_agents):
        p = hybrid.init_hybrid(cfg, torch.Generator().manual_seed(a), "cpu")
        gen = torch.Generator().manual_seed(100 + a)
        for fac in p["lora"].values():
            fac["b"] = torch.randn(fac["b"].shape, generator=gen) * 0.05
        planes.append(p)
    return tree_map(lambda *ts: torch.stack(ts), *planes)


def test_agents_decode_matches_each_agents_own_decode():
    """``hybrid_decode(..., agents)``: each row under its own agent's
    weights (the shared block, each call site's LoRA factors, each
    Mamba2 layer gathered at its own depth) equals that agent's own
    decode of the row, logits and every cache leaf."""
    _, cfg = _cfgs("2x2")
    planes = _port_planes(cfg, 2)
    agents = torch.tensor([1, 0, 1])
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 12), dtype=np.int32))
    with torch.no_grad():
        caches = [hybrid.hybrid_forward(
            cfg, tree_map(lambda t: t[a], planes),
            api.build_prefill_batch(cfg, toks[b:b + 1]),
            hybrid.make_hybrid_cache(cfg, 1, 16, device="cpu"))[2]
            for b, a in enumerate(agents.tolist())]
        bdims = api.cache_batch_dims(cfg, 16)
        cache = hybrid.make_hybrid_cache(cfg, 3, 16, device="cpu")
        for b, one in enumerate(caches):
            api.splice_cache(cache, one, bdims, b)
        step = {"tokens": toks[:, -1:], "positions": torch.full(
            (3, 1), 12, dtype=torch.int32)}
        got, got_cache = hybrid.hybrid_decode(cfg, planes, step, cache,
                                              agents)
        for b, a in enumerate(agents.tolist()):
            want, want_cache = hybrid.hybrid_decode(
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


def test_cache_batch_dims_and_prefill_width():
    """The slot plumbing finds the hybrid's batch dims (the Mamba2
    states (nb, mpb, B, ...) at 2, the KV cache and tail states at 1)
    and keeps its whole padded prefill width, unlike a dense model's,
    since the Mamba2 states run through every pad; a prefill past the
    cache takes only pads there, and the fixed-batch engine checks the
    KV fit before decoding."""
    _, cfg = _cfgs("2x2")
    dims = api.cache_batch_dims(cfg, 32)
    assert set(dims["mamba"].values()) == {2}
    assert set(dims["kv"].values()) == {1}
    assert set(dims["tail"].values()) == {1}
    assert get_model(cfg).kv_pos is not None
    assert continuous.prefill_width(cfg, 16, 20, 24) == 32
    assert continuous.prefill_width(cfg, 16, 30, 24) == 32
    engine = serving.ServeEngine(cfg, hybrid.init_hybrid(
        cfg, torch.Generator().manual_seed(0), "cpu"),
        serving.ServeConfig(max_len=12, max_new_tokens=4))
    toks = torch.ones((1, 16), dtype=torch.int32)
    logits, cache = engine.prefill(toks, [10])
    assert cache["kv"]["pos"].shape[-1] == 12
    with pytest.raises(ValueError, match="max_len"):
        engine.decode(logits, cache, [10])
    with pytest.raises(ValueError, match="max_len"):
        engine.prefill(toks, [13])


def test_continuous_batcher_pads_past_the_cache_match_reference():
    """An 18-token prompt pads to 32 at prompt_pad 8, past a 24-slot
    cache: the reference runs all 32 positions, so its Mamba2 states
    take in the 14 pads, and drops the KV writes past slot 23; the
    port's ContinuousBatcher gives its tokens."""
    rcfg, cfg = _cfgs("2x2")
    ref = _ref_params(rcfg, 3)
    rng = np.random.default_rng(5)
    reqs = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
            for n in (18, 2)]
    assert continuous.prefill_width(cfg, 8, 18, 24) == 32
    kw = dict(max_len=24, max_new_tokens=5)
    want = r_serving.ContinuousBatcher(
        rcfg, jax.tree.map(jnp.asarray, ref), r_serving.ServeConfig(**kw),
        batch_size=2, prompt_pad=8).run(reqs)
    got = serving.ContinuousBatcher(
        cfg, interop.hybrid_params(ref), serving.ServeConfig(**kw),
        batch_size=2, prompt_pad=8).run(reqs)
    assert got == {k: [int(t) for t in v] for k, v in want.items()}


def test_continuous_batcher_matches_reference_and_fixed_batch():
    """Three requests through two slots on the reduced hybrid: the
    port's ContinuousBatcher gives the reference batcher's tokens, and
    each request's tokens equal the port's fixed-batch engine's on the
    prompt alone, padded to the same width."""
    rcfg, cfg = _cfgs("2x2")
    ref = _ref_params(rcfg, 2)
    params = interop.hybrid_params(ref)
    reqs = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11, 12, 13, 14]]
    kw = dict(max_len=48, max_new_tokens=5)
    want = r_serving.ContinuousBatcher(
        rcfg, jax.tree.map(jnp.asarray, ref), r_serving.ServeConfig(**kw),
        batch_size=2, prompt_pad=8).run(reqs)
    got = serving.ContinuousBatcher(cfg, params, serving.ServeConfig(**kw),
                                    batch_size=2, prompt_pad=8).run(reqs)
    assert got == {k: [int(t) for t in v] for k, v in want.items()}
    eng = serving.ServeEngine(cfg, params, serving.ServeConfig(**kw))
    for rid, req in enumerate(reqs):
        width = continuous.prefill_width(cfg, 8, len(req), kw["max_len"])
        toks = torch.zeros((1, width), dtype=torch.int32)
        toks[0, :len(req)] = torch.tensor(req, dtype=torch.int32)
        assert eng.generate(toks, [len(req)])[0].tolist() == got[rid]


def test_group_engine_matches_each_agents_fixed_batch_engine():
    """GroupServeEngine over 2 agents' planes, 2 slots, 4 requests
    round-robin: every request's tokens equal the fixed-batch engine's
    on its agent's weights alone."""
    _, cfg = _cfgs("2x2")
    planes = _port_planes(cfg, 2)
    serve_cfg = serving.ServeConfig(max_len=48, max_new_tokens=5)
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in
               (5, 11, 3, 8)]
    engine = serving.GroupServeEngine(cfg, planes, serve_cfg, batch_size=2,
                                      prompt_pad=8)
    reqs = [serving.GroupRequest(r, r % 2, p) for r, p in enumerate(prompts)]
    out = engine.run(reqs)
    for r in reqs:
        eng = serving.ServeEngine(cfg, tree_map(lambda t: t[r.agent_id],
                                                planes), serve_cfg)
        width = continuous.prefill_width(cfg, 8, len(r.prompt), 48)
        toks = torch.zeros((1, width), dtype=torch.int32)
        toks[0, :len(r.prompt)] = torch.tensor(r.prompt, dtype=torch.int32)
        assert [int(t) for t in out[r.rid]] == \
            eng.generate(toks, [len(r.prompt)])[0].tolist()
