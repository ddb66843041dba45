"""Port parity: the Mixture-of-Experts layer (``repro_torch.models.moe``)
and the MoE transformer at qwen3-moe-30b-a3b ``reduced()`` widths
(fp32), against ``repro.models.moe`` and ``repro.models.transformer``
on the reference's own weights, carried across by
``repro_torch.interop.transformer_params``.

* ``moe_apply`` (out and aux) at 1e-5 (out: of its largest entry; the
  layer's input is RMS-normed, and the experts' fan-in of Ne gives
  outputs in the hundreds at these widths), at a width and length
  where experts overflow their capacity (asserted), with 0 and 1 shared
  experts, and with router weights whose logits tie across the top-k
  boundary: the experts chosen are ``jax.lax.top_k``'s (lower index
  first), which ``torch.topk`` does not promise.
* The model (rtol = atol = 1e-4, both sides the same fp32 ops with
  matmuls summed in other orders): the loss with the auxiliary term,
  prefill logits and every cache leaf, 4 decode steps.
* ``agents=`` decode of 2 agents against each agent's own decode, and
  the ContinuousBatcher against the reference's on a prompt whose
  padded width passes ``max_len`` (an expert's capacity follows the
  padded width, so the width is not cut).
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
from repro.configs.base import MoEConfig as RMoE  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402
from repro_torch import interop, serving  # noqa: E402
from repro_torch.common.pytree import (tree_leaves_with_paths,  # noqa: E402
                                       tree_map)
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import get_model, moe, transformer  # noqa: E402
from repro_torch.serving import api, continuous  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, MAX_LEN, STEPS = 2, 40, 64, 4


def _np(x):
    return x.detach().float().numpy()


def _moe_cfgs(**moe_kw):
    """reduced() qwen3-moe with ``moe_kw`` on both sides' MoEConfig."""
    rcfg = r_get_arch_config(ARCH).reduced()
    cfg = get_arch_config(ARCH).reduced()
    kw = dict(vars(cfg.moe), **moe_kw)
    return rcfg.with_(moe=RMoE(**kw)), cfg.with_(moe=MoEConfig(**kw))


def _moe_params(rcfg, seed):
    return jax.tree.map(np.asarray, r_moe.init_moe(rcfg,
                                                   jax.random.PRNGKey(seed)))


def _both(rcfg, cfg, ref, x):
    """(port out, port aux), (reference out, aux) of one moe_apply."""
    want, waux = r_moe.moe_apply(rcfg, jax.tree.map(jnp.asarray, ref),
                                 jnp.asarray(x))
    got, gaux = moe.moe_apply(cfg, interop.transformer_params(
        {"embed": 0, "final_norm": 0, "layers": {"ln1": 0, "ln2": 0,
                                                  "attn": 0, "moe": ref}}
    )["layers"]["moe"], torch.from_numpy(x))
    return (_np(got), float(gaux)), (np.asarray(want), float(waux))


def close_out(got, want):
    """Within 1e-5 relative, or 1e-5 of the largest entry."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _routing(cfg, p, x):
    """Each row's expert loads and the capacity C, from the port's
    router."""
    logits = (torch.from_numpy(x) @ p["router"]).float()
    _, idx = moe.top_k(torch.softmax(logits, -1), cfg.moe.top_k)
    loads = moe.one_hot(idx.reshape(x.shape[0], -1), cfg.moe.n_experts,
                        torch.int64).sum(1)
    m = cfg.moe
    return loads, max(1, int(m.capacity_factor * x.shape[1] * m.top_k
                             / m.n_experts))


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_apply_with_capacity_drops_matches_reference(n_shared):
    """S = 48 tokens, top-2 of 4 experts at capacity factor 0.75 (C = 18
    of 96 choices a row): some experts overflow and drop tokens; out
    and aux within 1e-5."""
    rcfg, cfg = _moe_cfgs(n_shared=n_shared, capacity_factor=0.75)
    ref = _moe_params(rcfg, n_shared)
    x = np.random.default_rng(n_shared).normal(
        size=(B, 48, cfg.d_model)).astype(np.float32)
    loads, C = _routing(cfg, interop.transformer_params(
        {"embed": 0, "final_norm": 0, "layers": {"ln1": 0, "ln2": 0,
                                                  "attn": 0, "moe": ref}}
    )["layers"]["moe"], x)
    assert int((loads - C).clamp(min=0).sum()) > 0, (loads, C)
    (got, gaux), (want, waux) = _both(rcfg, cfg, ref, x)
    close_out(got, want)
    np.testing.assert_allclose(gaux, waux, **LAYER_TOL)
    assert ("shared" in ref) == bool(n_shared)


def test_tied_router_logits_pick_the_lower_expert_first():
    """Logits exact in fp32 (one-hot tokens × a router of eighths) that
    tie across the top-3 boundary of 7 experts, as bf16 logits often do:
    the port's top-k equals ``jax.lax.top_k``'s indices on every token
    (the first token is [0.5, 2, 1, 2, 2, 0.1, 2] → experts 1, 3, 4),
    and moe_apply's out and aux agree."""
    rows = np.array([[0.5, 2, 1, 2, 2, 0.125, 2],
                     [1, 1, 1, 1, 0.5, 1, 0.25],
                     [3, 0.5, 3, 0.5, 3, 3, 0.5],
                     [0.25, 0.25, 0.25, 0.25, 0.25, 0.25, 0.25]],
                    np.float32)
    d = 8
    rcfg, cfg = _moe_cfgs(n_experts=7, top_k=3, expert_ff=16)
    rcfg, cfg = rcfg.with_(d_model=d), cfg.with_(d_model=d)
    ref = _moe_params(rcfg, 4)
    ref["router"] = np.zeros((d, 7), np.float32)
    ref["router"][:4] = rows
    x = np.zeros((1, 12, d), np.float32)
    for s in range(12):
        x[0, s, s % 4] = 1.0
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(ref["router"]), -1)
    _, want_idx = jax.lax.top_k(probs, 3)
    _, got_idx = moe.top_k(torch.from_numpy(np.array(probs)), 3)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert got_idx[0, 0].tolist() == [1, 3, 4]
    (got, gaux), (want, waux) = _both(rcfg, cfg, ref, x)
    close_out(got, want)
    np.testing.assert_allclose(gaux, waux, **LAYER_TOL)


def test_per_row_expert_weights_match_each_rows_own():
    """moe_apply with per-row weights (the group engine's slots: router
    (B, E, Ne), experts (B, Ne, ...), shared (B, ...)) gives each row
    what its own weights give it alone, aux aside (it mixes the rows)."""
    _, cfg = _moe_cfgs(n_shared=1)
    gens = [torch.Generator().manual_seed(s) for s in (0, 1)]
    ps = [moe.init_moe(cfg, g, "cpu") for g in gens]
    rows = tree_map(lambda a, b: torch.stack([a, b]), *ps)
    x = torch.randn((2, 9, cfg.d_model), generator=gens[0])
    got, _ = moe.moe_apply(cfg, rows, x)
    for b in range(2):
        want, _ = moe.moe_apply(cfg, ps[b], x[b:b + 1])
        torch.testing.assert_close(got[b:b + 1], want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------
def _cfgs():
    return r_get_arch_config(ARCH).reduced(), get_arch_config(ARCH).reduced()


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy(),
            "positions": pos}


def run_model(arch):
    """Both sides' loss (with aux), prefill (logits, cache) and STEPS
    greedy decode steps (logits each, the last cache) of ``arch``
    ``reduced()``, on the reference's weights (seed 0)."""
    rcfg, cfg = r_get_arch_config(arch).reduced(), \
        get_arch_config(arch).reduced()
    rmodel, model = r_model.get_model(rcfg), get_model(cfg)
    ref = jax.tree.map(np.asarray, rmodel.init(rcfg, jax.random.PRNGKey(0)))
    rp, pp = jax.tree.map(jnp.asarray, ref), interop.transformer_params(ref)
    batch = _batch(cfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {"ref": {}, "port": {}}
    loss, aux = jax.jit(lambda p, b: (rmodel.loss(rcfg, p, b),
                                      r_tf.transformer_forward(rcfg, p, b)[1])
                        )(rp, jb)
    out["ref"]["loss"], out["ref"]["aux"] = float(loss), float(aux)
    fwd = jax.jit(lambda p, b, c: rmodel.forward(rcfg, p, b, c))
    dec = jax.jit(lambda p, b, c: rmodel.decode(rcfg, p, b, c))
    step0 = {"tokens": jb["tokens"], "positions": jb["positions"]}
    lg, cache = fwd(rp, step0, rmodel.make_cache(rcfg, B, MAX_LEN))
    out["ref"]["prefill"] = (np.asarray(lg), jax.tree.map(np.asarray, cache))
    with torch.no_grad():
        out["port"]["loss"] = float(model.loss(cfg, pp, tb))
        out["port"]["aux"] = float(transformer.transformer_forward(
            cfg, pp, tb)[1])
        plg, pcache = model.forward(
            cfg, pp, {"tokens": tb["tokens"], "positions": tb["positions"]},
            model.make_cache(cfg, B, MAX_LEN, device="cpu"))
    out["port"]["prefill"] = (_np(plg), interop.kv_cache_to_numpy(pcache))
    nxt = np.argmax(np.asarray(lg)[:, -1], -1).astype(np.int32)[:, None]
    rsteps, psteps = [], []
    for t in range(STEPS):
        pos = np.full((B, 1), S + t, np.int32)
        lg, cache = dec(rp, {"tokens": jnp.asarray(nxt),
                             "positions": jnp.asarray(pos)}, cache)
        with torch.no_grad():
            plg, pcache = model.decode(
                cfg, pp, {"tokens": torch.from_numpy(nxt),
                          "positions": torch.from_numpy(pos)}, pcache)
        rsteps.append(np.asarray(lg))
        psteps.append(_np(plg))
        nxt = np.argmax(np.asarray(lg)[:, -1], -1).astype(np.int32)[:, None]
    out["ref"]["decode"] = (rsteps, jax.tree.map(np.asarray, cache))
    out["port"]["decode"] = (psteps, interop.kv_cache_to_numpy(pcache))
    return out


_run = functools.lru_cache(maxsize=None)(run_model)


def close_cache(got, want):
    """Every leaf of two caches (numpy) within TOL, by path."""
    gl, wl = tree_leaves_with_paths(got), tree_leaves_with_paths(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(g, w, err_msg=str(path), **TOL)


def test_loss_with_aux_matches_reference():
    r = _run(ARCH)
    assert r["ref"]["aux"] > 0
    np.testing.assert_allclose(r["port"]["aux"], r["ref"]["aux"], **TOL)
    np.testing.assert_allclose(r["port"]["loss"], r["ref"]["loss"], **TOL)


def test_prefill_logits_and_cache_match_reference():
    r = _run(ARCH)
    np.testing.assert_allclose(r["port"]["prefill"][0],
                               r["ref"]["prefill"][0], **TOL)
    close_cache(r["port"]["prefill"][1], r["ref"]["prefill"][1])


def test_decode_steps_match_reference():
    r = _run(ARCH)
    for t, (g, w) in enumerate(zip(r["port"]["decode"][0],
                                   r["ref"]["decode"][0])):
        np.testing.assert_allclose(g, w, err_msg=f"step {t}", **TOL)
    close_cache(r["port"]["decode"][1], r["ref"]["decode"][1])


# ---------------------------------------------------------------------
# per-slot weights and the slot engines
# ---------------------------------------------------------------------
def port_planes(cfg, n_agents):
    """Stacked planes of ``n_agents`` port inits (seeds 0, 1, ...)."""
    model = get_model(cfg)
    return tree_map(lambda *ts: torch.stack(ts), *[
        model.init(cfg, torch.Generator().manual_seed(a), "cpu")
        for a in range(n_agents)])


def agents_decode_matches_own(cfg):
    """``decode(..., agents)`` of 3 rows under agents [1, 0, 1] equals
    each row's agent's own decode of the row: logits and every cache
    leaf."""
    model = get_model(cfg)
    planes = port_planes(cfg, 2)
    agents = torch.tensor([1, 0, 1])
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 12), dtype=np.int32))
    with torch.no_grad():
        caches = [model.forward(
            cfg, tree_map(lambda t: t[a], planes),
            api.build_prefill_batch(cfg, toks[b:b + 1]),
            model.make_cache(cfg, 1, 16, device="cpu"))[1]
            for b, a in enumerate(agents.tolist())]
        bdims = api.cache_batch_dims(cfg, 16)
        cache = model.make_cache(cfg, 3, 16, device="cpu")
        for b, one in enumerate(caches):
            api.splice_cache(cache, one, bdims, b)
        step = {"tokens": toks[:, -1:], "positions": torch.full(
            (3, 1), 12, dtype=torch.int32)}
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


def test_agents_decode_matches_each_agents_own_decode():
    agents_decode_matches_own(_cfgs()[1])


def batcher_pads_past_the_cache_match_reference(arch, seed):
    """A 20-token prompt pads to 32 at prompt_pad 8, past a 24-slot
    cache: the reference runs all 32 positions, so each expert's
    capacity is that of 32 tokens, and drops the cache writes past slot
    23; the port's ContinuousBatcher keeps the width and gives the
    reference's tokens. Cut to the cache, the capacity would change."""
    rcfg = r_get_arch_config(arch).reduced()
    cfg = get_arch_config(arch).reduced()
    ref = jax.tree.map(np.asarray, r_model.get_model(rcfg).init(
        rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    reqs = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
            for n in (20, 3, 9)]
    assert continuous.prefill_width(cfg, 8, 20, 24) == 32
    assert continuous.prefill_width(
        cfg.with_(moe=None, mla=None, first_k_dense=0, family="dense"),
        8, 20, 24) == 24
    kw = dict(max_len=24, max_new_tokens=5)
    want = r_serving.ContinuousBatcher(
        rcfg, jax.tree.map(jnp.asarray, ref), r_serving.ServeConfig(**kw),
        batch_size=2, prompt_pad=8).run(reqs)
    got = serving.ContinuousBatcher(
        cfg, interop.transformer_params(ref), serving.ServeConfig(**kw),
        batch_size=2, prompt_pad=8).run(reqs)
    assert got == {k: [int(t) for t in v] for k, v in want.items()}


def test_continuous_batcher_pads_past_the_cache_match_reference():
    batcher_pads_past_the_cache_match_reference(ARCH, 3)


def test_group_engine_matches_each_agents_fixed_batch_engine():
    """GroupServeEngine over 2 agents' planes, 2 slots, 3 requests
    round-robin: every request's tokens equal the fixed-batch engine's
    on its agent's weights alone, at the slot engines' width."""
    _, cfg = _cfgs()
    planes = port_planes(cfg, 2)
    kw = dict(max_len=40, max_new_tokens=5)
    reqs = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12, 13], [14, 15]]
    got = serving.GroupServeEngine(
        cfg, planes, serving.ServeConfig(**kw), batch_size=2,
        prompt_pad=8).run([serving.GroupRequest(i, i % 2, r)
                           for i, r in enumerate(reqs)])
    for rid, req in enumerate(reqs):
        eng = serving.ServeEngine(cfg, tree_map(lambda t: t[rid % 2],
                                                planes),
                                  serving.ServeConfig(**kw))
        width = continuous.prefill_width(cfg, 8, len(req), kw["max_len"])
        toks = torch.zeros((1, width), dtype=torch.int32)
        toks[0, :len(req)] = torch.tensor(req, dtype=torch.int32)
        assert eng.generate(toks, [len(req)])[0].tolist() == got[rid]
