"""Port parity: Multi-head Latent Attention
(``repro_torch.models.attention.mla_attention``) and the DeepSeek-V2
transformer with its leading dense layer at deepseek-v2-lite-16b
``reduced()`` widths (fp32), against ``repro.models.attention`` and
``repro.models.transformer`` on the reference's own weights.

* Both MLA branches against the reference's: the expanded one (no
  cache; a cache no wider than the pass; a pass past the cache, whose
  writes past it are dropped) and the absorbed one (a decode step; a
  prefill into a wider cache, which the reference also absorbs), out
  and the new cache within 1e-5 (out: of its largest entry);
  ``mla_absorb=False`` gives the absorbed cases within 1e-5; per-row
  weights (the group engine's slots) give each row its own result.
* The model (rtol = atol = 1e-4): the loss with the MoE auxiliary
  term, prefill logits and every cache leaf, ``layer0``'s too, 4 decode
  steps; ``agents=`` decode of 2 agents against each agent's own; the
  ContinuousBatcher against the reference's past the cache; the slot
  plumbing's batch dims of the latent and ``layer0`` caches.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch_config as r_get_arch_config  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common.pytree import (tree_leaves_with_paths,  # noqa: E402
                                       tree_map)
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.models import attention, get_model  # noqa: E402
from repro_torch.serving import api  # noqa: E402
from test_torch_moe import (agents_decode_matches_own,  # noqa: E402
                            batcher_pads_past_the_cache_match_reference,
                            close_cache, close_out, run_model)

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
# (S queries from position `start`, T cache slots or None, drop_past):
# which branch the reference takes follows from S < T with a cache
CASES = {
    "no cache, expanded": (24, 0, None, False),
    "prefill into a wider cache, absorbed": (12, 0, 20, False),
    "prefill filling the cache, expanded": (16, 0, 16, False),
    "past the cache, expanded": (24, 0, 16, True),
    "decode step, absorbed": (1, 12, 20, False),
}


def _cfgs():
    return r_get_arch_config(ARCH).reduced(), get_arch_config(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def _mla_params(seed):
    rcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, r_attn.init_mla(
        rcfg, jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _ref_mla():
    return jax.jit(functools.partial(r_attn.mla_attention, _cfgs()[0]))


def _port_mla(ref):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), ref)


def _filled_cache(rcfg, ref, T, start, seed):
    """A one-layer reference MLA cache of T slots holding a prefill of
    ``start`` positions (empty for start = 0), numpy leaves."""
    cache = jax.tree.map(lambda c: c[0], r_attn.make_mla_cache(rcfg, B, T, 1))
    if start:
        x = np.random.default_rng(seed).normal(
            size=(B, start, rcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(start, dtype=np.int32), (B, start))
        _, cache = _ref_mla()(
            jax.tree.map(jnp.asarray, ref), jnp.asarray(x),
            jnp.asarray(pos), cache)
    return jax.tree.map(np.asarray, cache)


def _case(name, cfg_kw=None):
    """Both sides' (out, new cache) of ``mla_attention`` in case
    ``name`` on the reference's weights (seed 0)."""
    S, start, T, drop_past = CASES[name]
    rcfg, cfg = _cfgs()
    if cfg_kw:
        cfg = cfg.with_(**cfg_kw)
    ref = _mla_params(0)
    cache = None if T is None else _filled_cache(rcfg, ref, T, start, 1)
    x = np.random.default_rng(2).normal(
        size=(B, S, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                          (B, S)).copy()
    want, wcache = _ref_mla()(
        jax.tree.map(jnp.asarray, ref), jnp.asarray(x), jnp.asarray(pos),
        None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, gcache = attention.mla_attention(
        cfg, _port_mla(ref), torch.from_numpy(x), torch.from_numpy(pos),
        None if cache is None else tree_map(
            lambda c: torch.from_numpy(np.array(c)), cache), drop_past)
    return ((got.numpy(), None if gcache is None else
             tree_map(lambda t: t.numpy(), gcache)),
            (np.asarray(want), None if wcache is None else
             jax.tree.map(np.asarray, wcache)))


@pytest.mark.parametrize("name", list(CASES))
def test_mla_branches_match_reference(name):
    (got, gcache), (want, wcache) = _case(name)
    close_out(got, want)
    assert (gcache is None) == (wcache is None)
    if gcache is not None:
        for k in ("ckv", "k_rope", "pos"):
            np.testing.assert_allclose(gcache[k], wcache[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["prefill into a wider cache, absorbed",
                                  "decode step, absorbed"])
def test_expanded_branch_agrees_with_the_absorbed_one(name):
    """``mla_absorb=False`` re-expands keys and values where the
    absorbed branch scores against the latent: the same function,
    summed in another order."""
    (absorbed, _), _ = _case(name)
    (expanded, _), _ = _case(name, dict(mla_absorb=False))
    close_out(expanded, absorbed)
    assert not np.array_equal(expanded, absorbed)


@pytest.mark.parametrize("name", ["no cache, expanded",
                                  "decode step, absorbed"])
def test_per_row_mla_weights_match_each_rows_own(name):
    """Every MLA weight with a leading batch axis (the group engine's
    slots): row b under its own weights, both branches."""
    S, start, T, _ = CASES[name]
    rcfg, cfg = _cfgs()
    refs = [_mla_params(s) for s in (0, 3)]
    rows = tree_map(lambda a, b: torch.stack([a, b]),
                    *[_port_mla(r) for r in refs])
    cache = None if T is None else tree_map(
        lambda c: torch.from_numpy(np.array(c)),
        _filled_cache(rcfg, refs[0], T, start, 1))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    pos = torch.arange(start, start + S, dtype=torch.int32).expand(B, S)
    got, gcache = attention.mla_attention(cfg, rows, x, pos, cache)
    for b in range(B):
        one = None if cache is None else tree_map(lambda c: c[b:b + 1],
                                                  cache)
        want, wcache = attention.mla_attention(
            cfg, _port_mla(refs[b]), x[b:b + 1], pos[b:b + 1], one)
        torch.testing.assert_close(got[b:b + 1], want, rtol=1e-5, atol=1e-5)
        if cache is not None:
            for k in wcache:
                torch.testing.assert_close(gcache[k][b:b + 1], wcache[k])


# ---------------------------------------------------------------------
# the model, with its leading dense layer
# ---------------------------------------------------------------------
_run = functools.lru_cache(maxsize=None)(run_model)


def test_loss_with_aux_matches_reference():
    r = _run(ARCH)
    assert r["ref"]["aux"] > 0
    np.testing.assert_allclose(r["port"]["aux"], r["ref"]["aux"], **TOL)
    np.testing.assert_allclose(r["port"]["loss"], r["ref"]["loss"], **TOL)


def test_prefill_logits_and_cache_with_layer0_match_reference():
    r = _run(ARCH)
    np.testing.assert_allclose(r["port"]["prefill"][0],
                               r["ref"]["prefill"][0], **TOL)
    got = r["port"]["prefill"][1]
    assert sorted(got) == ["layer0", "layers"]
    assert sorted(got["layer0"]["kv"]) == ["ckv", "k_rope", "pos"]
    assert got["layer0"]["kv"]["ckv"].shape[0] == 1
    close_cache(got, r["ref"]["prefill"][1])


def test_decode_steps_match_reference():
    r = _run(ARCH)
    for t, (g, w) in enumerate(zip(r["port"]["decode"][0],
                                   r["ref"]["decode"][0])):
        np.testing.assert_allclose(g, w, err_msg=f"step {t}", **TOL)
    close_cache(r["port"]["decode"][1], r["ref"]["decode"][1])


def test_params_and_cache_round_trip_through_interop():
    _, cfg = _cfgs()
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(params) == ["embed", "final_norm", "layer0", "layers",
                              "lm_head"]
    assert sorted(params["layer0"]) == ["attn", "ln1", "ln2", "mlp"]
    assert sorted(params["layers"]["moe"]) == ["experts", "router",
                                               "shared"]
    back = interop.transformer_params(tree_map(lambda t: t.numpy(), params))
    for (_, a), (_, b) in zip(*(tree_leaves_with_paths(t)
                                for t in (params, back))):
        assert torch.equal(a, b)
    cache = model.make_cache(cfg, 2, 8, device="cpu")
    again = interop.kv_cache(interop.kv_cache_to_numpy(cache))
    assert sorted(again) == ["layer0", "layers"]
    with pytest.raises(ValueError, match="not a transformer KV cache"):
        interop.kv_cache({"layers": {"kv": {"ckv": 0}}})


def test_cache_batch_dims_of_the_latent_and_layer0_caches():
    """The slot plumbing finds batch dim 1 in every leaf of the MLA
    cache, ``layer0``'s (1, B, ...) included, and a B = 1 cache spliced
    into a slot lands there and nowhere else."""
    _, cfg = _cfgs()
    dims = api.cache_batch_dims(cfg, 16)
    assert sorted(dims) == ["layer0", "layers"]
    for part in dims.values():
        assert part["kv"] == {"ckv": 1, "k_rope": 1, "pos": 1}
    model = get_model(cfg)
    batch = model.make_cache(cfg, 3, 16, device="cpu")
    one = tree_map(lambda t: torch.ones_like(t), model.make_cache(
        cfg, 1, 16, device="cpu"))
    api.splice_cache(batch, one, dims, 1)
    for part in batch.values():
        for k, t in part["kv"].items():
            assert bool((t[:, 1] == 1).all()), k
            assert not bool((t[:, 0] == 1).any()), k


def test_agents_decode_matches_each_agents_own_decode():
    agents_decode_matches_own(_cfgs()[1])


def test_continuous_batcher_pads_past_the_cache_match_reference():
    batcher_pads_past_the_cache_match_reference(ARCH, 2)
