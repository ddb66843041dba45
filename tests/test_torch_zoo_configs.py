"""Port parity: the model zoo's configs (``repro_torch.configs``) and the
shapes of every ported arch's parameters and caches at full width,
against ``repro.configs`` and ``repro.models.model``; the dense trio
qwen2-7b, granite-3-8b and yi-34b needs only its config files, so two
of them are also held at ``reduced()`` against the reference's logits.
The MoE pair qwen3-moe-30b-a3b and deepseek-v2-lite-16b (MLA and a
leading dense layer) decode with every tensor read patched to raise.
The VLM qwen2-vl-72b and the audio musicgen-medium are held here by
their configs and full-width shapes (``xkv`` cache included), and in
``test_torch_vlm.py`` / ``test_torch_audio.py`` by their numbers.

* Configs: every field equal to the reference's, published and
  ``reduced()`` (the nested ``ssm`` / ``hybrid`` dataclasses by value).
* Full-width shapes: the port's params and caches are built on the
  ``meta`` device (nothing allocated) and the reference's by
  ``jax.eval_shape`` (``param_specs``; the cache likewise): the same
  leaf paths, shapes and dtypes.
* Logits at ``reduced()``: rtol = atol = 1e-4, as
  ``tests/test_torch_transformer.py`` holds the dense family in fp32
  (the same ops, matmuls summed in other orders); qwen2-7b's QKV biases
  are drawn non-zero (the reference draws zeros).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as R_ARCH_IDS  # noqa: E402
from repro.configs import get_arch_config as r_get_arch_config  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch_config  # noqa: E402
from repro_torch.configs.base import (ArchConfig, HybridConfig,  # noqa: E402
                                      MLAConfig, MoEConfig, SSMConfig)
from repro_torch.models import get_model  # noqa: E402

MOE = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]
MODAL = ["qwen2-vl-72b", "musicgen-medium"]
NEW = ["zamba2-7b", "qwen2-7b", "granite-3-8b", "yi-34b"] + MOE + MODAL
ALL = NEW + ["llama3.2-3b", "mamba2-780m"]
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int32: "int32"}


def _fields_equal(cfg, rcfg):
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(rcfg, f.name)
        if dataclasses.is_dataclass(got) or dataclasses.is_dataclass(want):
            assert (got is None) == (want is None), f.name
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    f.name
        else:
            assert got == want, f.name


@pytest.mark.parametrize("arch", NEW)
def test_published_and_reduced_configs_equal_the_reference(arch):
    _fields_equal(get_arch_config(arch), r_get_arch_config(arch))
    _fields_equal(get_arch_config(arch).reduced(),
                  r_get_arch_config(arch).reduced())


def test_registry_has_the_zoo_and_refuses_the_rest():
    """Every arch of the reference's registry is in the port's (the VLM
    and audio families since slice 15); an unknown id raises
    ``KeyError``."""
    assert set(NEW) <= set(ARCH_IDS)
    assert set(ARCH_IDS) == set(R_ARCH_IDS)
    vl = get_arch_config("qwen2-vl-72b")
    assert (vl.family, vl.rope_mode, vl.mrope_sections,
            vl.vision_prefix) == ("vlm", "mrope", (16, 24, 24), 256)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch_config("qwen2-vl-7b")
    z = get_arch_config("zamba2-7b")
    assert (z.family, z.head_dim, z.ssm.d_state) == ("hybrid", 112, 64)
    assert z.hybrid == HybridConfig(16, 4, 1, 128)
    red = z.reduced()
    assert (red.n_layers, red.hybrid) == (3, HybridConfig(1, 1, 1, 8))
    assert red.ssm == SSMConfig(d_state=16, head_dim=16, chunk=32)
    base = dict(name="x", family="hybrid", n_layers=3, d_model=8, n_heads=1,
                n_kv_heads=1, d_ff=8, vocab_size=8)
    with pytest.raises(ValueError, match="hybrid=HybridConfig"):
        ArchConfig(**base, ssm=SSMConfig())
    with pytest.raises(ValueError, match="ssm=SSMConfig"):
        ArchConfig(**base, hybrid=HybridConfig())
    vlm = ArchConfig(**{**base, "family": "vlm"})
    assert (vlm.family, vlm.rope_mode) == ("vlm", "standard")
    with pytest.raises(ValueError, match="unknown family"):
        ArchConfig(**{**base, "family": "speech"})


def _port_shapes(tree):
    return {tuple(map(str, p)): (tuple(t.shape), DTYPES[t.dtype])
            for p, t in tree_leaves_with_paths(tree) if t is not None}


def _ref_shapes(tree):
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(tree):
        key = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)
        out[key] = (tuple(s.shape), str(s.dtype))
    return out


@pytest.mark.parametrize("arch", ALL)
def test_full_width_params_and_cache_match_reference_specs(arch):
    """Every leaf path, shape and dtype of the params and of a (B = 2,
    max_len = 64) cache, port on ``meta``, reference by
    ``jax.eval_shape``."""
    cfg, rcfg = get_arch_config(arch), r_get_arch_config(arch)
    model, rmodel = get_model(cfg), r_model.get_model(rcfg)
    params = model.init(cfg, None, "meta")
    assert all(t.device.type == "meta"
               for _, t in tree_leaves_with_paths(params))
    assert _port_shapes(params) == _ref_shapes(r_model.param_specs(rcfg))
    cache = model.make_cache(cfg, 2, 64, device="meta")
    want = jax.eval_shape(lambda: rmodel.make_cache(rcfg, 2, 64))
    assert _port_shapes(cache) == _ref_shapes(want)


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S), dtype=np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return toks, pos


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-3-8b"])
def test_reduced_prefill_and_decode_logits_match_reference(arch):
    """Prefill of 2 x 24 ids into a 40-slot cache, then 3 decode steps,
    on the reference's weights: logits at every step and the cache
    after the last within 1e-4."""
    rcfg = r_get_arch_config(arch).reduced()
    cfg = get_arch_config(arch).reduced()
    rmodel, model = r_model.get_model(rcfg), get_model(cfg)
    ref = jax.tree.map(np.asarray, rmodel.init(rcfg, jax.random.PRNGKey(1)))
    if rcfg.qkv_bias:
        rng = np.random.default_rng(1)
        attn_p = ref["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn_p[name] = rng.normal(size=attn_p[name].shape).astype(
                np.float32) * 0.5
    params = interop.transformer_params(ref)
    rparams = jax.tree.map(jnp.asarray, ref)
    toks, pos = _batch(cfg.vocab_size, 2, 24, 2)
    rlog, rcache = rmodel.forward(rcfg, rparams, {
        "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)},
        rmodel.make_cache(rcfg, 2, 40))
    with torch.no_grad():
        plog, pcache = model.forward(cfg, params, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos)},
            model.make_cache(cfg, 2, 40, device="cpu"))
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
    rdec = jax.jit(lambda p, b, c: rmodel.decode(rcfg, p, b, c))
    nxt = np.argmax(np.asarray(rlog)[:, -1], -1).astype(np.int32)[:, None]
    for t in range(3):
        p_t = np.full((2, 1), 24 + t, np.int32)
        rlog, rcache = rdec(rparams, {"tokens": jnp.asarray(nxt),
                                      "positions": jnp.asarray(p_t)}, rcache)
        with torch.no_grad():
            plog, pcache = model.decode(cfg, params, {
                "tokens": torch.from_numpy(nxt),
                "positions": torch.from_numpy(p_t)}, pcache)
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL)
        nxt = np.argmax(np.asarray(rlog)[:, -1], -1).astype(np.int32)[:, None]
    got = interop.kv_cache_to_numpy(pcache)["layers"]["kv"]
    for k in interop.KV_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(
            rcache["layers"]["kv"][k]), **TOL)


def test_moe_configs_and_their_refusals():
    """The MoE pair's nested configs and ``reduced()`` cuts, the
    reference's; a moe family needs ``moe``, the SSM and hybrid families
    refuse ``moe`` / ``mla`` / ``first_k_dense``, ``first_k_dense`` is
    0 or 1 with a width, and ``moe_dispatch`` takes the reference's
    three values (every one dispatches dense on one device)."""
    q, d = (get_arch_config(a) for a in MOE)
    assert q.moe == MoEConfig(n_experts=128, top_k=8, expert_ff=768)
    assert (q.mla, q.first_k_dense) == (None, 0)
    assert d.moe == MoEConfig(n_experts=64, top_k=6, expert_ff=1408,
                              n_shared=2)
    assert d.mla == MLAConfig(kv_lora_rank=512, qk_nope_dim=128,
                              qk_rope_dim=64, v_dim=128)
    assert (d.first_k_dense, d.dense_ff) == (1, 10944)
    red = d.reduced()
    assert (red.n_layers, red.first_k_dense, red.dense_ff) == (2, 1, 128)
    assert red.moe == MoEConfig(n_experts=4, top_k=2, expert_ff=128,
                                n_shared=1)
    assert red.mla == MLAConfig(kv_lora_rank=64, qk_nope_dim=32,
                                qk_rope_dim=16, v_dim=32)
    base = dict(name="x", n_layers=3, d_model=8, n_heads=1, n_kv_heads=1,
                d_ff=8, vocab_size=8)
    with pytest.raises(ValueError, match="moe=MoEConfig"):
        ArchConfig(**base, family="moe")
    with pytest.raises(ValueError, match="transformer's layers"):
        ArchConfig(**base, family="ssm", ssm=SSMConfig(), mla=MLAConfig())
    with pytest.raises(ValueError, match="first_k_dense"):
        q.with_(first_k_dense=2, dense_ff=8)
    with pytest.raises(ValueError, match="first_k_dense"):
        q.with_(first_k_dense=1)
    with pytest.raises(ValueError, match="moe_dispatch"):
        q.with_(moe_dispatch="sparse")
    for dispatch in ("auto", "dense", "expert_parallel"):
        assert q.with_(moe_dispatch=dispatch).moe_dispatch == dispatch
    for kw in (dict(family="vlm"), dict(family="audio"),
               dict(cross_attention=True), dict(rope_mode="mrope")):
        cfg = d.with_(**kw)
        for k, v in kw.items():
            assert getattr(cfg, k) == v


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_reads_nothing_back(arch):
    """ServeEngine.decode and one group step's batched decode at
    ``reduced()``, with every tensor→host read patched to raise (the
    dense dispatch has static shapes: no nonzero, no mask indexing, no
    item): the same tokens and logits as unpatched."""
    from test_torch_serving_nosync import no_reads

    from repro_torch import serving
    from repro_torch.common.pytree import tree_map
    cfg = get_arch_config(arch).reduced()
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = serving.ServeEngine(cfg, params, serving.ServeConfig(
        max_len=32, max_new_tokens=6))
    toks, lens = serving.serve_batches([[5, 9, 200, 31], [11, 400]], 2,
                                       device="cpu")[0]
    logits, cache = eng.prefill(toks, lens)
    want = eng.decode(logits, cache, lens)
    host = [int(n) for n in lens]
    with no_reads():
        got = eng.decode(logits, cache, host)
    assert torch.equal(got, want)
    planes = tree_map(lambda t: torch.stack([t, t * 0.5]), params)
    grp = serving.GroupServeEngine(
        cfg, planes, serving.ServeConfig(max_len=32, max_new_tokens=6),
        batch_size=2, prompt_pad=8)
    for rid in range(2):
        grp.submit(serving.GroupRequest(rid, rid, [3 + rid, 7, 11]))
    grp.step()
    slots = grp._state
    batch = {"tokens": slots.tokens, "positions": slots.pos_dev[:, None]}
    live, _ = grp.store.acquire()
    want, _ = grp.decode_step(live, batch, slots.cache)
    with no_reads():
        got, _ = grp.decode_step(live, batch, slots.cache)
    assert torch.equal(got, want)
