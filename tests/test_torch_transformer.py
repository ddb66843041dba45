"""Port parity: the dense transformer family
(``repro_torch.models.{rope, common, mlp, attention, transformer}``)
against ``repro.models`` at llama3.2-3b ``reduced()``, on the
reference's own weights carried across by
``repro_torch.interop.transformer_params``.

Tolerances, each with its reason:

* RoPE: rtol = atol = 1e-6. torch's and XLA's fp32 ``sin``, ``cos`` and
  ``pow`` differ by one unit in the last place on some arguments
  (``ROADMAP.md`` §3), a relative 6e-8 on each factor.
* Blocks, logits and losses in fp32: rtol = atol = 1e-4. Both sides run
  the same fp32 ops but sum their matmuls in other orders, RoPE adds
  the ulp above, and on the cache-free pass the port's flash attention
  (its plain version on the CPU) meets the reference's XLA softmax or
  its Pallas kernel (largest difference seen: 1.4e-6 on logits of
  magnitude 1.5).
* bf16 compute: |got − want| ≤ 2^-5 · max|want| over the tensor, eight
  bf16 units at its largest magnitude, as ``tests/test_torch_mamba2.py``
  holds the SSM family: the two frameworks round the same bf16 ops but
  sum and fuse in other orders, and two layers carry each rounding on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch_config as r_get_arch_config  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import common as r_common  # noqa: E402
from repro.models import mlp as r_mlp  # noqa: E402
from repro.models import rope as r_rope  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common.pytree import (layer,  # noqa: E402
                                       tree_leaves_with_paths)
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import (attention, common,  # noqa: E402
                                get_model, mlp, rope, transformer)

ARCH = "llama3.2-3b"
TOL = dict(rtol=1e-4, atol=1e-4)
ROPE_TOL = dict(rtol=1e-6, atol=1e-6)
# the reduced config (4 heads, 4 kv heads), GQA 3, and QKV biases
VARIANTS = {"reduced": {}, "gqa3": dict(n_heads=6, n_kv_heads=2),
            "qkv_bias": dict(qkv_bias=True)}


def _cfgs(**kw):
    return (r_get_arch_config(ARCH).reduced().with_(**kw),
            get_arch_config(ARCH).reduced().with_(**kw))


def _params(rcfg, seed=0):
    ref = jax.tree.map(np.asarray, r_tf.init_transformer(
        rcfg, jax.random.PRNGKey(seed)))
    if rcfg.qkv_bias:         # the reference draws zero biases: make them
        rng = np.random.default_rng(seed)     # count in the comparison
        attn_p = ref["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn_p[name] = rng.normal(size=attn_p[name].shape).astype(
                np.float32) * 0.5
    return ref, interop.transformer_params(ref)


@pytest.fixture(scope="module")
def variant_params():
    return {name: _params(_cfgs(**kw)[0]) for name, kw in VARIANTS.items()}


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                     # ignored by the loss
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"tokens": toks[:, :-1].copy(), "labels": labels,
            "positions": pos}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or TOL))


def _close_bf16(got, want):
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    np.testing.assert_array_less(np.abs(g - w), 2.0 ** -5 * np.abs(w).max())


# ---------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------
def test_published_and_reduced_configs_equal_the_reference():
    for cfg, rcfg in ((get_arch_config(ARCH), r_get_arch_config(ARCH)),
                      _cfgs()[::-1]):
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    full = get_arch_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == \
        (28, 3072, 24, 8, 128, 8192, 128256)
    assert full.tie_embeddings and full.rope_theta == 5e5
    assert full.dtype() == torch.bfloat16 and full.dtype("param") == \
        torch.float32
    windowed = full.with_(sliding_window=4096).reduced()
    assert windowed.sliding_window == \
        r_get_arch_config(ARCH).with_(sliding_window=4096).reduced() \
        .sliding_window == 16


def test_unported_dense_fields_are_refused():
    """The VLM and audio fields construct now (slice 15): M-RoPE, both
    families and cross-attention; unknown values still raise
    ``ValueError``."""
    base = get_arch_config(ARCH)
    for kw in (dict(rope_mode="mrope"), dict(family="vlm"),
               dict(family="audio"), dict(cross_attention=True)):
        cfg = base.with_(**kw)
        for k, v in kw.items():
            assert getattr(cfg, k) == v
    with pytest.raises(ValueError, match="rope_mode"):
        base.with_(rope_mode="alibi")
    with pytest.raises(ValueError, match="attention_impl"):
        base.with_(attention_impl="triton")
    with pytest.raises(ValueError, match="attention_scores_dtype"):
        base.with_(attention_scores_dtype="float16")
    with pytest.raises(ValueError, match="n_kv_heads dividing"):
        base.with_(n_kv_heads=5)
    audio = ArchConfig(name="x", family="audio", n_layers=1, d_model=8,
                       n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8)
    assert (audio.n_codebooks, audio.cond_len, audio.vision_prefix,
            audio.mrope_sections) == (1, 0, 0, (16, 24, 24))
    with pytest.raises(ValueError, match="n_kv_heads dividing"):
        audio.with_(n_heads=3, n_kv_heads=2)
    for impl in ("xla", "pallas", "pallas_interpret"):
        assert base.with_(attention_impl=impl).attention_impl == impl


# ---------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 50, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 50)).astype(np.int32)
    want = r_rope.rope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), 5e5)
    got = rope.rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                    torch.from_numpy(pos), 5e5)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, **ROPE_TOL)
    else:
        _close_bf16(got, want)
    np.testing.assert_allclose(
        rope._angles(torch.from_numpy(pos), 32, 5e5).numpy(),
        np.asarray(r_rope._angles(jnp.asarray(pos), 32, 5e5)), **ROPE_TOL)
    cfg = get_arch_config(ARCH).reduced().with_(rope_mode="none")
    xt = torch.from_numpy(x)
    assert rope.apply_rope(cfg, xt, torch.from_numpy(pos)) is xt


def test_swiglu_matches_reference():
    rng = np.random.default_rng(1)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    want = r_mlp.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jnp.float32)
    got = mlp.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), torch.float32)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 3])
def test_causal_mask_bias_equals_reference(window):
    rng = np.random.default_rng(2)
    q_pos = rng.integers(0, 20, (2, 6)).astype(np.int32)
    k_pos = rng.integers(-1, 20, (2, 9)).astype(np.int32)
    valid = k_pos >= 0
    want = r_common.causal_mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                     window, jnp.asarray(valid))
    got = common.causal_mask_bias(torch.from_numpy(q_pos),
                                  torch.from_numpy(k_pos), window,
                                  torch.from_numpy(valid))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 6, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scores_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,K", [(4, 4), (6, 2)])
def test_softmax_attention_matches_reference(H, K, scores_dtype):
    rng = np.random.default_rng(H + K)
    q = rng.normal(size=(2, 5, H, 16)).astype(np.float32)
    k = rng.normal(size=(2, 9, K, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, K, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(4, 9, dtype=np.int32), (2, 5))
    k_pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    k_pos[1, 7:] = -1
    bias = np.array(r_common.causal_mask_bias(
        jnp.asarray(pos), jnp.asarray(k_pos), None,
        jnp.asarray(k_pos >= 0)))
    want = r_common.softmax_attention(*map(jnp.asarray, (q, k, v, bias)),
                                      0.25, getattr(jnp, scores_dtype))
    got = common.softmax_attention(*map(torch.from_numpy, (q, k, v, bias)),
                                   0.25, getattr(torch, scores_dtype))
    if scores_dtype == "float32":
        _close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _close_bf16(got, want)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[1, 2:5] = -100
    want = float(r_common.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    got = float(common.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    none = np.full((2, 7), -100, np.int32)
    assert float(common.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(none))) == 0.0


# ---------------------------------------------------------------------
# self-attention, both branches
# ---------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["reduced", "gqa3", "qkv_bias"])
def test_self_attention_without_cache_matches_reference(variant,
                                                        variant_params):
    """The cache-free branch: the port's flash wrapper (its plain
    version on the CPU) against the reference's XLA softmax and its
    Pallas kernel in interpret mode."""
    rcfg, cfg = _cfgs(**VARIANTS[variant])
    ref_p, p = variant_params[variant]
    ref_a = jax.tree.map(lambda a: jnp.asarray(a[0]), ref_p["layers"]["attn"])
    x = np.random.default_rng(4).normal(
        size=(2, 33, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(33, dtype=np.int32), (2, 33))
    launches = fa_ops.flash_attention.launches
    got, got_cache = attention.self_attention(
        cfg, layer(p["layers"]["attn"], 0), torch.from_numpy(x),
        torch.from_numpy(pos.copy()))
    assert got_cache is None and fa_ops.flash_attention.launches == launches
    for impl in ("xla", "pallas_interpret"):
        want, _ = r_attn.self_attention(rcfg.with_(attention_impl=impl),
                                        ref_a, jnp.asarray(x),
                                        jnp.asarray(pos))
        _close(got, want)


def test_self_attention_with_cache_matches_reference(variant_params):
    """The cached branch: a layer cache with some slots filled, new
    tokens written at their positions, attention over the slots by
    position. The cache comes back new; the one given is unchanged."""
    rcfg, cfg = _cfgs(**VARIANTS["gqa3"])
    ref_p, p = variant_params["gqa3"]
    ref_a = jax.tree.map(lambda a: jnp.asarray(a[0]), ref_p["layers"]["attn"])
    rng = np.random.default_rng(5)
    K, D = cfg.n_kv_heads, cfg.head_dim
    lc = {"k": rng.normal(size=(2, 24, K, D)).astype(np.float32),
          "v": rng.normal(size=(2, 24, K, D)).astype(np.float32),
          "pos": np.full((2, 24), -1, np.int32)}
    lc["pos"][:, :10] = np.arange(10)
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    pos = np.array([[10, 11, 12], [10, 11, 12]], np.int32)
    want, want_c = r_attn.self_attention(
        rcfg, ref_a, jnp.asarray(x), jnp.asarray(pos),
        layer_cache=jax.tree.map(jnp.asarray, lc))
    given = {k: torch.from_numpy(v.copy()) for k, v in lc.items()}
    got, got_c = attention.self_attention(
        cfg, layer(p["layers"]["attn"], 0), torch.from_numpy(x),
        torch.from_numpy(pos), given)
    _close(got, want)
    np.testing.assert_array_equal(got_c["pos"].numpy(),
                                  np.asarray(want_c["pos"]))
    for k in ("k", "v"):
        _close(got_c[k], want_c[k])
        np.testing.assert_array_equal(given[k].numpy(), lc[k])


# ---------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------
def test_model_init_has_the_reference_tree():
    for kw in VARIANTS.values():
        rcfg, cfg = _cfgs(**kw)
        want = jax.eval_shape(lambda: r_tf.init_transformer(
            rcfg, jax.random.PRNGKey(0)))
        got = get_model(cfg).init(cfg, torch.Generator().manual_seed(1),
                                  "cpu")
        flat_w = {tuple(p.key for p in k): v for k, v in
                  jax.tree_util.tree_leaves_with_path(want)}
        flat_g = dict(tree_leaves_with_paths(got))
        assert set(flat_w) == set(flat_g)
        for k, v in flat_w.items():
            assert tuple(flat_g[k].shape) == v.shape, k
            assert flat_g[k].dtype == torch.float32
    assert bool((got["layers"]["attn"]["bq"] == 0).all())
    assert bool((got["layers"]["ln1"] == 1).all())
    # layers are drawn one by one, not copies of one another
    assert not torch.equal(got["layers"]["attn"]["wq"][0],
                           got["layers"]["attn"]["wq"][1])


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("variant", ["reduced", "gqa3", "qkv_bias"])
def test_forward_and_loss_match_reference(variant, impl, variant_params):
    """The cache-free pass (``get_model(cfg).forward(..., None)``, the
    path that runs the flash kernel on the card) and the loss, fp32."""
    rcfg, cfg = _cfgs(**VARIANTS[variant])
    rcfg = rcfg.with_(attention_impl=impl)
    cfg = cfg.with_(attention_impl=impl)
    ref_p, p = variant_params[variant]
    batch = _batch(cfg, 2, 40, seed=len(variant))
    want, _, _ = r_tf.transformer_forward(rcfg, ref_p, _j(batch))
    want_loss = r_common.cross_entropy(want, jnp.asarray(batch["labels"]))
    model = get_model(cfg)
    got, cache = model.forward(cfg, p, _t(batch), None)
    assert cache is None and got.shape == (2, 40, cfg.vocab_size)
    _close(got, want)
    got_loss = model.loss(cfg, p, _t(batch))
    assert got_loss.shape == () and got_loss.dtype == torch.float32
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    if variant == "reduced":
        assert float(r_tf.transformer_loss(rcfg, ref_p, _j(batch))) == \
            pytest.approx(float(want_loss), rel=1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_forward_and_loss_match_reference_in_bf16(impl, variant_params):
    rcfg, cfg = _cfgs(**VARIANTS["gqa3"])
    rcfg = rcfg.with_(compute_dtype="bfloat16", attention_impl=impl)
    cfg = cfg.with_(compute_dtype="bfloat16")
    ref_p, p = variant_params["gqa3"]
    batch = _batch(cfg, 2, 40, seed=9)
    want, _, _ = r_tf.transformer_forward(rcfg, ref_p, _j(batch))
    got, _, _ = transformer.transformer_forward(cfg, p, _t(batch))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close_bf16(got, want)
    want_loss = float(r_common.cross_entropy(want,
                                             jnp.asarray(batch["labels"])))
    got_loss = float(transformer.transformer_loss(cfg, p, _t(batch)))
    assert got_loss == pytest.approx(want_loss, rel=1e-2)


def test_interop_round_trips_params_and_caches(variant_params):
    rcfg, _ = _cfgs()
    ref_p, p = variant_params["reduced"]
    np.testing.assert_array_equal(p["embed"].numpy(), ref_p["embed"])
    np.testing.assert_array_equal(p["layers"]["mlp"]["w_up"].numpy(),
                                  ref_p["layers"]["mlp"]["w_up"])
    cache = jax.tree.map(np.asarray, r_tf.make_transformer_cache(rcfg, 2, 8))
    rng = np.random.default_rng(0)
    cache["layers"]["kv"]["k"] = rng.normal(
        size=cache["layers"]["kv"]["k"].shape).astype(np.float32)
    back = interop.kv_cache_to_numpy(interop.kv_cache(cache))
    for k in interop.KV_KEYS:
        np.testing.assert_array_equal(back["layers"]["kv"][k],
                                      cache["layers"]["kv"][k])
    bf = jax.tree.map(np.asarray, r_tf.make_transformer_cache(
        rcfg.with_(compute_dtype="bfloat16"), 2, 8))
    assert interop.kv_cache(bf)["layers"]["kv"]["v"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not a dense-transformer"):
        interop.transformer_params({"embed": ref_p["embed"]})
    with pytest.raises(ValueError, match="not a transformer KV cache"):
        interop.kv_cache({"layers": {"ssm": 0}})
