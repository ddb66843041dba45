"""Port parity: the Mamba2 block (``repro_torch.models.mamba2``), the SSM
language model (``repro_torch.models.ssm_model``), their configs and
initialisers against ``repro.models`` / ``repro.configs`` at
mamba2-780m ``reduced()`` (fp32), on the reference's own weights
carried across by ``repro_torch.interop.ssm_params``.

Both sides run the same ops in fp32; they differ in the order of the
matmuls' and the chunk recurrence's sums (``tests/test_torch_ssd_scan.py``),
so block outputs, logits and decode states are held at
rtol = atol = 2e-4, the reference's own tolerance for its two SSD
paths through ``ssd_chunked``."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch_config as r_get_arch_config  # noqa: E402
from repro.models import common as r_common  # noqa: E402
from repro.models import mamba2 as r_mamba2  # noqa: E402
from repro.models import ssm_model as r_ssm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, SSMConfig  # noqa: E402
from repro_torch.models import common, get_model, mamba2, ssm_model  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "mamba2-780m"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_np(x):
    return x.detach().numpy()


@pytest.fixture(scope="module")
def cfgs():
    return r_get_arch_config(ARCH).reduced(), get_arch_config(ARCH).reduced()


@pytest.fixture(scope="module")
def model_params(cfgs):
    rcfg, _ = cfgs
    ref = _np(r_ssm.init_ssm_model(rcfg, jax.random.PRNGKey(0)))
    return ref, interop.ssm_params(ref)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _random_state(cfg, batch, seed, layers=None):
    """A decode state of the reference's shapes with every leaf random
    (so a test sees conv tails and SSM state actually carried)."""
    lead = () if layers is None else (layers,)
    shapes = {k: v.shape[1:] for k, v in jax.eval_shape(
        lambda: r_mamba2.make_mamba_state(cfg, batch, 1)).items()}
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=lead + s).astype(np.float32) * 0.5
            for k, s in shapes.items()}


def _close(got, want):
    np.testing.assert_allclose(_torch_np(got), np.asarray(want), **TOL)


def _close_state(got, want):
    for k in interop.SSM_STATE_KEYS:
        _close(got[k], want[k])


# ---------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------
def test_published_and_reduced_configs_equal_the_reference():
    for cfg, rcfg in ((get_arch_config(ARCH), r_get_arch_config(ARCH)),
                      (get_arch_config(ARCH).reduced(),
                       r_get_arch_config(ARCH).reduced())):
        for f in dataclasses.fields(cfg):
            want = getattr(rcfg, f.name)
            got = getattr(cfg, f.name)
            if f.name == "ssm":
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
    red = get_arch_config(ARCH).reduced()
    assert (red.d_model, red.n_layers, red.vocab_size) == (256, 2, 512)
    assert red.dtype() == torch.float32
    assert (red.ssm.d_state, red.ssm.head_dim, red.ssm.chunk) == (16, 16, 32)
    assert get_arch_config(ARCH).dtype() == torch.bfloat16


def test_unported_families_and_bad_fields_are_refused():
    """Every family of the reference constructs (the audio family since
    slice 15); unknown families and bad fields raise ``ValueError``."""
    base = get_arch_config(ARCH)
    audio = ArchConfig(name="x", family="audio", n_layers=1, d_model=8,
                       n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8)
    assert audio.family == "audio"
    with pytest.raises(ValueError, match="unknown family"):
        base.with_(family="rnn")
    with pytest.raises(ValueError, match="ssd_impl"):
        base.with_(ssd_impl="pallas")
    with pytest.raises(ValueError, match="compute_dtype"):
        base.with_(compute_dtype="int8")
    assert base.with_(ssd_impl="pallas_interpret").ssd_impl == \
        "pallas_interpret"
    assert get_arch_config("musicgen-medium").family == "audio"
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch_config("mamba2-130m")
    assert base.with_(n_layers=2).ssm == SSMConfig(d_state=128, head_dim=64,
                                                    chunk=256)


# ---------------------------------------------------------------------
# common
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    want = r_common.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(w))
    got = common.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(w))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-6 if dtype == "float32" else 8e-3,
                               atol=1e-6)


def test_initialisers_draw_the_reference_distributions():
    """Not the reference's bits: the truncated normal's support (±2
    std) and std (0.8796 of the scale), the embedding's std 0.02."""
    gen = torch.Generator().manual_seed(0)
    w = common.dense_init(gen, (256, 4096), torch.float32)
    std = 1 / math.sqrt(256)
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / std - 0.87962566) < 0.01
    assert abs(float(w.mean())) < 1e-3 * std * 100
    s = common.dense_init(gen, (4, 4096), torch.float32, scale=0.3)
    assert float(s.abs().max()) <= 0.6
    e = common.embed_init(gen, (512, 256), torch.float32)
    assert abs(float(e.std()) / 0.02 - 1) < 0.01
    z = common.truncated_normal(gen, (200_000,))
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(0),
                                                  -2.0, 2.0, (200_000,)))
    for q in (0.05, 0.25, 0.5, 0.75, 0.95):
        assert abs(float(torch.quantile(z, q)) - np.quantile(want, q)) < 0.02


def test_model_init_has_the_reference_tree(cfgs):
    rcfg, cfg = cfgs
    want = jax.eval_shape(lambda: r_ssm.init_ssm_model(
        rcfg, jax.random.PRNGKey(0)))
    got = get_model(cfg).init(cfg, torch.Generator().manual_seed(1), "cpu")
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = dict(tree_leaves_with_paths(got))
    assert {tuple(p.key for p in k) for k in flat_w} == set(flat_g)
    for k, v in flat_w.items():
        g = flat_g[tuple(p.key for p in k)]
        assert tuple(g.shape) == v.shape and g.dtype == torch.float32
    lay = got["layers"]["mamba"]
    ref_layer = _np(r_mamba2.init_mamba2(rcfg, jax.random.PRNGKey(3)))
    np.testing.assert_allclose(lay["A_log"][0].numpy(), ref_layer["A_log"],
                               rtol=1e-6)
    dt0 = torch.nn.functional.softplus(lay["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1001
    assert bool((lay["D"] == 1).all()) and bool((lay["conv_x"]["b"] == 0).all())


# ---------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------
@pytest.mark.parametrize("seq", [40, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_reference(cfgs, model_params, seq,
                                          with_state):
    rcfg, cfg = cfgs
    ref_p = _layer0(model_params[0]["layers"]["mamba"])
    p = ssm_model.layer(model_params[1]["layers"]["mamba"], 0)
    x = np.random.default_rng(seq).normal(
        size=(2, seq, cfg.d_model)).astype(np.float32)
    state = _random_state(rcfg, 2, seq) if with_state else None
    want, want_state = r_mamba2.mamba2_forward(
        rcfg, ref_p, jnp.asarray(x),
        None if state is None else jax.tree.map(jnp.asarray, state))
    got, got_state = mamba2.mamba2_forward(
        cfg, p, torch.from_numpy(x),
        None if state is None else interop.ssm_state(state))
    _close(got, want)
    if with_state:
        _close_state(got_state, want_state)
    else:
        assert got_state is None and want_state is None


def test_mamba2_decode_matches_reference(cfgs, model_params):
    rcfg, cfg = cfgs
    ref_p = _layer0(model_params[0]["layers"]["mamba"])
    p = ssm_model.layer(model_params[1]["layers"]["mamba"], 0)
    x = np.random.default_rng(1).normal(
        size=(3, 1, cfg.d_model)).astype(np.float32)
    state = _random_state(rcfg, 3, 2)
    want, want_state = r_mamba2.mamba2_decode(
        rcfg, ref_p, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    got, got_state = mamba2.mamba2_decode(cfg, p, torch.from_numpy(x),
                                          interop.ssm_state(state))
    assert got.shape == (3, 1, cfg.d_model)
    _close(got, want)
    _close_state(got_state, want_state)
    back = interop.ssm_state_to_numpy(got_state)
    for k in interop.SSM_STATE_KEYS:
        assert back[k].shape == np.asarray(want_state[k]).shape


def test_causal_conv_tail_continues_the_stream(cfgs, model_params):
    """A sequence split in two, the second half continuing from the
    first half's conv tail, gives the unsplit sequence's conv output."""
    _, cfg = cfgs
    conv = ssm_model.layer(model_params[1]["layers"]["mamba"], 0)["conv_x"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 20, conv["w"].shape[1])).astype(np.float32))
    whole, _ = mamba2._causal_conv(x, conv)
    first, tail = mamba2._causal_conv(x[:, :13], conv)
    second, _ = mamba2._causal_conv(x[:, 13:], conv, tail)
    torch.testing.assert_close(torch.cat([first, second], 1), whole,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------
# the language model
# ---------------------------------------------------------------------
@pytest.mark.parametrize("with_cache", [False, True])
def test_ssm_forward_matches_reference(cfgs, model_params, with_cache):
    rcfg, cfg = cfgs
    ref_p, p = model_params
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 45),
                                             dtype=np.int32)
    rcache = r_ssm.make_ssm_cache(rcfg, 2) if with_cache else None
    want, _, want_cache = r_ssm.ssm_forward(
        rcfg, ref_p, {"tokens": jnp.asarray(toks)}, cache=rcache)
    cache = (ssm_model.make_ssm_cache(cfg, 2, device="cpu") if with_cache
             else None)
    got, aux, got_cache = ssm_model.ssm_forward(
        cfg, p, {"tokens": torch.from_numpy(toks)}, cache=cache)
    assert got.shape == (2, 45, cfg.vocab_size) and float(aux) == 0.0
    _close(got, want)
    if with_cache:
        assert got_cache["ssm"].shape == (cfg.n_layers, 2, 32, 16, 16)
        _close_state(got_cache, want_cache)
    else:
        assert got_cache is None


def test_ssm_decode_matches_reference(cfgs, model_params):
    rcfg, cfg = cfgs
    ref_p, p = model_params
    cache = _random_state(rcfg, 2, 5, layers=cfg.n_layers)
    toks = np.array([[3], [400]], np.int32)
    want, want_cache = r_ssm.ssm_decode(
        rcfg, ref_p, {"tokens": jnp.asarray(toks)},
        jax.tree.map(jnp.asarray, cache))
    got, got_cache = ssm_model.ssm_decode(
        cfg, p, {"tokens": torch.from_numpy(toks)}, interop.ssm_state(cache))
    assert got.shape == (2, 1, cfg.vocab_size)
    _close(got, want)
    _close_state(got_cache, want_cache)


def _close_bf16(got, want):
    """|got - want| <= 2**-5 * max|want| over the tensor: 8 units in the
    last place of bf16's 8 significant bits at the tensor's largest
    magnitude. Both sides round the same bf16 ops but sum their matmuls
    and fuse their elementwise ops in other orders, and the 2 layers
    carry each rounding on (the port and the reference differ by 3.2
    such units on the prefill logits at reduced())."""
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    np.testing.assert_array_less(np.abs(g - w), 2.0 ** -5 * np.abs(w).max())


def test_ssm_forward_and_decode_match_reference_in_bf16(model_params):
    """The default compute dtype (bf16) through the projections, the
    causal conv, the SSD, the block's finish and the head: a prefill
    with a cache, then one decode step on its state. Dtypes equal the
    reference's; logits and states within ``_close_bf16``."""
    rcfg = r_get_arch_config(ARCH).reduced().with_(compute_dtype="bfloat16")
    cfg = get_arch_config(ARCH).reduced().with_(compute_dtype="bfloat16")
    ref_p, p = model_params
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 45),
                                             dtype=np.int32)
    want, _, want_cache = r_ssm.ssm_forward(
        rcfg, ref_p, {"tokens": jnp.asarray(toks)},
        cache=r_ssm.make_ssm_cache(rcfg, 2))
    got, _, got_cache = ssm_model.ssm_forward(
        cfg, p, {"tokens": torch.from_numpy(toks)},
        cache=ssm_model.make_ssm_cache(cfg, 2, device="cpu"))
    step = np.array([[3], [400]], np.int32)
    want_d, want_d_cache = r_ssm.ssm_decode(
        rcfg, ref_p, {"tokens": jnp.asarray(step)}, want_cache)
    got_d, got_d_cache = ssm_model.ssm_decode(
        cfg, p, {"tokens": torch.from_numpy(step)}, got_cache)
    for g, w in ((got, want), (got_d, want_d)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _close_bf16(g, w)
    for g_c, w_c in ((got_cache, want_cache), (got_d_cache, want_d_cache)):
        for k in interop.SSM_STATE_KEYS:
            assert str(g_c[k].dtype) == f"torch.{w_c[k].dtype}"
            _close_bf16(g_c[k], w_c[k])


def test_interop_round_trips_params_and_states(cfgs, model_params):
    rcfg, _ = cfgs
    ref_p, p = model_params
    np.testing.assert_array_equal(p["embed"].numpy(), ref_p["embed"])
    np.testing.assert_array_equal(
        p["layers"]["mamba"]["conv_B"]["w"].numpy(),
        ref_p["layers"]["mamba"]["conv_B"]["w"])
    state = _random_state(rcfg, 2, 1, layers=2)
    back = interop.ssm_state_to_numpy(interop.ssm_state(state))
    for k in interop.SSM_STATE_KEYS:
        np.testing.assert_array_equal(back[k], state[k])
    bf = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
          for k, v in state.items()}
    got = interop.ssm_state(bf)
    assert got["conv_x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["conv_x"].float().numpy(),
                                  np.asarray(bf["conv_x"], np.float32))
    with pytest.raises(ValueError, match="not an SSM-model"):
        interop.ssm_params({"embed": ref_p["embed"]})
