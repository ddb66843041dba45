"""The streaming trainer's inputs and losses on the CPU:

* ``repro_torch.data.synthetic``: the Markov walk bitwise on the
  reference's successor table and draws (the port's streams are its
  own, from ``torch.Generator``s, so they are held by their properties:
  deterministic, per agent, the batch layout the reference builds);
* the differentiable losses against ``jax.grad`` of the reference's on
  the same weights and batch: ``ssm_loss`` (reduced mamba2-780m, a
  sequence that is not a chunk multiple) and ``transformer_loss``
  (reduced llama3.2-3b; a sliding window; bf16 attention scores).
  fp32: loss rtol 1e-5, each gradient leaf within 1e-4 of its largest
  entry; bf16 scores: loss rtol 2e-3, gradients within 2e-2 of the
  largest (the scores and softmax round to bf16 on both sides, in
  another order);
* a full chunk's SSD gradient: the reference's einsum form takes the
  exp of the positive decay differences above the diagonal before it
  masks them, which overflows and makes its gradient NaN; the port
  masks first, so its forward is bitwise the reference's and its
  gradient finite;
* the route rule: a pass that autograd records calls the flash or SSD
  kernel wrapper once per layer, as a pass with no gradient does, and
  its gradients equal bitwise those of the same loss differentiated
  through the plain versions (``kernels.plain_vjp``); it refuses a
  Pallas ``attention_impl`` / ``ssd_impl``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_arch_config as ref_arch  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data import StreamSpec as RefStream  # noqa: E402
from repro.data import synthetic as ref_syn  # noqa: E402
from repro.models import get_model as ref_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import NotPortedError, ShapeConfig  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


@pytest.mark.parametrize("similarity,agent,step", [(0.5, 0, 0), (0.5, 3, 7),
                                                   (0.0, 1, 2), (1.0, 2, 5)])
def test_markov_walk_bitwise_on_reference_draws(similarity, agent, step):
    spec = RefStream(seed=11, similarity=similarity)
    vocab, batch, seq = 512, 3, 50
    table = np.array(ref_syn._markov_table(spec, vocab, agent))
    key = ref_syn._agent_key(spec, agent, step)
    k0, kb = jax.random.split(key)
    n = min(spec.n_states, vocab)
    s0 = np.array(jax.random.randint(k0, (batch,), 0, n))
    br = np.array(jax.random.randint(kb, (batch, seq), 0, spec.branch))
    want = np.asarray(ref_syn._markov_tokens(spec, vocab, agent, step,
                                             batch, seq))
    got = syn.markov_walk(torch.from_numpy(table).long(),
                          torch.from_numpy(s0), torch.from_numpy(br))
    np.testing.assert_array_equal(got.numpy(), want)


def test_streams_are_deterministic_per_agent_and_shaped_as_reference():
    pcfg = get_arch_config("llama3.2-3b").reduced()
    rcfg = ref_arch("llama3.2-3b").reduced()
    shape = ShapeConfig("t", 33, 3, "train")
    spec = syn.StreamSpec(seed=4)
    got = syn.make_group_batch(pcfg, shape, spec, 3, 5, "cpu")
    again = syn.make_group_batch(pcfg, shape, spec, 3, 5, "cpu")
    want = ref_syn.make_group_batch(rcfg, RefShape("t", 33, 3, "train"),
                                    RefStream(seed=4), 3, 5)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == torch.int32
        assert torch.equal(got[k], again[k])
    assert torch.equal(got["labels"], got["tokens"])
    np.testing.assert_array_equal(got["positions"].numpy(),
                                  np.asarray(want["positions"]))
    toks = got["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < spec.n_states
    assert not torch.equal(toks[0], toks[1])            # own stream each
    assert not torch.equal(toks, syn.make_group_batch(
        pcfg, shape, spec, 3, 6, "cpu")["tokens"])       # per step
    # each agent's tokens follow its own chain: successor in the table
    for a in range(3):
        table = syn.markov_table(spec, pcfg.vocab_size, a)
        t = toks[a].long()
        nxt = t[:, 1:]
        ok = (table[t[:, :-1]] == nxt[..., None]).any(-1)
        assert bool(ok.all())
    same = syn.StreamSpec(seed=4, similarity=1.0)
    assert torch.equal(syn.markov_table(same, 512, 0),
                       syn.markov_table(same, 512, 3))
    apart = syn.StreamSpec(seed=4, similarity=0.0)
    assert not torch.equal(syn.markov_table(apart, 512, 0),
                           syn.markov_table(apart, 512, 3))
    uni = syn.make_agent_batch(pcfg, shape, syn.StreamSpec(kind="uniform"),
                               0, 0, "cpu")
    assert int(uni["tokens"].max()) < pcfg.vocab_size
    for arch in ("musicgen-medium", "qwen2-vl-72b"):     # since slice 15
        batch = syn.make_agent_batch(get_arch_config(arch).reduced(), shape,
                                     spec, 0, 0, "cpu")
        assert int(batch["tokens"].max()) < spec.n_states


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-72b"])
def test_modal_batches_are_shaped_as_reference(arch):
    """The audio and VLM batches: the reference's keys, shapes and
    dtypes (``cond`` / ``vision`` in the compute dtype), deterministic
    per agent and step, the stub embeddings 0.02 · N(0, 1)."""
    pcfg, rcfg = get_arch_config(arch).reduced(), ref_arch(arch).reduced()
    shape = ShapeConfig("t", 24, 3, "train")
    spec = syn.StreamSpec(seed=4)
    got = syn.make_group_batch(pcfg, shape, spec, 2, 5, "cpu")
    want = ref_syn.make_group_batch(rcfg, RefShape("t", 24, 3, "train"),
                                    RefStream(seed=4), 2, 5)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[1] == str(v.dtype), k
        assert torch.equal(got[k], syn.make_group_batch(
            pcfg, shape, spec, 2, 5, "cpu")[k]), k
    emb = got["cond" if "cond" in got else "vision"]
    assert 0.015 < float(emb.std()) < 0.025
    assert not torch.equal(emb[0], emb[1])               # per agent
    np.testing.assert_array_equal(got["positions"].numpy(),
                                  np.asarray(want["positions"]))


def test_audio_delay_pattern():
    """MusicGen's delay pattern: codebook c is its own stream shifted
    right by c frames behind token 0, and its labels are −100 where t <
    c and the tokens elsewhere (the reference's layout)."""
    cfg = get_arch_config("musicgen-medium").reduced()
    shape = ShapeConfig("t", 20, 2, "train")
    b = syn.make_agent_batch(cfg, shape, syn.StreamSpec(seed=9), 1, 3, "cpu")
    t, lab = b["tokens"], b["labels"]
    assert t.shape == (2, cfg.n_codebooks, 20)
    for c in range(cfg.n_codebooks):
        assert bool((t[:, c, :c] == 0).all())
        assert bool((lab[:, c, :c] == -100).all())
        assert torch.equal(lab[:, c, c:], t[:, c, c:])
        frames = syn._tokens(syn.StreamSpec(seed=9), cfg.vocab_size, 1, 3,
                             2, 20, c)
        assert torch.equal(t[:, c, c:], frames[:, :20 - c])
    assert not torch.equal(t[:, 0, 3:], t[:, 1, 4:])    # own stream each
    assert b["cond"].shape == (2, cfg.cond_len, cfg.d_model)


def test_vlm_batch_labels_and_positions():
    """The VLM batch: S − vision_prefix text tokens, labels over the
    whole sequence with −100 on the prefix and the text after it, and
    positions 0..S−1 on all three M-RoPE rows."""
    cfg = get_arch_config("qwen2-vl-72b").reduced()
    vp, S = cfg.vision_prefix, 20
    b = syn.make_agent_batch(cfg, ShapeConfig("t", S, 2, "train"),
                             syn.StreamSpec(seed=9), 0, 0, "cpu")
    assert b["tokens"].shape == (2, S - vp)
    assert b["vision"].shape == (2, vp, cfg.d_model)
    assert bool((b["labels"][:, :vp] == -100).all())
    assert torch.equal(b["labels"][:, vp:], b["tokens"])
    assert b["positions"].shape == (2, 3, S)
    assert bool((b["positions"] == torch.arange(S, dtype=torch.int32)).all())


def _grads_against_reference(arch, seq, tol, **cfg_kw):
    rcfg = ref_arch(arch).reduced()
    pcfg = get_arch_config(arch).reduced()
    if cfg_kw:
        rcfg = dataclasses.replace(rcfg, **cfg_kw)
        pcfg = dataclasses.replace(pcfg, **cfg_kw)
    model = ref_model(rcfg)
    params = model.init(rcfg, jax.random.PRNGKey(3))
    batch = ref_syn.make_agent_batch(rcfg, RefShape("t", seq, 2, "train"),
                                     RefStream(seed=1), 0, 0)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(rcfg, p, batch)))(params)
    convert = (interop.ssm_params if rcfg.family == "ssm"
               else interop.transformer_params)
    pp = convert(jax.tree.map(np.asarray, params))
    leaves = [x.requires_grad_(True) for _, x in tree_leaves_with_paths(pp)]
    pb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    got = get_model(pcfg).loss(pcfg, pp, pb)
    gg = torch.autograd.grad(got, leaves)
    rtol_loss, rel = tol
    np.testing.assert_allclose(float(got.detach()), float(loss),
                               rtol=rtol_loss)
    for g, w in zip(gg, jax.tree.leaves(grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max() + 1e-12)


FP32 = (1e-5, 1e-4)


def test_ssm_loss_gradient_matches_jax_grad():
    _grads_against_reference("mamba2-780m", 40, FP32)


@pytest.mark.parametrize("kw,tol", [
    (dict(), FP32),
    (dict(sliding_window=8), FP32),
    (dict(attention_scores_dtype="bfloat16"), (2e-3, 2e-2)),
], ids=["full", "window", "bf16_scores"])
def test_transformer_loss_gradient_matches_jax_grad(kw, tol):
    _grads_against_reference("llama3.2-3b", 24, tol, **kw)


def test_full_chunk_ssd_gradient_is_finite_where_the_reference_nans():
    from repro.models.ssd import ssd_chunked as ref_ssd
    from repro_torch.models.ssd import ssd_chunked
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 256, 2, 4, 8
    arrays = [rng.normal(size=(b, s, h, p)), np.full((b, s, h), 0.5),
              np.array([-1.0, -16.0]), rng.normal(size=(b, s, 1, n)),
              rng.normal(size=(b, s, 1, n))]
    x, dt, A, B, C = (np.asarray(a, np.float32) for a in arrays)

    def ref_sum(d):
        return ref_ssd(jnp.asarray(x), d, jnp.asarray(A), jnp.asarray(B),
                       jnp.asarray(C), 256)[0].sum()
    want = float(ref_sum(jnp.asarray(dt)))
    assert not bool(jnp.isfinite(jax.grad(ref_sum)(jnp.asarray(dt))).all())
    d = torch.from_numpy(dt).requires_grad_(True)
    y = ssd_chunked(torch.from_numpy(x), d, torch.from_numpy(A),
                    torch.from_numpy(B), torch.from_numpy(C), 256)[0].sum()
    (g,) = torch.autograd.grad(y, d)
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(float(y.detach()), want, rtol=1e-5)


def _count(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_route_rule_recorded_pass_skips_kernels(arch, monkeypatch):
    """The name is older than the rule: a recorded pass now runs the
    kernel wrappers' forwards, with the plain versions' gradients."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    cfg = get_arch_config(arch).reduced()
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = syn.make_agent_batch(cfg, ShapeConfig("t", 40, 2, "train"),
                                 syn.StreamSpec(), 0, 0, "cpu")
    leaves = [x.requires_grad_(True) for _, x in
              tree_leaves_with_paths(params)]
    with monkeypatch.context() as plain:
        plain.setattr(fa_ops, "flash_attention_with_vjp",
                      lambda q, k, v, **kw: fa_ref.attention(q, k, v, **kw))
        plain.setattr(ssd_ops, "ssd_intra_chunk_with_vjp",
                      ssd_ref.ssd_intra_chunk)
        want_loss = model.loss(cfg, params, batch)
        want = torch.autograd.grad(want_loss, leaves)
    flash = _count(monkeypatch, fa_ops, "flash_attention")
    ssd = _count(monkeypatch, ssd_ops, "ssd_intra_chunk")
    kernel = flash if cfg.family == "dense" else ssd
    loss = model.loss(cfg, params, batch)
    got = torch.autograd.grad(loss, leaves)
    assert len(flash) + len(ssd) == len(kernel) == cfg.n_layers
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        model.loss(cfg, params, batch)
    assert len(kernel) == 2 * cfg.n_layers       # no grad: the kernel too
    field, impl = (("attention_impl", "pallas") if cfg.family == "dense"
                   else ("ssd_impl", "pallas_interpret"))
    pallas = dataclasses.replace(cfg, **{field: impl})
    with pytest.raises(NotPortedError, match=field):
        model.loss(pallas, params, batch)
    with torch.no_grad():
        assert torch.isfinite(model.loss(pallas, params, batch))
