"""Port parity: continuous batching (``repro_torch.serving.continuous``)
and its slot plumbing (``repro_torch.serving.api.cache_batch_dims`` /
``splice_cache``) against ``repro.serving.continuous`` and
``repro.serving.api``, at llama3.2-3b and mamba2-780m ``reduced()``
(2 layers, fp32), both sides on the reference's weights
(``repro_torch.interop.transformer_params`` / ``ssm_params``), the same
requests and greedy sampling.

Greedy tokens are held exactly; batch dims and splices bitwise. The
reference's stop-criteria cases (eos mid-stream, ``max_new_tokens``
1, a prompt that fills the cache, an empty stream, more requests than
slots) run on llama, as the reference's run on granite, which is not
ported.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as r_serving  # noqa: E402
from repro.configs import get_arch_config as r_get_arch_config  # noqa: E402
from repro.models import get_model as r_get_model  # noqa: E402
from repro.serving import api as r_api  # noqa: E402
from repro_torch import interop, serving  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import api, continuous  # noqa: E402

ARCHS = ["llama3.2-3b", "mamba2-780m"]
PAD = 8


def _setup(arch):
    rcfg = r_get_arch_config(arch).reduced()
    cfg = get_arch_config(arch).reduced()
    ref = jax.tree.map(np.asarray,
                       r_get_model(rcfg).init(rcfg, jax.random.PRNGKey(0)))
    to_port = (interop.ssm_params if cfg.family == "ssm"
               else interop.transformer_params)
    return rcfg, cfg, ref, to_port(ref)


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def llama():
    return _setup("llama3.2-3b")


def _both(setup, requests, batch_size=2, prompt_pad=PAD, **serve_kw):
    """{rid: tokens} of the reference's and the port's batcher."""
    rcfg, cfg, ref, port = setup
    r = r_serving.ContinuousBatcher(
        rcfg, jax.tree.map(jnp.asarray, ref),
        r_serving.ServeConfig(**serve_kw), batch_size=batch_size,
        prompt_pad=prompt_pad).run(requests)
    p = serving.ContinuousBatcher(
        cfg, port, serving.ServeConfig(**serve_kw), batch_size=batch_size,
        prompt_pad=prompt_pad).run(requests)
    return {k: [int(t) for t in v] for k, v in r.items()}, p


def test_continuous_matches_reference_greedy(arch_setup):
    """Three requests through two slots: every request's tokens equal
    the reference batcher's and the port's fixed-batch engine's on the
    prompt alone, padded to the same width."""
    _, cfg, _, params = arch_setup
    reqs = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    want, got = _both(arch_setup, reqs, max_len=64, max_new_tokens=5)
    assert got == want and set(got) == {0, 1, 2}
    eng = serving.ServeEngine(cfg, params,
                              serving.ServeConfig(max_len=64,
                                                  max_new_tokens=5))
    for rid, req in enumerate(reqs):
        toks = torch.zeros((1, PAD), dtype=torch.int32)
        toks[0, :len(req)] = torch.tensor(req, dtype=torch.int32)
        assert eng.generate(toks, [len(req)])[0].tolist() == got[rid]


def test_more_requests_than_slots(llama):
    want, got = _both(llama, [[i + 1] for i in range(7)], max_len=32,
                      max_new_tokens=3)
    assert got == want
    assert set(got) == set(range(7)) and all(len(v) == 3
                                             for v in got.values())


def test_eos_stops_mid_stream(llama):
    """The request finishes at the first eos token (inclusive), eos
    picked mid-way through the eos-free greedy run, on both sides."""
    prompt = [3, 1, 4, 1, 5]
    _, ref = _both(llama, [prompt], max_len=64, max_new_tokens=8)
    assert len(ref[0]) == 8
    eos = ref[0][3]
    want, got = _both(llama, [prompt], max_len=64, max_new_tokens=8,
                      eos_id=eos)
    assert got == want
    assert got[0] == ref[0][:ref[0].index(eos) + 1]


def test_max_new_tokens_one(llama):
    want, got = _both(llama, [[7, 8, 9]], max_len=64, max_new_tokens=1)
    assert got == want and len(got[0]) == 1


def test_prompt_fills_cache(llama):
    """A prompt of n tokens in a max_len cache yields max_len - n tokens;
    one at max_len - 1 yields only the prefill token."""
    long_prompt = [(i % 50) + 1 for i in range(28)]
    brim_prompt = [(i % 50) + 1 for i in range(31)]
    want, got = _both(llama, [long_prompt, brim_prompt], max_len=32,
                      max_new_tokens=10)
    assert got == want
    assert len(got[0]) == 32 - 28 and len(got[1]) == 1


def test_empty_request_stream(llama):
    want, got = _both(llama, [], max_len=32, max_new_tokens=2)
    assert got == want == {}


def test_padding_past_the_cache_is_cut(llama):
    """A 33-token prompt pads to 64 at prompt_pad 8, past a 40-slot
    cache: the reference drops those pad writes, the port prefills at
    the cache's width instead; the tokens are the same."""
    _, cfg, _, _ = llama
    assert continuous.prefill_width(cfg, PAD, 33, 40) == 40
    assert continuous.pad_prompt(PAD, 33) == 64
    assert continuous.prefill_width(
        get_arch_config("mamba2-780m").reduced(), PAD, 33, 40) == 64
    prompt = [(i * 7) % 500 + 1 for i in range(33)]
    want, got = _both(llama, [prompt, [5, 6]], max_len=40, max_new_tokens=5)
    assert got == want


def test_finished_slot_keeps_its_position(llama):
    """A slot that finished early keeps its position while the other
    slot decodes on (28 more steps than a 40-slot cache leaves it): its
    idle decode never writes past the cache, and both requests match
    the reference's."""
    want, got = _both(llama, [[(i % 50) + 1 for i in range(36)], [9]],
                      max_len=40, max_new_tokens=32)
    assert got == want
    assert len(got[0]) == 40 - 36 and len(got[1]) == 32


def test_a_prompt_longer_than_the_cache_raises(llama):
    """The reference fills a cache that is too short silently; the port
    refuses at the prefill, naming max_len (ROADMAP.md §3)."""
    _, cfg, _, params = llama
    batcher = serving.ContinuousBatcher(
        cfg, params, serving.ServeConfig(max_len=32, max_new_tokens=2),
        batch_size=2, prompt_pad=PAD)
    with pytest.raises(ValueError, match="max_len=32"):
        batcher.run([list(range(1, 41))])


def test_cache_batch_dims_equal_the_reference(arch_setup):
    rcfg, cfg, _, _ = arch_setup
    want = r_api.cache_batch_dims(rcfg, 64)
    got = api.cache_batch_dims(cfg, 64)
    assert got == jax.tree.map(int, want)
    assert set(jax.tree.leaves(want)) == {1}


def test_splice_cache_is_bitwise_the_reference(arch_setup):
    """One B = 1 cache written into slot 1 of a 3-slot cache: every leaf
    bitwise the reference's ``splice_cache``; the port writes into the
    batch cache's own tensors and leaves the B = 1 cache as it was."""
    rcfg, cfg, _, _ = arch_setup
    rng = np.random.default_rng(0)

    def draw(B):
        shapes = jax.eval_shape(
            lambda: r_get_model(rcfg).make_cache(rcfg, B, 16))
        return jax.tree.map(
            lambda s: (rng.integers(-1, 16, s.shape).astype(s.dtype)
                       if np.issubdtype(s.dtype, np.integer)
                       else rng.standard_normal(s.shape).astype(s.dtype)),
            shapes)

    batch, one = draw(3), draw(1)
    want = r_api.splice_cache(jax.tree.map(jnp.asarray, batch),
                              jax.tree.map(jnp.asarray, one),
                              r_api.cache_batch_dims(rcfg, 16), 1)
    tb = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), batch)
    to = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), one)
    got = api.splice_cache(tb, to, api.cache_batch_dims(cfg, 16), 1)
    for g, w, t, o, src in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                               jax.tree.leaves(tb), jax.tree.leaves(to),
                               jax.tree.leaves(one)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g is t                               # in place
        np.testing.assert_array_equal(o.numpy(), src)


def test_launcher_serves_continuous(llama):
    """``engine=continuous`` on the host: the launcher's tokens are the
    batcher's on the launcher's draw and seed-0 weights."""
    report = launch.main(["--device", "cpu", "--requests", "3",
                          "--prompt-len", "9", "--serve", "engine=continuous",
                          "--serve", "max_new_tokens=3"])
    cfg = get_arch_config("llama3.2-3b").reduced()
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    want = serving.ContinuousBatcher(
        cfg, params, serving.ServeConfig(max_len=128, max_new_tokens=3),
        batch_size=2, prompt_pad=16).run(report["prompts"])
    assert report["outputs"] == [want[i] for i in range(3)]
    assert report["tokens"] == 9


@pytest.mark.parametrize("arch", ARCHS)
def test_examples_run_on_the_host(arch):
    """The twins of examples/continuous_serving.py and serve_batch.py:
    every request answered with its token budget."""
    from repro_torch.examples import continuous_serving, serve_batch
    out = continuous_serving.main(["--arch", arch, "--device", "cpu",
                                   "--requests", "5", "--new-tokens", "3"])
    assert sorted(out) == list(range(5))
    assert all(len(v) == 3 for v in out.values())
    batches = serve_batch.main(["--arch", arch, "--device", "cpu",
                                "--new-tokens", "4"])
    assert [tuple(b.shape) for b in batches] == [(2, 4)] * 3
