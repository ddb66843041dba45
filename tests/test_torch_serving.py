"""Port parity: the fixed-batch serving path (``repro_torch.serving``,
``repro_torch.launch.serve``) against ``repro.serving`` and
``repro.launch.serve`` at mamba2-780m ``reduced()`` (fp32), both
engines on the reference's weights (``repro_torch.interop.ssm_params``).

Prompts of unequal length are right-padded into one batch, so the
shorter rows' prefill states absorb pad tokens, as the reference's do
(``repro.serving.api.prefill``); the port reproduces that. Prefill
logits and states are held at rtol = atol = 2e-4 (the model's own
parity tolerance, ``tests/test_torch_mamba2.py``), greedy tokens
exactly."""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as r_serving  # noqa: E402
from repro.configs import get_arch_config as r_get_arch_config  # noqa: E402
from repro.launch import serve as r_launch  # noqa: E402
from repro.models import ssm_model as r_ssm  # noqa: E402
from repro.serving import api as r_api  # noqa: E402
from repro_torch import interop, serving  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serving import api  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "mamba2-780m"
PROMPTS = [[5, 9, 200, 31, 7, 7, 301, 2, 88, 45, 12, 500, 6, 3, 71, 19,
            64, 2, 9, 11, 430, 17, 8, 250, 99, 1, 3, 60, 7, 310, 4, 44,
            18, 27, 201, 9, 36, 77],             # 38: spans two chunks
           [11, 400, 3],                          # 3: absorbs 35 pads
           [1, 2, 3, 4, 5, 6, 7],
           [260]]


@pytest.fixture(scope="module")
def setup():
    rcfg = r_get_arch_config(ARCH).reduced()
    cfg = get_arch_config(ARCH).reduced()
    ref_params = jax.tree.map(np.asarray, r_ssm.init_ssm_model(
        rcfg, jax.random.PRNGKey(0)))
    return rcfg, cfg, ref_params, interop.ssm_params(ref_params)


def _engines(setup, **serve_kw):
    rcfg, cfg, ref_params, params = setup
    ref = r_serving.ServeEngine(rcfg, jax.tree.map(jnp.asarray, ref_params),
                                r_serving.ServeConfig(**serve_kw))
    port = serving.ServeEngine(cfg, params, serving.ServeConfig(**serve_kw))
    return ref, port


def _batches():
    ref = r_serving.serve_batches(PROMPTS, 2)
    port = serving.serve_batches(PROMPTS, 2, device="cpu")
    return ref, port


def test_serve_batches_equal_the_reference():
    ref, port = _batches()
    assert len(ref) == len(port) == 2
    for (rt, rl), (pt, pl) in zip(ref, port):
        assert pt.dtype == torch.int32 and pl.dtype == torch.int32
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    tail = serving.serve_batches(PROMPTS[:3], 2, device="cpu")[1]
    np.testing.assert_array_equal(tail[1].numpy(), [7, 1])   # [pad_id] row


def test_engine_matches_reference_greedy(setup):
    """Prefill logits and states of each right-padded batch within TOL,
    the 6 greedy tokens of every request exactly."""
    ref_eng, port_eng = _engines(setup, max_len=64, max_new_tokens=6)
    for (rt, rl), (pt, pl) in zip(*_batches()):
        want_logits, want_cache = ref_eng._prefill(ref_eng.params, rt, rl)
        got_logits, got_cache = port_eng.prefill(pt, pl)
        np.testing.assert_allclose(got_logits.numpy(),
                                   np.asarray(want_logits), **TOL)
        for k in interop.SSM_STATE_KEYS:
            np.testing.assert_allclose(got_cache[k].numpy(),
                                       np.asarray(want_cache[k]), **TOL)
        want = np.asarray(ref_eng.generate(rt, rl, jax.random.PRNGKey(0)))
        got = port_eng.generate(pt, pl)
        assert got.dtype == torch.int32 and got.shape == (2, 6)
        np.testing.assert_array_equal(got.numpy(), want)


def test_engine_matches_reference_greedy_in_bf16(setup):
    """The serving path at the default compute dtype (bf16) on the same
    right-padded batches: prefill logits bf16 on both sides and within
    2**-5 * max|want| (``tests/test_torch_mamba2.py::_close_bf16``; the
    two differ by up to 3.0 bf16 units at this scale), the 8 greedy
    tokens of every request exactly."""
    rcfg, cfg, ref_params, params = setup
    rcfg = rcfg.with_(compute_dtype="bfloat16")
    cfg = cfg.with_(compute_dtype="bfloat16")
    ref_eng = r_serving.ServeEngine(
        rcfg, jax.tree.map(jnp.asarray, ref_params),
        r_serving.ServeConfig(max_len=64, max_new_tokens=8))
    port_eng = serving.ServeEngine(
        cfg, params, serving.ServeConfig(max_len=64, max_new_tokens=8))
    for (rt, rl), (pt, pl) in zip(*_batches()):
        want_logits, _ = ref_eng._prefill(ref_eng.params, rt, rl)
        got_logits, _ = port_eng.prefill(pt, pl)
        assert got_logits.dtype == torch.bfloat16
        assert want_logits.dtype == jnp.bfloat16
        w = np.asarray(want_logits, np.float32)
        np.testing.assert_array_less(
            np.abs(got_logits.float().numpy() - w),
            2.0 ** -5 * np.abs(w).max())
        want = np.asarray(ref_eng.generate(rt, rl, jax.random.PRNGKey(0)))
        np.testing.assert_array_equal(port_eng.generate(pt, pl).numpy(),
                                      want)


def test_right_padding_pollutes_the_short_rows_state_as_in_reference(setup):
    """The 3-token prompt batched beside the 38-token one decodes from a
    state that has absorbed 35 pad tokens: its first logits are the
    same as alone (they come from its last real token), its state and
    next tokens are not — on both sides alike."""
    _, port_eng = _engines(setup, max_len=64, max_new_tokens=4)
    (pt, pl) = serving.serve_batches(PROMPTS, 2, device="cpu")[0]
    alone_t, alone_l = serving.serve_batches([PROMPTS[1]], 1,
                                             device="cpu")[0]
    padded_logits, padded_cache = port_eng.prefill(pt, pl)
    alone_logits, alone_cache = port_eng.prefill(alone_t, alone_l)
    np.testing.assert_allclose(padded_logits[1].numpy(),
                               alone_logits[0].numpy(), **TOL)
    assert not torch.allclose(padded_cache["ssm"][:, 1],
                              alone_cache["ssm"][:, 0], **TOL)


def test_eos_marks_a_slot_done_as_in_reference(setup):
    """With eos_id set to a token a slot emits, the slot repeats it from
    then on; the reference does the same."""
    ref_eng, port_eng = _engines(setup, max_len=64, max_new_tokens=6)
    (rt, rl), (pt, pl) = [b[0] for b in _batches()]
    free = port_eng.generate(pt, pl).numpy()
    eos = int(free[0, 2])
    ref_eng, port_eng = _engines(setup, max_len=64, max_new_tokens=6,
                                 eos_id=eos)
    want = np.asarray(ref_eng.generate(rt, rl, jax.random.PRNGKey(0)))
    got = port_eng.generate(pt, pl).numpy()
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0] == eos))
    assert (got[0, first:] == eos).all()


def test_sampler():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, -1.0, 0.5]])
    assert api.Sampler()(logits).tolist() == [1, 0]
    assert api.Sampler()(logits).dtype == torch.int32
    gen = torch.Generator().manual_seed(0)
    hot = api.Sampler(temperature=1e-3)(logits, gen)
    assert hot.tolist() == [1, 0] and hot.dtype == torch.int32
    draws = torch.stack([api.Sampler(temperature=1.0)(logits, gen)
                         for _ in range(2000)])
    freq = (draws[:, 0] == 1).float().mean()
    want = float(torch.softmax(logits[0], 0)[1])
    assert abs(float(freq) - want) < 0.04
    with pytest.raises(ValueError, match="generator"):
        api.Sampler(temperature=0.5)(logits)


def test_stop_criteria_equal_the_reference():
    for serve_kw in ({}, {"eos_id": 7, "max_new_tokens": 3, "max_len": 10}):
        want = r_api.StopCriteria.from_serve(r_api.ServeConfig(**serve_kw))
        got = api.StopCriteria.from_serve(api.ServeConfig(**serve_kw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for n_gen in (1, 3, 64):
            for tok in (0, 7):
                for pos in (5, 9, 511):
                    assert got.should_stop(n_gen, tok, pos) == \
                        want.should_stop(n_gen, tok, pos)
        toks = np.array([7, 0, -1], np.int32)
        np.testing.assert_array_equal(
            got.eos_done(torch.from_numpy(toks)).numpy(),
            np.asarray(want.eos_done(jnp.asarray(toks))))


def test_serve_config_and_cli_options_equal_the_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(api.ServeConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(
            r_api.ServeConfig)]
    assert api.ENGINE_OPTIONS == r_api.ENGINE_OPTIONS
    assert serving.cli_options() == r_serving.cli_options()


def _prompt_lines(text):
    return re.findall(r"prompt=(\[[^\]]*\])", text, flags=re.S)


def test_launcher_prompt_draw_equals_the_reference(capsys):
    """One seed, the same prompts: the reference launcher's printed
    prompts, the port launcher's, and ``draw_prompts``."""
    argv = ["--arch", ARCH, "--requests", "3", "--prompt-len", "9",
            "--seed", "4", "--serve", "max_new_tokens=2"]
    r_launch.main(argv)
    ref_out = capsys.readouterr().out
    report = launch.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert _prompt_lines(port_out) == _prompt_lines(ref_out)
    assert len(_prompt_lines(ref_out)) == 4          # 3 + one tail pad
    drawn = launch.draw_prompts(512, 3, 9, 4)
    assert [list(map(int, p)) for p in report["prompts"]] == \
        [list(map(int, p)) for p in drawn]
    rng = np.random.default_rng(4)
    for p in drawn:
        assert p == list(rng.integers(0, 512, rng.integers(2, 9)))
    assert report["prefill_calls"] == 2 and report["tokens"] == 8
    assert all(o.shape == (2, 2) for o in report["outputs"])
    assert all(bool(torch.isfinite(lg).all())
               for lg in report["first_logits"])


@pytest.mark.parametrize("engine", ["continuous", "group"])
def test_launcher_refuses_unported_engines(engine):
    """Both engines are ported now: the launcher serves them (every
    request answered), and refuses only an engine it does not know."""
    report = launch.main(["--device", "cpu", "--arch", ARCH, "--requests",
                          "3", "--serve", f"engine={engine}", "--serve",
                          "max_new_tokens=2"])
    assert [len(o) for o in report["outputs"]] == [2, 2, 2]
    with pytest.raises(ValueError, match="engine='nope'"):
        launch.main(["--device", "cpu", "--serve", "engine=nope"])


def test_launcher_refuses_unknown_serve_options(capsys):
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu", "--serve", "nope=1"])
    assert "unknown serve option 'nope'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu", "--serve", "slots=two"])
    assert "wants a int" in capsys.readouterr().err
