"""Decode reads nothing back from the device (ROADMAP §3's fault, now
repaired): ``ServeEngine.decode`` and the group engine's batched decode
run with every tensor→host conversion patched to raise, at llama3.2-3b
and mamba2-780m ``reduced()``; the KV cache's fit is checked before
the first step from the host lengths, and the ``ValueError`` naming
``max_len`` is still raised where the fit fails. On the card the same
holds under ``torch.cuda.set_sync_debug_mode("error")``
(``tests/test_torch_serving_gpu.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import serving  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

ARCHS = ["llama3.2-3b", "mamba2-780m"]
READS = ("item", "__int__", "__float__", "__bool__", "__index__", "tolist",
         "numpy")


@contextlib.contextmanager
def no_reads():
    """Every way a tensor's value reaches the host raises."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def refuse(name):
        def read(self, *args, **kw):
            raise AssertionError(f"Tensor.{name} read a value back")
        return read

    try:
        for name in READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _setup(arch):
    cfg = get_arch_config(arch).reduced()
    return cfg, get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                    "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_decode_reads_nothing_back(arch):
    cfg, params = _setup(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_group_decode_reads_nothing_back(arch):
    """The batched step of every slot under its own agent's weights:
    one group step's decode with reads patched to raise gives the
    step's logits unpatched."""
    cfg, params = _setup(arch)
    planes = tree_map(lambda t: torch.stack([t, t * 0.5]), params)
    eng = serving.GroupServeEngine(
        cfg, planes, serving.ServeConfig(max_len=32, max_new_tokens=6),
        batch_size=2, prompt_pad=8)
    for rid in range(2):
        eng.submit(serving.GroupRequest(rid, rid, [3 + rid, 7, 11]))
    eng.step()                         # admits both, one decode step
    slots = eng._state
    batch = {"tokens": slots.tokens, "positions": slots.pos_dev[:, None]}
    planes_live, _ = eng.store.acquire()
    want, _ = eng.decode_step(planes_live, batch, slots.cache)
    with no_reads():
        got, _ = eng.decode_step(planes_live, batch, slots.cache)
    assert torch.equal(got, want)


def test_decode_checks_the_fit_before_any_step():
    """max(lengths) + max_new_tokens − 2 past a 16-slot cache: the
    ValueError names max_len before the first decode step runs; one
    token less fits exactly."""
    cfg, params = _setup("llama3.2-3b")
    toks, lens = serving.serve_batches([[1] * 9, [2] * 10], 2,
                                       device="cpu")[0]
    for new_tokens, fits in ((8, False), (7, True)):
        eng = serving.ServeEngine(cfg, params, serving.ServeConfig(
            max_len=16, max_new_tokens=new_tokens))
        logits, cache = eng.prefill(toks, lens)
        calls = []
        model = eng.model
        eng.model = dataclasses.replace(
            model, decode=lambda *a, m=model: calls.append(1) or
            m.decode(*a))
        if fits:                        # writes positions up to 15
            assert eng.decode(logits, cache, [9, 10]).shape == (2, 7)
            assert len(calls) == 6
        else:                           # would write position 16
            with pytest.raises(ValueError, match="max_len=16"):
                eng.decode(logits, cache, [9, 10])
            assert calls == []
    ssm_cfg, ssm_params = _setup("mamba2-780m")   # no KV cache to fill
    ssm = serving.ServeEngine(ssm_cfg, ssm_params, serving.ServeConfig(
        max_len=4, max_new_tokens=8))
    logits, cache = ssm.prefill(toks, lens)
    assert ssm.decode(logits, cache, lens).shape == (2, 8)
