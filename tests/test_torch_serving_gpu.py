"""The serving engines on the card: decode without a synchronizing
call, one device→host copy per group step, and the slot engines on the
card against the same engines on the CPU. Every test here needs a CUDA
card and skips without one.

This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_serving_gpu.py

Tolerances: fp32 compute; the card's logits within rtol = atol = 1e-4
of the CPU's (the port's serving gate), greedy tokens equal.
"""
from __future__ import annotations

import contextlib
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import serving  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

ARCHS = ["llama3.2-3b", "mamba2-780m"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the serving path's sync checks and "
                    "its kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def sync_debug(mode):
    """``torch.cuda.set_sync_debug_mode(mode)`` inside, off after; its
    notice that the mode is a prototype is not a failure here (the
    suite turns warnings into errors)."""
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="Synchronization "
                                    "debug mode is a prototype")
            torch.cuda.set_sync_debug_mode(mode)
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _setup(arch, device):
    cfg = get_arch_config(arch).reduced()
    return cfg, get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                    "cpu"), device


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_makes_no_synchronizing_call(arch):
    """``ServeEngine.decode`` with the prompt lengths from the host runs
    under ``set_sync_debug_mode("error")``: any synchronizing call would
    raise. The mode bites: a read-back under it raises."""
    dev = _card()
    cfg, params, _ = _setup(arch, dev)
    eng = serving.ServeEngine(cfg, tree_map(lambda t: t.to(dev), params),
                              serving.ServeConfig(max_len=64,
                                                  max_new_tokens=8))
    toks, lens = serving.serve_batches([[5, 9, 200, 31], [11, 400]], 2,
                                       device="cpu")[0]
    logits, cache = eng.prefill(toks.to(dev), lens)
    torch.cuda.synchronize()
    with sync_debug("error"):
        with pytest.raises(RuntimeError, match="synchronizing"):
            logits[0, 0].item()
        out = eng.decode(logits, cache, lens)
    assert out.shape == (2, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_group_step_makes_one_copy(arch):
    """One group step with every slot live and nothing queued makes one
    synchronizing call: its device→host copy of the sampled tokens."""
    dev = _card()
    cfg, params, _ = _setup(arch, dev)
    planes = tree_map(lambda t: torch.stack([t, t * 0.5]).to(dev), params)
    eng = serving.GroupServeEngine(
        cfg, planes, serving.ServeConfig(max_len=64, max_new_tokens=8),
        batch_size=2, prompt_pad=8)
    for rid in range(2):
        eng.submit(serving.GroupRequest(rid, rid, [3 + rid, 7, 11]))
    eng.step()
    torch.cuda.synchronize()
    with sync_debug("warn"), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.step()
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1
    assert eng.live == 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_slot_engines_on_the_card_match_the_cpu(arch):
    """The ContinuousBatcher and a two-agent GroupServeEngine, five
    requests through two slots: greedy tokens equal on the card and on
    the CPU (mamba2-780m's prefills run the SSD kernel on the card)."""
    dev = _card()
    cfg, params, _ = _setup(arch, dev)
    planes = tree_map(lambda t: torch.stack([t, t * 0.5]), params)
    prompts = [[5, 9, 200, 31, 7] * 8, [11, 400, 3], [1, 2], [260] * 12,
               [8, 8, 8]]
    serve = serving.ServeConfig(max_len=64, max_new_tokens=6)
    out = {}
    for device in ("cpu", dev):
        cb = serving.ContinuousBatcher(
            cfg, tree_map(lambda t: t.to(device), params), serve,
            batch_size=2, prompt_pad=8)
        ge = serving.GroupServeEngine(
            cfg, tree_map(lambda t: t.to(device), planes), serve,
            batch_size=2, prompt_pad=8)
        out[str(device)] = (cb.run(prompts), ge.run(
            [serving.GroupRequest(i, i % 2, p) for i, p in
             enumerate(prompts)]))
    assert out["cpu"] == out[str(dev)]
