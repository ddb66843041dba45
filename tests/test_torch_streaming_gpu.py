"""The streaming trainer's kernels on the card: ``sketch_pytree`` (one
``grad_sketch`` launch per leaf) against its plain version leaf by leaf,
and the route rule of a recorded pass — a loss that autograd records
launches the flash or SSD kernel once per layer, as the same pass under
``torch.no_grad()`` does, and its gradients (the plain versions' VJPs,
``kernels.plain_vjp``) agree with those of the loss differentiated
through the plain versions. Every test here needs a CUDA card and skips
without one.

This file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_streaming_gpu.py
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import make_agent_batch, StreamSpec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.grad_sketch import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 256])
def test_sketch_pytree_matches_plain_per_leaf(d):
    """Leaves of odd sizes in sorted-key order: the whole tree's sketch
    equals the sum of each leaf's plain sketch at its running offset
    within 1e-5·Σ|g| per row, one launch per leaf; one-hot rows give the
    sign rows bitwise."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d)
    shapes = {"w": (3, 7, 1001), "a": (3, 5), "m": {"z": (3, 65537),
                                                   "b": (3, 2, 3)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return torch.randn(s, generator=g, device=dev)
    tree = draw(shapes)
    seed = 12345
    before = ops.sketch_flat.launches
    got = ops.sketch_pytree(tree, seed, d)
    leaves = [x for _, x in tree_leaves_with_paths(tree)]
    assert ops.sketch_flat.launches == before + len(leaves)
    want = torch.zeros_like(got)
    offset, l1 = 0, torch.zeros(3, device=dev)
    for x in leaves:
        G = x.reshape(3, -1)
        want = want + ref.sketch_flat(G, seed, d, offset)
        offset += G.shape[1]
        l1 = l1 + G.abs().sum(1)
    assert bool(((got - want).abs() <= 1e-5 * l1[:, None]).all())
    hot = {k: torch.zeros_like(v) if not isinstance(v, dict) else
           {kk: torch.zeros_like(vv) for kk, vv in v.items()}
           for k, v in tree.items()}
    hot["w"][0, -1, -1] = 1.0       # the last position of the last leaf
    pos = offset - 1
    np_sign = ref.sign_block(seed, pos, 1, d, dev)[0]
    assert torch.equal(ops.sketch_pytree(hot, seed, d)[0], np_sign)


def _counts():
    return fa_ops.flash_attention.launches, ssd_ops.ssd_intra_chunk.launches


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_recorded_pass_launches_no_kernel(arch, monkeypatch):
    """The name is older than the rule: a recorded pass now launches
    the kernels. fp32 compute (reduced()), TF32 off: the loss within
    1e-4 of the no-grad pass's, each gradient leaf within 1e-4 of its
    largest entry of the plain route's."""
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    dev = _card()
    cfg = get_arch_config(arch).reduced()
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = make_agent_batch(cfg, ShapeConfig("t", 64, 2, "train"),
                             StreamSpec(), 0, 0, dev)
    leaves = [x.requires_grad_(True) for _, x in
              tree_leaves_with_paths(params)]
    with monkeypatch.context() as plain:
        plain.setattr(fa_ops, "flash_attention_with_vjp",
                      lambda q, k, v, **kw: fa_ref.attention(q, k, v, **kw))
        plain.setattr(ssd_ops, "ssd_intra_chunk_with_vjp",
                      ssd_ref.ssd_intra_chunk)
        want = torch.autograd.grad(model.loss(cfg, params, batch), leaves)
    before = _counts()
    loss = model.loss(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    flash, ssd = (a - b for a, b in zip(_counts(), before))
    if cfg.family == "dense":
        assert (flash, ssd) == (cfg.n_layers, 0)
    else:
        assert (flash, ssd) == (0, cfg.n_layers)
    assert bool(torch.isfinite(loss))
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + 1e-12)
    with torch.no_grad():
        again = model.loss(cfg, params, batch)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (
        (2 * cfg.n_layers, 0) if cfg.family == "dense"
        else (0, 2 * cfg.n_layers))
    torch.testing.assert_close(again, loss.detach(), rtol=1e-4, atol=1e-4)
