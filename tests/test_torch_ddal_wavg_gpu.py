"""The eq. 4 share-step CUDA kernels against their plain versions, on
the card. Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_ddal_wavg_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.ddal_wavg import ops, ref  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(n, m, p, dev, all_invalid_row=False):
    rng = np.random.default_rng(n * 7 + m)
    G = torch.from_numpy(rng.normal(size=(n, m, p)).astype(np.float32))
    T = torch.from_numpy((np.abs(rng.normal(size=(n, m))) + 0.1)
                         .astype(np.float32))
    R = torch.from_numpy((np.abs(rng.normal(size=(n, m))) + 0.1)
                         .astype(np.float32))
    valid = torch.from_numpy(rng.random((n, m)) > 0.2)
    if all_invalid_row:
        valid[-1] = False
    return [x.to(dev) for x in (G, T, R, valid)]


# (n, m, P, a row of only invalid pieces): the main paths' shapes (DDA3C
# P = 9155, DDADQN on CartPole P = 8835 and on GridWorld(5) P = 10309), the
# big ragged plane, the edges of the kernel's batches (m = 1, 5, 33 and
# MAX_PIECES), one agent, and one case per kernel instance (batch,
# positions per thread): (32, 1), (16, 1), (16, 2), (8, 1), (8, 4)
FP32_CASES = [
    (2, 32, 9155, False), (16, 8, 2 ** 20 + 37, False), (1, 1, 1, False),
    (3, 5, 1000, True), (8, 32, 9155, True), (8, 1, 9155, False),
    (8, 5, 9155, False), (8, 33, 9155, True), (1, ops.MAX_PIECES, 1000, True),
    (1, 32, 9155, False), (2, 12, 9155, False), (8, 12, 9155, True),
    (4, 12, 2 ** 20 + 37, False), (2, 32, 8835, False), (8, 32, 8835, True),
    (3, 32, 10309, True)]
FP32_INSTANCES = {(32, 1), (16, 1), (16, 2), (8, 1), (8, 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,p,invalid_row", FP32_CASES)
def test_cuda_kernels_match_plain(n, m, p, invalid_row):
    """ḡ and Σw of both fp32 kernels bitwise equal to the plain versions,
    which repeat the kernels' fp32 ops in order; and, beside that, within
    the bounds the Pallas kernel is held to (ḡ rtol = atol = 2e-5, Σw
    rtol 1e-6)."""
    dev = _card()
    G, T, R, valid = _case(n, m, p, dev, all_invalid_row=invalid_row)
    launches = ops.fused_wavg.launches
    got_g, got_w = ops.fused_wavg(G, T, R, valid)
    assert ops.fused_wavg.launches == launches + 1
    want_g, want_w = ref.fused_wavg(G, T, R, valid)
    assert torch.equal(got_g, want_g) and torch.equal(got_w, want_w)
    torch.testing.assert_close(got_g, want_g, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_w, want_w, rtol=1e-6, atol=0.0)
    w = ref.eq4_weights(T, R, valid)
    launches = ops.wavg.launches
    got_u, want_u = ops.wavg(G, w), ref.wavg(G, w)
    assert ops.wavg.launches == launches + 1
    assert torch.equal(got_u, want_u)
    torch.testing.assert_close(got_u, want_u, rtol=2e-5, atol=2e-5)
    if invalid_row:
        assert float(got_w[-1]) == 0.0 and not bool(got_g[-1].any())


def test_fp32_cases_run_every_kernel_instance():
    """The cases above launch each fp32 instance at least once."""
    ran = set()
    for n, m, p, _ in FP32_CASES:
        geo = ops.wavg_geometry(n, m, p)
        ran.add((geo.batch, geo.items))
    assert ran == FP32_INSTANCES


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_cannot_take():
    dev = _card()
    G, T, R, valid = _case(2, 4, 100, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_wavg(G.transpose(1, 2).contiguous().transpose(1, 2),
                       T, R, valid)
    with pytest.raises(ValueError, match="valid must be"):
        ops.fused_wavg(G, T, R, valid.to(torch.float32))
    with pytest.raises(TypeError, match="impl"):
        ops.fused_wavg(G, T, R, valid, impl="plain")
