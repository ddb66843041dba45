"""The slice-2 CUDA kernels against their plain versions, on the card:
the gradient sketch (``repro_torch.kernels.grad_sketch``) and the int8
eq. 4 share step (``ddal_wavg.ops.fused_wavg_q``). Every test here
needs a CUDA card and skips without one.

This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_grad_sketch_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.common.pytree import PlaneLayout  # noqa: E402
from repro_torch.kernels.ddal_wavg import ops as wavg_ops  # noqa: E402
from repro_torch.kernels.ddal_wavg import ref as wavg_ref  # noqa: E402
from repro_torch.kernels.grad_sketch import ops, ref  # noqa: E402
from repro_torch.rl import networks  # noqa: E402

A2C_P = 9155


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _a2c_layout():
    tree = networks.init_policy_value(torch.Generator().manual_seed(0), 1,
                                      4, 2, 64)
    layout = PlaneLayout.from_tree(tree, lead=1)
    assert layout.size == A2C_P
    return layout


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,d,offset", [
    (8, A2C_P, 256, 0), (8, 1024, 128, 11), (3, 4097, 256, 11),
    (8, 1000, 128, 11), (16, 2048, 384, 11), (8, A2C_P, 100, 0),
    (2, 70_000, 256, 2 ** 32 - 1000),
    # the row-block instances' edges: 1 row, 9 of 16, 17 over two blocks
    (1, A2C_P, 256, 0), (9, A2C_P, 256, 5), (17, A2C_P, 256, 5),
    # shorter than one chunk; one chunk and one position
    (8, ops.MIN_CHUNK - 12, 256, 3), (8, ops.MIN_CHUNK + 1, 256, 3),
    # DDADQN's rows: the dueling network on CartPole and on GridWorld(5)
    (8, 8835, 256, 0), (4, 10309, 256, 0)])
def test_sketch_kernel_matches_plain(n, p, d, offset):
    """|got − want| ≤ 1e-5·Σ_p |G[r, p]| per element (the two sum in
    other orders; ±1 products are exact); two launches bitwise equal."""
    dev = _card()
    if p <= ops.MIN_CHUNK + 1:
        assert ops.sketch_geometry(n, p, d).chunks == (p > ops.MIN_CHUNK) + 1
    G = torch.from_numpy(np.random.default_rng(n * p).normal(
        size=(n, p)).astype(np.float32)).to(dev)
    launches = ops.sketch_flat.launches
    got = ops.sketch_flat(G, -7, d, offset=offset)
    again = ops.sketch_flat(G, -7, d, offset=offset)
    assert ops.sketch_flat.launches == launches + 2
    want = ref.sketch_flat(G, -7, d, offset=offset)
    gate = 1e-5 * G.abs().sum(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= gate).all())
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_sketch_kernel_signs_bitwise():
    """One-hot rows of G pick exact rows of S out of the kernel."""
    dev = _card()
    p = A2C_P
    pos = [0, 1, 255, 256, 8191, p - 1]
    G = torch.zeros((len(pos), p), device=dev)
    G[torch.arange(len(pos)), torch.tensor(pos)] = 1.0
    for offset in (0, 2 ** 31 - 3, 2 ** 32 - 4000):
        for d in (256, 100, 1):
            got = ops.sketch_flat(G, 12345, d, offset=offset)
            want = torch.cat([ref.sign_block(12345, offset + q, 1, d, dev)
                              for q in pos])
            assert torch.equal(got, want), (offset, d)


def _q_case(dev, n, m, layout, qb, seed, invalid="some"):
    g = torch.Generator(device=dev).manual_seed(seed)
    G = (torch.randn((n, m, layout.size), generator=g, device=dev)
         * torch.exp(torch.randn((n, m, layout.size), generator=g,
                                 device=dev)))
    blocks = layout.blocks(qb)
    Q, S = wavg_ref.quantize_flat(G, blocks)
    T = torch.rand((n, m), generator=g, device=dev) * 100 + 1
    R = torch.rand((n, m), generator=g, device=dev) + 1e-3
    if invalid == "all":
        valid = torch.zeros((n, m), dtype=torch.bool, device=dev)
    else:
        valid = torch.rand((n, m), generator=g, device=dev) > 0.3
    return Q, S, T, R, valid, blocks


# case: (ragged plane instead of the A2C's, n, m, q_block); the cases run
# every kernel instance (8-, 16- and 32-piece batches, one, two or four
# positions per thread) and cross its batches (one piece, short batches,
# one batch and one piece, the most pieces the wrapper takes)
INT8_CASES = {"a2c-128": (False, 8, 32, 128), "a2c-1024": (False, 8, 32, 1024),
              "all-invalid": (False, 8, 32, 128),
              "ragged-plane": (True, 16, 8, 128), "m=1": (False, 8, 1, 128),
              "m=5": (False, 8, 5, 128), "m=12": (False, 8, 12, 128),
              "m=12, n=2": (False, 2, 12, 128),
              "ragged-plane, m=12": (True, 4, 12, 128),
              "m=33": (False, 8, 33, 128),
              "m=MAX_PIECES": (False, 1, wavg_ops.MAX_PIECES, 128),
              "n=1": (False, 1, 32, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_share_step_matches_plain_bitwise(case):
    """ḡ and Σw bitwise, at every case of INT8_CASES."""
    dev = _card()
    ragged, n, m, qb = INT8_CASES[case]
    layout = (PlaneLayout(None, [()], [(2 ** 20 + 37,)]) if ragged
              else _a2c_layout())
    Q, S, T, R, valid, blocks = _q_case(
        dev, n, m, layout, qb, seed=len(case),
        invalid="all" if case == "all-invalid" else "some")
    launches = wavg_ops.fused_wavg_q.launches
    got_g, got_w = wavg_ops.fused_wavg_q(Q, S, T, R, valid, blocks)
    assert wavg_ops.fused_wavg_q.launches == launches + 1
    want_g, want_w = wavg_ref.fused_wavg_q(Q, S, T, R, valid, blocks)
    assert torch.equal(got_g, want_g) and torch.equal(got_w, want_w)
    if case == "all-invalid":
        assert not bool(got_g.any()) and not bool(got_w.any())


@pytest.mark.gpu
@pytest.mark.parametrize("obs_dim,n_actions,p", [(4, 2, 8835),
                                                 (25, 4, 10309)])
def test_int8_share_step_on_the_dueling_layout(obs_dim, n_actions, p):
    """ḡ and Σw bitwise over DDADQN's int8 planes, whose blocks restart
    at each of the dueling network's 10 leaves (the 1-element ``val``
    output bias is a block of its own)."""
    dev = _card()
    tree = networks.init_dueling_q(torch.Generator().manual_seed(0), 1,
                                   obs_dim, n_actions, 64)
    layout = PlaneLayout.from_tree(tree, lead=1)
    assert layout.size == p and len(layout.paths) == 10
    Q, S, T, R, valid, blocks = _q_case(dev, 8, 32, layout, 128, seed=p)
    got_g, got_w = wavg_ops.fused_wavg_q(Q, S, T, R, valid, blocks)
    want_g, want_w = wavg_ref.fused_wavg_q(Q, S, T, R, valid, blocks)
    assert torch.equal(got_g, want_g) and torch.equal(got_w, want_w)


@pytest.mark.gpu
def test_int8_wrapper_rejects_what_the_kernel_cannot_take():
    dev = _card()
    layout = _a2c_layout()
    Q, S, T, R, valid, blocks = _q_case(dev, 2, 4, layout, 128, seed=0)
    with pytest.raises(ValueError, match="scale must be"):
        wavg_ops.fused_wavg_q(Q, S[..., :-1].contiguous(), T, R, valid,
                              blocks)
    with pytest.raises(ValueError, match="int8"):
        wavg_ops.fused_wavg_q(Q.to(torch.float32), S, T, R, valid, blocks)
    with pytest.raises(ValueError, match="block layout"):
        wavg_ops.fused_wavg_q(Q, S, T, R, valid,
                              PlaneLayout(None, [()], [(100,)]).blocks(128))
