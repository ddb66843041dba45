"""The gradient sketch's strided instances on the card: a rank's slice
of a leaf on the model axis (``repro_torch.common.sharding.LeafShard``)
projected at its positions in the full leaf, against the plain version
and against the contiguous kernel on the whole leaf. Every test here
needs a CUDA card and skips without one.

This file imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_tp_sketch_gpu.py
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.common.sharding import LeafShard  # noqa: E402
from repro_torch.kernels.grad_sketch import ops, ref  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _slices(full, dim, m):
    """Each rank's contiguous slice of ``full`` (n, *shape) cut on param
    dim ``dim`` into ``m``, with its ``LeafShard``."""
    shape = tuple(full.shape[1:])
    blk = shape[dim] // m
    for r in range(m):
        idx = [slice(None)] * full.ndim
        idx[dim + 1] = slice(r * blk, (r + 1) * blk)
        yield (full[tuple(idx)].contiguous(),
               LeafShard(shape, dim, r * blk, blk))


@pytest.mark.gpu
@pytest.mark.parametrize("n,shape,dim,m,d,offset", [
    (4, (2, 96, 160), 2, 2, 256, 0),         # columns, 80 a row
    (4, (2, 96, 160), 2, 4, 256, 7),         # 40 a row (not a multiple of 8)
    (3, (3, 40, 24), 1, 4, 128, 2 ** 32 - 500),   # rows of a layer
    (8, (4, 64, 64), 0, 2, 100, 11),         # the leading dim: contiguous
    (2, (2, 8, 256, 48), 1, 4, 256, 3),      # experts of stacked layers
    (1, (1, 3072, 8192), 2, 2, 256, 1234)])  # w_gate's columns, one layer
def test_strided_sketch_matches_plain_and_sums_to_the_leaf(
        n, shape, dim, m, d, offset):
    """Each slice's kernel sketch within 1e-5·Σ|G| per row of its plain
    version (two launches bitwise equal); the slices' sum within the
    same gate of the contiguous kernel on the whole leaf."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(sum(shape) + m)
    full = torch.randn((n,) + shape, generator=g, device=dev)
    seed = -123457
    acc = torch.zeros((n, d), device=dev)
    for x, leaf in _slices(full, dim, m):
        G = x.reshape(n, -1)
        got = ops.sketch_leaf(x, seed, d, offset, leaf)
        again = ops.sketch_leaf(x, seed, d, offset, leaf)
        assert torch.equal(got, again)
        want = ref.sketch_flat(G, seed, d, offset,
                               position_map=leaf.position_map())
        gate = 1e-5 * G.abs().sum(1, keepdim=True)
        assert bool(((got - want).abs() <= gate).all())
        acc += got
    whole = ops.sketch_leaf(full, seed, d, offset)
    gate = 1e-5 * full.reshape(n, -1).abs().sum(1, keepdim=True)
    assert bool(((acc - whole).abs() <= gate).all())


@pytest.mark.gpu
def test_strided_signs_bitwise():
    """One-hot slices: each local element's sketch row is the full
    leaf's sign row at its position, through the strided kernel."""
    dev = _card()
    shape, m, d, seed, offset = (3, 5, 40), 4, 384, 99, 2 ** 31 + 5
    blk = shape[2] // m
    for r in range(m):
        leaf = LeafShard(shape, 2, r * blk, blk)
        local = torch.eye(3 * 5 * blk, device=dev).reshape(-1, 3, 5, blk)
        got = ops.sketch_leaf(local, seed, d, offset, leaf)
        pos = torch.tensor([offset + (q // blk) * 40 + r * blk + q % blk
                            for q in range(3 * 5 * blk)])
        want = torch.cat([ref.sign_block(seed, int(p), 1, d, dev)
                          for p in pos])
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_strided_launch_counts_once():
    dev = _card()
    x = torch.randn((2, 4, 8, 16), device=dev)
    before = ops.sketch_flat.launches
    ops.sketch_leaf(x[..., 4:8].contiguous(), 0, 64, 0,
                    LeafShard((4, 8, 16), 2, 4, 4))
    assert ops.sketch_flat.launches == before + 1
