"""Port parity: the gradient-sketch projection
(``repro_torch.kernels.grad_sketch``) and ``fold_seed`` against
``repro.kernels.grad_sketch`` and ``repro.core.relevance``.

The sign stream and the folded seeds are integer hashes, so they are
held bitwise, at seeds and positions where uint32 wrap-around and the
int32 reinterpretation matter. The sketch sums in another order than
the Pallas kernel (run in interpret mode, as
``tests/test_relevance_sketch.py`` runs it) and than the reference's
per-leaf walk, so it is held to the reference's own gate, rtol 1e-4 and
atol 1e-3. On the CPU the wrapper runs its plain version; the CUDA
kernel is held against it on the card by
``tests/test_torch_grad_sketch_gpu.py`` and ``chip_smoke.py``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import relevance as RREL  # noqa: E402
from repro.kernels.grad_sketch import kernel as RSK  # noqa: E402
from repro.kernels.grad_sketch import ref as RSKref  # noqa: E402
from repro.rl import networks as ref_nets  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import relevance as REL  # noqa: E402
from repro_torch.kernels.grad_sketch import ops, ref  # noqa: E402

SEEDS = [0, 7, -1, 2 ** 31 - 1, -2 ** 31]
STARTS = [0, 11, 2 ** 31 - 5, 2 ** 32 - 3]
SKETCH_TOL = dict(rtol=1e-4, atol=1e-3)


def test_mix_constants_are_the_reference_s():
    assert ref.MIX_CONSTANTS == RSK.MIX_CONSTANTS


@pytest.mark.parametrize("dim", [1, 100, 256])
@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("seed", SEEDS)
def test_sign_block_bitwise(seed, start, dim):
    """64 positions from ``start`` (past 2³² they wrap, as the
    reference's uint32 arithmetic does) for every seed and width."""
    want_bits = np.asarray(RSK._sign_bits(jnp.int32(seed), jnp.uint32(start),
                                          64, dim))
    want = np.asarray(RSK.sign_block(jnp.int32(seed), jnp.uint32(start),
                                     64, dim))
    np.testing.assert_array_equal(
        ref.sign_bits(seed, start, 64, dim).numpy(), want_bits)
    np.testing.assert_array_equal(
        ref.sign_block(seed, start, 64, dim).numpy(), want)


def test_fold_seed_bitwise():
    for seed in SEEDS + [3, 12345]:
        got = [REL.fold_seed(seed, r) for r in range(301)]
        want = np.asarray(jax.vmap(
            lambda r: RREL.fold_seed(jnp.int32(seed), r))(
                jnp.arange(301, dtype=jnp.int32)))
        np.testing.assert_array_equal(np.asarray(got, np.int32), want)
        assert all(-2 ** 31 <= x < 2 ** 31 for x in got)


@pytest.mark.parametrize("n,p,d", [(8, 1024, 128), (3, 4097, 256),
                                   (8, 1000, 128), (16, 2048, 384)])
def test_sketch_matches_pallas_kernel_and_oracle(n, p, d):
    """The reference's test shapes at offset 11, seed 7."""
    G = np.random.default_rng(n * p).normal(size=(n, p)).astype(np.float32)
    got = ops.sketch_flat(torch.from_numpy(G), 7, d, offset=11).numpy()
    want_k = RSK.sketch_flat(jnp.asarray(G), jnp.int32(7), d, offset=11,
                             interpret=True)
    want_o = RSKref.sketch_flat(jnp.asarray(G), jnp.int32(7), d, offset=11)
    np.testing.assert_allclose(got, np.asarray(want_k), **SKETCH_TOL)
    np.testing.assert_allclose(got, np.asarray(want_o), **SKETCH_TOL)


def test_plain_sketch_tiles_at_any_width():
    """The plain version's tile changes only the order of the adds."""
    G = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 5000)).astype(np.float32))
    whole = ref.sketch_flat(G, -5, 100, offset=2 ** 32 - 7, tile=5000)
    torch.testing.assert_close(
        ref.sketch_flat(G, -5, 100, offset=2 ** 32 - 7, tile=333), whole,
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dim", [100, 256])
def test_flat_row_sketch_equals_reference_per_leaf_walk(dim):
    """The A2C at hidden 64 (P = 9155, 12 leaves): the port's one
    projection of the flat row at offset 0 against the reference's
    per-leaf sum with advancing offsets."""
    params = jax.tree.map(np.asarray, ref_nets.init_policy_value(
        jax.random.PRNGKey(0), 4, 2, 64))
    rng = np.random.default_rng(dim)
    grads = jax.tree.map(
        lambda x: rng.normal(size=(8,) + x.shape).astype(np.float32), params)
    flat, layout = interop.flat_params(grads)
    assert layout.size == 9155
    seed = REL.fold_seed(0, 123)
    got = ops.sketch_flat(flat, seed, dim).numpy()
    want = RSKref.sketch_pytree(jax.tree.map(jnp.asarray, grads),
                                jnp.int32(seed), dim)
    np.testing.assert_allclose(got, np.asarray(want), **SKETCH_TOL)


def test_dispatch_is_by_device_and_never_falls_back():
    """CPU tensors take the plain version, with no launch counted; the
    wrapper has no switch besides the tensors' device."""
    G = torch.ones((2, 10))
    launches = ops.sketch_flat.launches
    ops.sketch_flat(G, 0, 4)                      # CPU → plain
    assert ops.sketch_flat.launches == launches   # no kernel ran
    with pytest.raises(TypeError, match="impl"):
        ops.sketch_flat(G, 0, 4, impl="plain")
    with pytest.raises(TypeError, match="impl"):
        ops.sketch_flat(G, 0, 4, impl="cuda")
