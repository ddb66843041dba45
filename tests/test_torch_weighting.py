"""Port parity: eq. 4 weights and training experience
(``repro_torch.core.weighting`` against ``repro.core.weighting``)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import weighting as W  # noqa: E402
from repro_torch.core import weighting as TW  # noqa: E402


def _ulps(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want) / np.spacing(np.abs(want))


@pytest.mark.parametrize("n,m", [(1, 1), (2, 32), (8, 32), (3, 200)])
def test_eq4_weights_store_metadata_within_one_ulp(n, m):
    """Store metadata as the trainer writes it — T an epoch count, R an
    edge relevance of 1 or 0 — sums exactly in any order, so the port
    agrees with the reference to 1 ulp (in practice to the bit)."""
    rng = np.random.default_rng(n * 1000 + m)
    T = rng.integers(1, 50_000, size=(n, m)).astype(np.float32)
    R = rng.integers(0, 2, size=(n, m)).astype(np.float32)
    valid = rng.random((n, m)) > 0.25
    if n > 1:
        valid[0] = False                             # an all-invalid row
    want = np.stack([np.asarray(W.eq4_weights(
        jnp.asarray(T[i]), jnp.asarray(R[i]), jnp.asarray(valid[i])))
        for i in range(n)])
    got = TW.eq4_weights(torch.from_numpy(T), torch.from_numpy(R),
                         torch.from_numpy(valid)).numpy()
    assert np.all((got == want) | (_ulps(got, want) <= 1.0))


def test_eq4_weights_arbitrary_floats_within_sum_reordering():
    """With arbitrary fp32 metadata the two sums are taken in different
    orders (left to right here, XLA's own order there); the weights then
    agree within one ulp plus the reordering bound m·2⁻²⁴ relative."""
    rng = np.random.default_rng(0)
    n, m = 16, 32
    T = (np.abs(rng.normal(size=(n, m))) * 100 + 0.1).astype(np.float32)
    R = (np.abs(rng.normal(size=(n, m))) + 0.1).astype(np.float32)
    valid = rng.random((n, m)) > 0.3
    want = np.stack([np.asarray(W.eq4_weights(
        jnp.asarray(T[i]), jnp.asarray(R[i]), jnp.asarray(valid[i])))
        for i in range(n)])
    got = TW.eq4_weights(torch.from_numpy(T), torch.from_numpy(R),
                         torch.from_numpy(valid)).numpy()
    bound = np.spacing(np.abs(want)) + want * (m * 2.0 ** -24)
    assert np.all(np.abs(got - want) <= bound)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("mode", ["epochs", "sqrt", "uniform"])
@pytest.mark.parametrize("epoch", [0, 1, 7, 1234, 49_999])
def test_training_experience_bitwise(mode, epoch):
    want = np.float32(W.training_experience(jnp.int32(epoch), mode))
    assert np.float32(TW.training_experience(epoch, mode)) == want


def test_training_experience_unknown_mode():
    with pytest.raises(ValueError, match="unknown T mode"):
        TW.training_experience(3, "linear")
