"""Port parity: the eq. 4 share step (``repro_torch.kernels.ddal_wavg``).

On the CPU the wrappers run their plain versions, which are held here
against the reference's oracle (``repro.kernels.ddal_wavg.ref``) and its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it,
at rtol = atol = 2e-5 for ḡ and rtol 1e-6 for Σw. The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_ddal_wavg_gpu.py`` and ``chip_smoke.py``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.weighting import eq4_weights as ref_eq4  # noqa: E402
from repro.kernels.ddal_wavg import ops as ref_ops  # noqa: E402
from repro.kernels.ddal_wavg import ref as ref_ref  # noqa: E402
from repro_torch.kernels.ddal_wavg import ops, ref  # noqa: E402


def _case(n, m, p, seed=0, all_invalid_row=False):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, m, p)).astype(np.float32)
    T = (np.abs(rng.normal(size=(n, m))) + 0.1).astype(np.float32)
    R = (np.abs(rng.normal(size=(n, m))) + 0.1).astype(np.float32)
    valid = np.ones((n, m), bool)
    valid[:, 1 % m] = m == 1         # piece 1 invalid, as in test_kernels
    if all_invalid_row:
        valid[-1] = False
    return G, T, R, valid


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("n,m,p", [(2, 4, 8192), (2, 6, 100_000),
                                   (3, 3, 8193), (2, 32, 9155)])
def test_fused_plain_matches_reference_oracle_and_pallas(n, m, p):
    G, T, R, valid = _case(n, m, p, seed=p)
    got_g, got_w = ops.fused_wavg(*_torch(G, T, R, valid))
    assert got_g.shape == (n, p) and got_w.shape == (n,)
    for i in range(n):
        args = [jnp.asarray(x[i]) for x in (G, T, R, valid)]
        for want_g, want_w in (
                ref_ref.fused_wavg(*args),
                ref_ops.fused_wavg(*args, impl="pallas", interpret=True)):
            np.testing.assert_allclose(got_g[i].numpy(),
                                       np.asarray(want_g),
                                       rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(float(got_w[i]), float(want_w),
                                       rtol=1e-6)


@pytest.mark.parametrize("n,m,p", [(2, 4, 8192), (1, 5, 20_000),
                                   (2, 16, 4_097)])
def test_wavg_plain_matches_reference_kernel(n, m, p):
    G, T, R, valid = _case(n, m, p, seed=m)
    w = np.stack([np.asarray(ref_eq4(jnp.asarray(T[i]), jnp.asarray(R[i]),
                                     jnp.asarray(valid[i])))
                  for i in range(n)])
    got = ops.wavg(*_torch(G, w))
    for i in range(n):
        want = ref_ops.wavg(jnp.asarray(G[i]), jnp.asarray(w[i]),
                            interpret=True)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_all_invalid_store_gives_zero():
    G, T, R, valid = _case(2, 8, 300, all_invalid_row=True)
    g, w = ops.fused_wavg(*_torch(G, T, R, valid))
    assert float(w[1]) == 0.0 and not bool(g[1].any())
    assert float(w[0]) == pytest.approx(1.0, rel=1e-6)


def test_plain_accumulates_in_kernel_order():
    """The plain version is the kernel's arithmetic: left-to-right
    fp32 multiply-then-add, no fused multiply-add."""
    G, T, R, valid = _case(1, 7, 64, seed=3)
    w = ref.eq4_weights(*_torch(T, R, valid))
    acc = np.zeros(64, np.float32)
    for j in range(7):
        acc = (acc + np.float32(w[0, j].item()) * G[0, j]).astype(np.float32)
    np.testing.assert_array_equal(ref.wavg(*_torch(G), w)[0].numpy(), acc)


def test_dispatch_is_by_device_and_never_falls_back():
    G, T, R, valid = _torch(*_case(1, 2, 16))
    launches = ops.fused_wavg.launches
    ops.fused_wavg(G, T, R, valid)                 # CPU → plain
    ops.fused_wavg(G, T, R, valid, impl="plain")
    assert ops.fused_wavg.launches == launches     # no kernel ran
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.fused_wavg(G, T, R, valid, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.wavg(G, T, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.fused_wavg(G, T, R, valid, impl="pallas")
