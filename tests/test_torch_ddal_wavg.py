"""Port parity: the eq. 4 share step (``repro_torch.kernels.ddal_wavg``),
fp32 and int8, and the int8 wire format.

On the CPU the wrappers run their plain versions, which are held here
against the reference's oracle (``repro.kernels.ddal_wavg.ref`` /
``ops.tree_fused_wavg_q``) and its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them, at rtol = atol = 2e-5 for ḡ and
rtol 1e-6 for Σw. Quantization is exact arithmetic (a max, a true
division, round half to even), so ``q``, the scales and the
dequantised values are held bitwise. The CUDA kernels themselves are
held against the plain versions on the card by
``tests/test_torch_ddal_wavg_gpu.py`` and ``chip_smoke.py``."""
from __future__ import annotations

import jax
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
    """CPU tensors take the plain version, with no launch counted; the
    wrappers have no switch besides the tensors' device."""
    G, T, R, valid = _torch(*_case(1, 2, 16))
    launches = ops.fused_wavg.launches
    ops.fused_wavg(G, T, R, valid)                 # CPU → plain
    assert ops.fused_wavg.launches == launches     # no kernel ran
    with pytest.raises(TypeError, match="impl"):
        ops.fused_wavg(G, T, R, valid, impl="plain")
    with pytest.raises(TypeError, match="impl"):
        ops.fused_wavg(G, T, R, valid, impl="cuda")
    with pytest.raises(TypeError, match="impl"):
        ops.wavg(G, T, impl="cuda")


# ---------------------------------------------------------------------
# int8 knowledge planes: the wire format and the int8 share step
# ---------------------------------------------------------------------
def _a2c_layout():
    from repro.rl import networks as ref_nets
    from repro_torch import interop
    params = jax.tree.map(np.asarray, ref_nets.init_policy_value(
        jax.random.PRNGKey(0), 4, 2, 64))
    return params, interop.flat_params(params, lead=0)[1]


def _mixed(rng, shape):
    """Values over several magnitudes, with some exact zeros."""
    x = rng.normal(size=shape) * np.exp(rng.normal(size=shape))
    x[..., ::17] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("qb", [128, 1024])
@pytest.mark.parametrize("case", ["a2c", "ragged-leaf"])
def test_quantize_flat_bitwise_vs_quantize_tree(case, qb):
    """``q`` and ``scale`` bitwise the reference's per-leaf
    ``quantize_tree`` (blocks restart at every leaf) compiled, as its
    trainer's step compiles it (XLA turns the division of the block max
    by 127.0 into a multiply by f32(1/127)); ``dequantize_flat``
    bitwise its ``dequantize_tree``; int8 in ±127."""
    from repro_torch import interop
    from repro_torch.common.pytree import PlaneLayout
    rng = np.random.default_rng(qb)
    if case == "a2c":
        params, layout = _a2c_layout()
        tree = jax.tree.map(lambda x: _mixed(rng, (3, 2) + x.shape), params)
        flat = interop.flat_params(tree, lead=2, layout=layout)[0]
        assert layout.blocks(qb).n_blocks == (76 if qb == 128 else 18)
    else:
        tree = {"w": _mixed(rng, (3, 2, 5 * qb + 37))}
        layout = PlaneLayout.from_tree(tree, lead=2)
        flat = layout.flatten({"w": torch.from_numpy(tree["w"])})
    blocks = layout.blocks(qb)
    q, s = ref.quantize_flat(flat, blocks)
    want_q, want_s = jax.jit(lambda t: ref_ops.quantize_tree(t, qb, lead=2))(
        jax.tree.map(jnp.asarray, tree))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    np.testing.assert_array_equal(
        q.numpy(), layout.flatten(jax.tree.map(
            lambda x: torch.from_numpy(np.array(x)), want_q)).numpy())
    np.testing.assert_array_equal(s.numpy(), np.concatenate(
        [np.asarray(x) for x in jax.tree.leaves(want_s)], axis=-1))
    back = ref.dequantize_flat(q, s, blocks)
    want_back = ref_ops.dequantize_tree(want_q, want_s, qb)
    np.testing.assert_array_equal(back.numpy(), layout.flatten(jax.tree.map(
        lambda x: torch.from_numpy(np.array(x)), want_back)).numpy())


def _q_case(n, m, layout, qb, seed, all_invalid_row=False):
    rng = np.random.default_rng(seed)
    G = _mixed(rng, (n, m, layout.size))
    q, s = ref.quantize_flat(torch.from_numpy(G), layout.blocks(qb))
    _, T, R, valid = _case(n, m, 1, seed=seed,
                           all_invalid_row=all_invalid_row)
    return q, s, T, R, valid


@pytest.mark.parametrize("qb", [128, 1024])
def test_fused_wavg_q_plain_matches_reference_at_a2c_width(qb):
    """Against ``tree_fused_wavg_q`` over the A2C leaves, which at this
    width is dequantise + ``tensordot`` per leaf."""
    params, layout = _a2c_layout()
    n, m = 3, 32
    q, s, T, R, valid = _q_case(n, m, layout, qb, seed=qb)
    got_g, got_w = ops.fused_wavg_q(q, s, *_torch(T, R, valid),
                                    layout.blocks(qb))
    assert got_g.shape == (n, layout.size) and got_w.shape == (n,)
    blocks = layout.blocks(qb)
    treedef = jax.tree.structure(params)
    for i in range(n):
        qtree = jax.tree.unflatten(treedef, [
            jnp.asarray(q[i][:, off:off + size].reshape((m,) + shape).numpy())
            for off, size, shape in zip(layout.offsets, layout.sizes,
                                        layout.shapes)])
        stree = jax.tree.unflatten(treedef, [
            jnp.asarray(s[i][:, so:so + -(-size // qb)].numpy())
            for so, size in zip(blocks.scale_offsets, layout.sizes)])
        want_g, want_w = ref_ops.tree_fused_wavg_q(
            qtree, stree, jnp.asarray(T[i]), jnp.asarray(R[i]),
            jnp.asarray(valid[i]), qb)
        want = layout.flatten(jax.tree.map(
            lambda x: torch.from_numpy(np.array(x)), want_g))
        np.testing.assert_allclose(got_g[i].numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(float(got_w[i]), float(want_w),
                                   rtol=1e-6)


@pytest.mark.parametrize("qb", [128, 1024])
def test_fused_wavg_q_plain_matches_pallas_on_a_big_leaf(qb):
    """One leaf of 3·8192 + 37 elements, which the reference sends
    through ``fused_wavg_q_flat`` (interpret mode)."""
    from repro.kernels.ddal_wavg.kernel import fused_wavg_q_flat
    from repro_torch.common.pytree import PlaneLayout
    layout = PlaneLayout(None, [()], [(3 * 8192 + 37,)])
    q, s, T, R, valid = _q_case(2, 5, layout, qb, seed=7)
    got_g, got_w = ops.fused_wavg_q(q, s, *_torch(T, R, valid),
                                    layout.blocks(qb))
    for i in range(2):
        want_g, want_w = fused_wavg_q_flat(
            jnp.asarray(q[i].numpy()), jnp.asarray(s[i].numpy()),
            jnp.asarray(T[i]), jnp.asarray(R[i]), jnp.asarray(valid[i]),
            qb, interpret=True)
        np.testing.assert_allclose(got_g[i].numpy(), np.asarray(want_g),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(float(got_w[i]), float(want_w),
                                   rtol=1e-6)


def test_fused_wavg_q_all_invalid_store_gives_zero():
    _, layout = _a2c_layout()
    q, s, T, R, valid = _q_case(2, 8, layout, 128, seed=1,
                                all_invalid_row=True)
    g, w = ops.fused_wavg_q(q, s, *_torch(T, R, valid), layout.blocks(128))
    assert float(w[1]) == 0.0 and not bool(g[1].any())
    assert float(w[0]) == pytest.approx(1.0, rel=1e-6)


def test_plain_int8_step_accumulates_in_kernel_order():
    """acc ← acc + w_j·(q_j·s_j), each op rounded on its own."""
    from repro_torch.common.pytree import PlaneLayout
    layout = PlaneLayout(None, [(0,), (1,)], [(100,), (300,)])
    blocks = layout.blocks(128)
    q, s, T, R, valid = _q_case(1, 6, layout, 128, seed=4)
    w = ref.eq4_weights(*_torch(T, R, valid))
    deq = (q[0].numpy().astype(np.float32)
           * s[0].numpy()[:, blocks.columns.numpy()]).astype(np.float32)
    acc = np.zeros(400, np.float32)
    for j in range(6):
        acc = (acc + np.float32(w[0, j].item()) * deq[j]).astype(np.float32)
    got, _ = ops.fused_wavg_q(q, s, *_torch(T, R, valid), blocks)
    np.testing.assert_array_equal(got[0].numpy(), acc)
    with pytest.raises(TypeError, match="impl"):
        ops.fused_wavg_q(q, s, *_torch(T, R, valid), blocks, impl="cuda")
