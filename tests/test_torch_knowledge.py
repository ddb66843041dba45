"""Port parity: knowledge stores and sparse delay lines over flat planes
(``repro_torch.core.knowledge`` against ``repro.core.knowledge``).

Masks, pointers and slot contents are pure data movement, so they must
be bitwise-equal; planes are held at rtol 1e-6 (in practice also
bitwise). The reference's pytrees are flattened into the port's planes
with the reference's leaf order (``repro_torch.interop``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import knowledge as RK  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.rl import networks as ref_nets  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import knowledge as K  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402

HIDDEN = 4


def _params_like():
    return jax.tree.map(np.asarray, ref_nets.init_policy_value(
        jax.random.PRNGKey(0), 4, 2, HIDDEN))


def _layout():
    return interop.flat_params(_params_like(), lead=0)[1]


def _pieces(rng, lead):
    """A reference-shaped pytree of seeded pieces with leading axes."""
    return jax.tree.map(
        lambda x: rng.normal(size=lead + x.shape).astype(np.float32),
        _params_like())


def _assert_store(port, ref, layout):
    want = interop.knowledge_store(jax.tree.map(np.asarray, ref), layout)
    np.testing.assert_array_equal(port.valid.numpy(), want.valid.numpy())
    np.testing.assert_array_equal(port.ptr.numpy(), want.ptr.numpy())
    np.testing.assert_array_equal(port.T.numpy(), want.T.numpy())
    np.testing.assert_array_equal(port.R.numpy(), want.R.numpy())
    np.testing.assert_allclose(port.grads.numpy(), want.grads.numpy(),
                               rtol=1e-6, atol=0)


def _assert_flight(port, ref, layout):
    want = interop.sparse_inflight(jax.tree.map(np.asarray, ref), layout)
    np.testing.assert_array_equal(port.valid.numpy(), want.valid.numpy())
    np.testing.assert_array_equal(port.T.numpy(), want.T.numpy())
    np.testing.assert_array_equal(port.R.numpy(), want.R.numpy())
    np.testing.assert_allclose(port.grads.numpy(), want.grads.numpy(),
                               rtol=1e-6, atol=0)


def _ref_stores(n, m):
    params0 = jax.tree.map(jnp.asarray, _params_like())
    return jax.vmap(lambda _: RK.make_store(params0, m))(jnp.arange(n))


def test_append_sequence_with_wraparound_and_gating():
    n, m = 3, 4
    rng = np.random.default_rng(0)
    layout = _layout()
    ref = _ref_stores(n, m)
    ref_append = jax.jit(jax.vmap(RK.append))
    port = K.make_store(n, m, layout.size, "cpu")
    for step in range(7):                      # wraps the ring of 4
        piece = _pieces(rng, (n,))
        Tv = rng.random(n).astype(np.float32)
        Rv = rng.random(n).astype(np.float32)
        en = rng.random(n) > 0.3
        ref = ref_append(ref, jax.tree.map(jnp.asarray, piece),
                         jnp.asarray(Tv), jnp.asarray(Rv), jnp.asarray(en))
        port = K.append(port, interop.flat_params(piece, layout=layout)[0],
                        torch.from_numpy(Tv), torch.from_numpy(Rv),
                        torch.from_numpy(en))
        _assert_store(port, ref, layout)


@pytest.mark.parametrize("c,m", [(7, 4), (3, 8), (16, 5)])
def test_append_many_last_writer_wins(c, m):
    """More pieces than slots: the later piece wins each slot, exactly
    as c sequential appends would leave the ring."""
    n = 3
    rng = np.random.default_rng(c * 10 + m)
    layout = _layout()
    ref = _ref_stores(n, m)
    ref_append_many = jax.jit(jax.vmap(RK.append_many))
    port = K.make_store(n, m, layout.size, "cpu")
    for _ in range(3):
        pieces = _pieces(rng, (n, c))
        Tv = rng.random((n, c)).astype(np.float32)
        Rv = rng.random((n, c)).astype(np.float32)
        dv = rng.random((n, c)) > 0.25
        ref = ref_append_many(
            ref, jax.tree.map(jnp.asarray, pieces), jnp.asarray(Tv),
            jnp.asarray(Rv), jnp.asarray(dv))
        port = K.append_many(
            port, interop.flat_params(pieces, lead=2, layout=layout)[0],
            torch.from_numpy(Tv), torch.from_numpy(Rv),
            torch.from_numpy(dv))
        _assert_store(port, ref, layout)


TOPOLOGIES = {
    "full": lambda m: m.full(4),
    "ring": lambda m: m.ring(5),
    "random_k": lambda m: m.random_k(6, 3, seed=2),
    "star": lambda m: m.star(4),                  # padded edge slots
}
DELAYS = {
    "none": lambda t, m: t,
    "uniform": lambda t, m: t.with_delay(2),
    "hops": lambda t, m: m.delay_from_hops(t, 1),  # per-edge delays
}


@pytest.mark.parametrize("delay", list(DELAYS))
@pytest.mark.parametrize("topo_name", list(TOPOLOGIES))
def test_send_deliver_sequence(topo_name, delay):
    """Eight epochs of send + deliver, sharing from epoch 2 on, through
    every reference send path (uniform unpadded, uniform padded,
    heterogeneous delays) and both delivery paths (aligned k-block,
    general ``append_many``): delay line and stores after every
    epoch."""
    ref_topo = DELAYS[delay](TOPOLOGIES[topo_name](RT), RT)
    topo = DELAYS[delay](TOPOLOGIES[topo_name](T), T)
    n, k = topo.nbr.shape
    m = 2 * k if topo_name == "full" else 5       # regular / general
    D = topo.max_delay
    layout = _layout()
    params0 = jax.tree.map(jnp.asarray, _params_like())
    ref_f = RK.make_sparse_inflight(params0, ref_topo, D)
    ref_s = _ref_stores(n, m)
    port_f = K.make_sparse_inflight(n, k, D, layout.size, "cpu")
    port_s = K.make_store(n, m, layout.size, "cpu")
    # the topology is closed over, so the reference picks its send /
    # deliver paths from the concrete table, as the trainer's does
    ref_send = jax.jit(lambda f, p, t, e, en: RK.sparse_send(
        f, ref_topo, p, t, e, en))
    ref_deliver = jax.jit(lambda f, s, e: RK.sparse_deliver(
        f, s, e, ref_topo))
    rng = np.random.default_rng(7)
    for epoch in range(8):
        pieces = _pieces(rng, (n,))
        Tv = np.full((n,), max(epoch, 1), np.float32)
        sharing = epoch >= 2
        ref_f = ref_send(ref_f, jax.tree.map(jnp.asarray, pieces),
                         jnp.asarray(Tv), jnp.int32(epoch),
                         jnp.asarray(sharing))
        ref_f, ref_s = ref_deliver(ref_f, ref_s, jnp.int32(epoch))
        port_f = K.sparse_send(
            port_f, topo, interop.flat_params(pieces, layout=layout)[0],
            torch.from_numpy(Tv), epoch, sharing)
        port_f, port_s = K.sparse_deliver(port_f, port_s, epoch, topo)
        _assert_flight(port_f, ref_f, layout)
        _assert_store(port_s, ref_s, layout)
    assert bool(port_s.valid.any())


def test_regular_exchange_predicate_matches_reference():
    for name, make in TOPOLOGIES.items():
        for m in (3, 4, 8, 12):
            port, ref = make(T), make(RT)
            k = port.degree
            assert (K._regular_exchange(port, m, k)
                    == RK._regular_exchange(ref, m, k)), (name, m)


def _assert_int8(port, want):
    """Int8 planes and scales bitwise; ``want`` is already converted."""
    assert port.grads.dtype == torch.int8
    np.testing.assert_array_equal(port.grads.numpy(), want.grads.numpy())
    np.testing.assert_array_equal(port.scale.numpy(), want.scale.numpy())
    for name in ("T", "R", "valid"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("relevance", ["static", "learned"])
@pytest.mark.parametrize("topo_name,delay,qb", [
    ("ring", 2, 128),            # general delivery, uniform delay 2
    ("full", 0, 128),            # the aligned k-block fast path
    ("full", 1, 1024),
])
def test_int8_send_deliver_sequence(topo_name, delay, qb, relevance):
    """Eight epochs of send + deliver of shared pieces over int8 planes,
    sharing from epoch 2 on: each source's piece is quantized once
    before the gather, and the scales ride with it. The delay line and
    the stores — int8 planes, scales, T, R, valid and ptr — are bitwise
    the reference's after every epoch. ``learned`` hands both sides a
    per-edge R that changes every epoch, on the port as a tensor (the
    learned estimator's form) instead of a host table."""
    n = 5 if topo_name == "ring" else 4
    make = getattr(T, topo_name)
    ref_topo = getattr(RT, topo_name)(n).with_delay(delay)
    topo = make(n).with_delay(delay)
    k = topo.degree
    m = 2 * k if topo_name == "full" else 5
    layout = _layout()
    params0 = jax.tree.map(jnp.asarray, _params_like())
    ref_f = RK.make_sparse_inflight(params0, ref_topo, delay, qb)
    ref_s = jax.vmap(lambda _: RK.make_store(params0, m, qb))(jnp.arange(n))
    blocks = layout.blocks(qb)
    port_f = K.make_sparse_inflight(n, k, delay, layout.size, "cpu", blocks)
    port_s = K.make_store(n, m, layout.size, "cpu", blocks)
    ref_send = jax.jit(lambda f, t, p, tv, e, en: RK.sparse_send(
        f, t, p, tv, e, en, quant_block=qb))
    ref_deliver = jax.jit(lambda f, s, e: RK.sparse_deliver(
        f, s, e, ref_topo))
    rng = np.random.default_rng(qb + delay)
    for epoch in range(8):
        pieces = _pieces(rng, (n,))
        Tv = np.full((n,), max(epoch, 1), np.float32)
        sharing = epoch >= 2
        ref_t, port_t = ref_topo, topo
        if relevance == "learned":
            r = rng.random((n, k)).astype(np.float32)
            ref_t = ref_topo._replace(relevance=jnp.asarray(r))
            port_t = topo._replace(relevance=torch.from_numpy(r))
        ref_f = ref_send(ref_f, ref_t, jax.tree.map(jnp.asarray, pieces),
                         jnp.asarray(Tv), jnp.int32(epoch),
                         jnp.asarray(sharing))
        ref_f, ref_s = ref_deliver(ref_f, ref_s, jnp.int32(epoch))
        port_f = K.sparse_send(
            port_f, port_t, interop.flat_params(pieces, layout=layout)[0],
            torch.from_numpy(Tv), epoch, sharing)
        port_f, port_s = K.sparse_deliver(port_f, port_s, epoch, topo)
        want_f = interop.sparse_inflight(jax.tree.map(np.asarray, ref_f),
                                         layout, q_block=qb)
        want_s = interop.knowledge_store(jax.tree.map(np.asarray, ref_s),
                                         layout, q_block=qb)
        _assert_int8(port_f, want_f)
        _assert_int8(port_s, want_s)
        np.testing.assert_array_equal(port_s.ptr.numpy(), want_s.ptr.numpy())
    assert bool(port_s.valid.any())


def test_int8_store_append_carries_scales():
    """``append`` / ``append_many`` on an int8 store move the scales with
    the planes, and refuse a piece without them."""
    n, m, qb = 2, 3, 128
    layout = _layout()
    blocks = layout.blocks(qb)
    params0 = jax.tree.map(jnp.asarray, _params_like())
    ref = jax.vmap(lambda _: RK.make_store(params0, m, qb))(jnp.arange(n))
    port = K.make_store(n, m, layout.size, "cpu", blocks)
    rng = np.random.default_rng(0)
    from repro.kernels.ddal_wavg import ops as ref_wavg_ops
    from repro_torch.kernels.ddal_wavg.ref import quantize_flat
    for step in range(4):
        piece = _pieces(rng, (n,))
        qt, st = jax.jit(lambda t: ref_wavg_ops.quantize_tree(
            t, qb, lead=1))(jax.tree.map(jnp.asarray, piece))
        Tv = rng.random(n).astype(np.float32)
        ref = jax.vmap(lambda s, p, t, r, sc: RK.append(
            s, p, t, r, True, scale=sc))(ref, qt, jnp.asarray(Tv),
                                          jnp.asarray(Tv), st)
        q, s = quantize_flat(interop.flat_params(piece, layout=layout)[0],
                             blocks)
        port = K.append(port, q, torch.from_numpy(Tv), torch.from_numpy(Tv),
                        scale=s)
        want = interop.knowledge_store(jax.tree.map(np.asarray, ref),
                                       layout, q_block=qb)
        _assert_int8(port, want)
    with pytest.raises(ValueError, match="scales"):
        K.append(port, q, torch.from_numpy(Tv), torch.from_numpy(Tv))
    many = K.append_many(port, q[:, None].expand(n, 2, -1),
                         torch.ones(n, 2), torch.ones(n, 2),
                         torch.ones(n, 2, dtype=torch.bool),
                         scales=s[:, None].expand(n, 2, -1))
    assert torch.equal(many.scale[:, 1], s) and torch.equal(many.scale[:, 2], s)
