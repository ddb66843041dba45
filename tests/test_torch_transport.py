"""Port parity for the faulty transport and the staleness gate: the numpy
fault planner, the per-leaf payload checksums, the faulted delay line
(drops, jitter, duplicates, corruption and quarantine), the store
combiner's ``decay**age`` weights, and whole DDAL loops — against the
reference, plus ports of its degradation invariants
(``tests/test_transport.py``).

Tolerances: plans, int8 payloads, valid bits, T, R and send epochs
bitwise; fp32 checksums within 1e-6 of their absolute sum
Σ_p |w_p·x_p| (the port's per-leaf products sum in another order than
XLA's, whose own checksums of one payload on two edges differ by ~3e-7
of that); ``decay**age`` within 2 ulps (``torch.pow``
and XLA's ``power`` on the CPU may round one ulp apart), and the
parameters then at rtol 1e-5."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as ref_optim  # noqa: E402
from repro.configs.base import GroupSpec as RefSpec  # noqa: E402
from repro.core import DDAL as RefDDAL  # noqa: E402
from repro.core import knowledge as ref_K  # noqa: E402
from repro.core import topology as ref_topo  # noqa: E402
from repro.core import transport as ref_tp  # noqa: E402
from repro.core.exchange import build_exchange as ref_build  # noqa: E402
from repro.core.exchange import combiners as ref_combiners  # noqa: E402
from repro.rl import a2c as ref_a2c  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import knowledge as K  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.core.ddal import DDAL  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402
from repro_torch.core.exchange.combiners import age_gate  # noqa: E402
from repro_torch.kernels.ddal_wavg import ops  # noqa: E402
from repro_torch.rl import a2c, envs  # noqa: E402

HIDDEN = 8


def assert_chk_close(flight, want_chk, live, exact=False):
    """The port's checksum planes against the reference's on the live
    planes: bitwise for int8 payloads (``exact``), else within 1e-6 of
    Σ_p |w_p·x_p| over the plane's payload (and scales)."""
    got = flight.chk.numpy()[live]
    want = want_chk[live]
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    scale = tp.plane_checksum(
        flight.grads.abs(), None if flight.scale is None
        else flight.scale.abs(), flight.leaves).numpy()[live]
    assert (np.abs(got - want) <= 1e-6 * scale).all(), (
        float(np.max(np.abs(got - want) / scale)))


@pytest.mark.parametrize("seed,kw", [
    (0, dict(loss=0.3)),
    (5, dict(loss=0.2, dup=0.1, corrupt=0.05, jitter=2, retransmit=3)),
    (9, dict(dup=0.5, jitter=1)),
    (2, dict(loss=1.0, retransmit=2)),
    (3, dict()),
])
def test_transport_plans_bitwise(seed, kw):
    want = ref_tp.transport_schedule(seed, 6, 3, 40, **kw)
    got = tp.transport_schedule(seed, 6, 3, 40, **kw)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype
    t = tp.Transport(got, extra_delay=0)
    f = t.at(43)
    np.testing.assert_array_equal(f.drop, got.drop[3])


@pytest.mark.parametrize("kw", [dict(loss=1.5), dict(jitter=-1),
                                dict(retransmit=-1)])
def test_transport_planner_refuses_like_reference(kw):
    with pytest.raises(ValueError):
        ref_tp.transport_schedule(0, 2, 2, 4, **kw)
    with pytest.raises(ValueError):
        tp.transport_schedule(0, 2, 2, 4, **kw)
    with pytest.raises(ValueError, match="horizon"):
        tp.transport_schedule(0, 2, 2, 0)


def _params(n, seed=0):
    """A multi-leaf parameter tree (A2C, hidden 8: 12 leaves, none a
    multiple of 13 long) stacked over n agents, and its layout."""
    env = ref_envs.CartPole()
    opt = ref_optim.adamw(1e-3)
    st = jax.vmap(lambda k: ref_a2c.init_a2c(k, env, opt, HIDDEN))(
        jax.random.split(jax.random.PRNGKey(seed), n))
    tree = jax.tree.map(np.asarray, st.params)
    return tree, interop.flat_params(tree)[1]


def _faults(rng, n, k, p=0.4, jitter=2):
    return (rng.random((n, k)) < p, rng.integers(0, jitter + 1, (n, k)),
            rng.random((n, k)) < p, rng.random((n, k)) < p)


@pytest.mark.parametrize("qb", [0, 128], ids=["fp32", "int8"])
def test_faulted_delay_line_and_quarantine_match_reference(qb):
    """Six faulted sends and deliveries over a ring (drops, jitter,
    duplicates, corruption; the self-loop exempt): every delay-line
    plane, the quarantine verdicts and the stores bitwise, the checksum
    planes bitwise for int8 payloads and within 1e-6 of their absolute
    sum for fp32. The reference's send is compiled, as in its trainer:
    XLA turns the int8 scale's ``/ 127`` into a product
    (``ddal_wavg/ref.py``)."""
    n, D = 4, 4
    tree, layout = _params(n)
    topo_r, topo_p = ref_topo.ring(n), topology.ring(n)
    k = topo_p.degree
    params0 = jax.tree.map(lambda x: jnp.asarray(x[0]), tree)
    rf = ref_K.make_sparse_inflight(params0, topo_r, D, qb, transport=True,
                                    track_born=True)
    rs = jax.vmap(lambda _: ref_K.make_store(params0, 8, qb, True))(
        jnp.arange(n))
    blocks = layout.blocks(qb) if qb else None
    pf = K.make_sparse_inflight(n, k, D, layout.size, "cpu", blocks,
                                tp.LeafTable.of(layout.size, layout, blocks),
                                track_born=True)
    ps = K.make_store(n, 8, layout.size, "cpu", blocks, track_born=True)
    ref_send = jax.jit(lambda f, p, T, e, fa: ref_K.sparse_send(
        f, topo_r, p, T, e, True, quant_block=qb, faults=fa))
    rng = np.random.default_rng(qb + 1)
    quarantined = 0
    for epoch in range(6):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3).astype(
            np.float32), tree)
        T = np.full((n,), float(max(epoch, 1)), np.float32)
        drop, extra, dup, corrupt = _faults(rng, n, k)
        rfa = ref_tp.TransportFaults(jnp.asarray(drop),
                                     jnp.asarray(extra, jnp.int32),
                                     jnp.asarray(dup), jnp.asarray(corrupt))
        rf = ref_send(rf, jax.tree.map(jnp.asarray, g), jnp.asarray(T),
                      epoch, rfa)
        pf = K.sparse_send(pf, topo_p, interop.flat_params(
            g, layout=layout)[0], torch.from_numpy(T), epoch, True,
            faults=tp.TransportFaults(drop, extra.astype(np.int32), dup,
                                      corrupt))
        want_f = interop.sparse_inflight(jax.tree.map(np.asarray, rf),
                                         layout, q_block=qb)
        for name in ("grads", "T", "R", "valid", "born", "scale"):
            if getattr(want_f, name) is None:
                continue
            np.testing.assert_array_equal(getattr(pf, name).numpy(),
                                          getattr(want_f, name).numpy(),
                                          err_msg=f"{name} {epoch}")
        assert_chk_close(pf, want_f.chk.numpy(), want_f.valid.numpy(),
                         exact=bool(qb))
        rf, rs = ref_K.sparse_deliver(rf, rs, epoch)
        pf, ps = K.sparse_deliver(pf, ps, epoch)
        want_s = interop.knowledge_store(jax.tree.map(np.asarray, rs),
                                         layout, q_block=qb)
        for name in ("grads", "T", "R", "valid", "ptr", "born", "scale"):
            if getattr(want_s, name) is None:
                continue
            np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                          getattr(want_s, name).numpy(),
                                          err_msg=f"store {name} {epoch}")
        quarantined += int(corrupt.sum())
    assert quarantined and bool(ps.valid.any())
    # no corrupted payload reached a store
    g = ps.grads.to(torch.float32)
    assert float(g.abs().max()) < (tp.CORRUPT_BIAS / 2 if not qb else 128)


def test_checksum_weights_restart_at_every_leaf():
    """The trap: the reference sums ``(1 + p % 13)·x_p`` per leaf. The
    port's checksum of multi-leaf rows equals the reference's plane
    checksum (within 1e-6 of Σ|w·x|), and a single ``arange`` over the
    flat row — a one-leaf table — misses it by more than 1e-3 of that,
    so the tests above would fail with it."""
    n = 3
    tree, layout = _params(n, seed=4)
    rng = np.random.default_rng(0)
    g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                     tree)
    rows = interop.flat_params(g, layout=layout)[0]
    want = np.asarray(ref_tp.plane_checksum(jax.tree.map(
        lambda x: jnp.asarray(x)[:, None], g)))[:, 0]
    table = tp.LeafTable.of(layout.size, layout)
    got = tp.plane_checksum(rows, None, table)
    scale = tp.plane_checksum(rows.abs(), None, table).numpy()
    assert (np.abs(got.numpy() - want) <= 1e-6 * scale).all()
    flat = tp.plane_checksum(rows, None, tp.LeafTable.of(layout.size))
    assert (np.abs(flat.numpy() - want) > 1e-3 * scale).all()
    # int8 payloads with their scales: exact integer sums, bitwise
    q = rng.integers(-127, 128, rows.shape).astype(np.int8)
    s = rng.random((n, layout.blocks(128).n_blocks)).astype(np.float32)
    q_tree = layout.build([q[:, o:o + z].reshape((n,) + sh) for o, z, sh in
                           zip(layout.offsets, layout.sizes, layout.shapes)])
    s_tree = layout.build([s[:, i:i + 1] for i in range(len(layout.sizes))])
    want = np.asarray(ref_tp.plane_checksum(
        jax.tree.map(lambda x: jnp.asarray(x)[:, None], q_tree),
        jax.tree.map(lambda x: jnp.asarray(x)[:, None], s_tree)))[:, 0]
    got = tp.plane_checksum(torch.from_numpy(q), torch.from_numpy(s),
                            tp.LeafTable.of(layout.size, layout,
                                            layout.blocks(128)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_corruption_is_caught_and_finite():
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4) - 5
    table = tp.LeafTable([(0, 2), (2, 2)])
    mask = torch.tensor([False, True, False])
    bad = tp.corrupt_planes(rows, mask)
    ok = tp.checksum_ok(tp.plane_checksum(rows, None, table),
                        tp.plane_checksum(bad, None, table))
    assert ok.tolist() == [True, False, True]
    q = torch.tensor([[-128, 0, 5, 127]], dtype=torch.int8)
    nq = tp.corrupt_planes(q, torch.tensor([True]))
    assert nq.dtype == torch.int8 and nq.tolist() == [[127, -1, -6, -128]]
    assert bool(torch.isfinite(bad).all())


def test_decay_weights_match_reference():
    """The age gate: valid cut past ``max_staleness``, T and R × 0.95**age
    (ages 0–9) within 2 ulps of the reference's; the share step over the
    gated store then at rtol 1e-6."""
    n, m, p = 3, 10, 37
    rng = np.random.default_rng(3)
    born = rng.integers(0, 10, (n, m)).astype(np.int32)
    T = (rng.random((n, m)) * 9 + 1).astype(np.float32)
    R = rng.random((n, m)).astype(np.float32)
    valid = rng.random((n, m)) < 0.8
    G = rng.normal(size=(n, m, p)).astype(np.float32)
    spec = RefSpec(n_agents=n, max_staleness=6, transport_decay=0.95,
                   transport_loss=0.1)
    combine = ref_combiners.make_store_combiner(
        spec=spec, schedule=None, estimator=None, transport=object())
    rst = ref_K.KnowledgeStore(grads={"w": jnp.asarray(G)},
                               T=jnp.asarray(T), R=jnp.asarray(R),
                               valid=jnp.asarray(valid),
                               ptr=jnp.zeros((n,), jnp.int32),
                               born=jnp.asarray(born))
    want_g, want_w = combine(rst, None, 9)
    pst = K.KnowledgeStore(grads=torch.from_numpy(G),
                           T=torch.from_numpy(T), R=torch.from_numpy(R),
                           valid=torch.from_numpy(valid),
                           ptr=torch.zeros((n,), dtype=torch.int32),
                           born=torch.from_numpy(born))
    gated = age_gate(pst, 9, 6, 0.95)
    age = 9 - born
    np.testing.assert_array_equal(gated.valid.numpy(), valid & (age <= 6))
    d = np.asarray(jnp.float32(0.95) ** jnp.asarray(age, jnp.float32))
    for got, raw in ((gated.T, T), (gated.R, R)):
        np.testing.assert_array_max_ulp(got.numpy(), raw * d, maxulp=2)
    got_g, got_w = K.weighted_average(gated)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)
    # the kernel's plain version got the same T and R: bitwise with it
    from repro_torch.kernels.ddal_wavg import ref
    plain_g, plain_w = ref.fused_wavg(gated.grads, gated.T, gated.R,
                                      gated.valid)
    assert torch.equal(plain_g, got_g) and torch.equal(plain_w, got_w)


class _Rig:
    """Both trainers on the same A2C agents (hidden 8) and one table of
    gradients (the reference's per-agent key carries the agent's row)."""

    def __init__(self, spec_kw, epochs, delay=None):
        n = spec_kw["n_agents"]
        env = ref_envs.CartPole()
        ref_opt = ref_optim.adamw(3e-3)
        states = jax.vmap(lambda k: ref_a2c.init_a2c(k, env, ref_opt,
                                                     HIDDEN))(
            jax.random.split(jax.random.PRNGKey(0), n))
        np_states = jax.tree.map(np.asarray, states)
        _, self.layout = interop.flat_params(np_states.params)
        rng = np.random.default_rng(7)
        self.table = [jax.tree.map(
            lambda x: (rng.normal(size=x.shape)
                       + rng.normal(size=x.shape[1:])).astype(np.float32),
            np_states.params) for _ in range(epochs)]
        _, app, pof = ref_a2c.make_a2c_callbacks(env, ref_opt)
        self.ref = RefDDAL(
            RefSpec(**spec_kw),
            lambda s, g: (g, {"return": s.step.astype(jnp.float32)}, s),
            app, pof, delay=None if delay is None else jnp.asarray(delay))
        self.ref_step = jax.jit(self.ref.epoch_step)
        opt = optim.adamw(3e-3)
        _, p_app, p_pof = a2c.make_a2c_callbacks(envs.CartPole(), opt,
                                                 self.layout)
        self.port = DDAL(
            GroupSpec(**spec_kw),
            lambda s, g: (g, {"return": s.step.to(torch.float32)}, s),
            p_app, p_pof, device="cpu", layout=self.layout, delay=delay)
        self.ref_gs = self.ref.init(states)
        self.gs = self.port.init(interop.a2c_state(np_states, self.layout))

    def step(self, e):
        self.ref_gs, _ = self.ref_step(self.ref_gs, self.table[e])
        self.gs, _ = self.port.epoch_step(self.gs, interop.flat_params(
            self.table[e], layout=self.layout)[0])


@pytest.mark.parametrize("kw", [
    dict(topology="ring", transport_loss=0.2, transport_corrupt=0.1,
         transport_dup=0.2, transport_jitter=1, transport_retransmit=2,
         max_staleness=4, transport_decay=0.9, transport_seed=11),
    dict(topology="full", transport_loss=0.3, transport_corrupt=0.2,
         transport_seed=3, knowledge_quant_block=128),
    dict(topology="full", max_staleness=2, exchange_delay="uniform",
         max_delay=1, m_pieces=8),
], ids=["ring-mixed-faults-decay", "full-loss-corrupt-int8",
        "staleness-only-aligned"])
def test_faulty_loop_matches_reference(kw):
    """Twelve epochs of DDAL over the faulty transport (and a
    staleness-only line, which keeps the aligned delivery): delay line
    and stores bitwise (checksums rtol 1e-6), parameters rtol 1e-5."""
    n = 4
    spec_kw = dict(n_agents=n, threshold=2, minibatch=2, m_pieces=6)
    spec_kw.update(kw)
    rig = _Rig(spec_kw, 12)
    assert rig.port.max_delay == rig.ref.max_delay
    assert rig.port.local_fallback == rig.ref.local_fallback
    qb = kw.get("knowledge_quant_block", 0)
    for e in range(12):
        rig.step(e)
        want = jax.tree.map(np.asarray, rig.ref_gs)
        gs = rig.gs
        fl = interop.sparse_inflight(want.flight, rig.layout, q_block=qb)
        st = interop.knowledge_store(want.stores, rig.layout, q_block=qb)
        for got, ref in ((gs.flight, fl), (gs.stores, st)):
            for name in ("grads", "T", "R", "valid", "born", "scale",
                         "ptr"):
                if getattr(ref, name, None) is None:
                    assert getattr(got, name, None) is None, name
                    continue
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(), getattr(ref, name).numpy(),
                    err_msg=f"{name} {e}")
        if fl.chk is not None:
            assert_chk_close(gs.flight, fl.chk.numpy(), fl.valid.numpy(),
                             exact=bool(qb))
        want_a = interop.a2c_state(want.agent_states, rig.layout)
        np.testing.assert_allclose(gs.agent_states.params.numpy(),
                                   want_a.params.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"params {e}")
        np.testing.assert_array_equal(gs.agent_states.step.numpy(),
                                      want_a.step.numpy())


def _toy(spec, delay=None):
    """The reference tests' quadratic agent: w → target, step 0.5."""
    def gen_grads(s, gen):
        return s["w"] - s["target"], {"w": s["w"][:, 0]}, s

    def apply_grads(s, g):
        return {"w": s["w"] - 0.5 * g, "target": s["target"]}

    ddal = DDAL(spec, gen_grads, apply_grads, lambda s: s["w"],
                device="cpu", delay=delay)
    n = spec.n_agents
    return ddal, ddal.init({"w": torch.zeros((n, 1)),
                            "target": torch.arange(n, dtype=torch.float32
                                                   )[:, None]})


def _final_w(spec, epochs=8, delay=None):
    ddal, gs = _toy(spec, delay)
    gs, _ = ddal.run(gs, None, epochs)
    return gs.agent_states["w"][:, 0]


def test_total_loss_plus_staleness_degrades_to_local_learning():
    """loss = 1, every edge 2 epochs late, ``max_staleness=1``: every
    piece (the own one too) arrives too old, eq. 4 is empty, and each
    agent takes the local update and reaches its own target."""
    n = 3
    spec = GroupSpec(n_agents=n, threshold=1, minibatch=2, m_pieces=6,
                     transport_loss=1.0, max_staleness=1, max_delay=2)
    w = _final_w(spec, 16, np.full((n, n), 2, np.int32))
    assert bool(torch.isfinite(w).all())
    assert bool(((w - torch.arange(n)).abs() < 0.1).all()), w


def test_zero_rate_faulty_transport_is_bitwise_the_default():
    kw = dict(n_agents=4, threshold=1, minibatch=2, m_pieces=6,
              topology="ring")
    want = _final_w(GroupSpec(**kw))
    for seed in (0, 123):
        spec = GroupSpec(**kw, exchange_transport="faulty",
                         transport_seed=seed)
        ddal, gs = _toy(spec)
        assert gs.flight.chk is not None
        assert torch.equal(_final_w(spec), want)
    ex = build_exchange(GroupSpec(**kw, exchange_transport="none"))
    assert ex.transport is None and not ex.track_born


def test_corrupt_everything_equals_lose_everything():
    kw = dict(n_agents=3, threshold=1, minibatch=2, m_pieces=6)
    lost = _final_w(GroupSpec(**kw, transport_loss=1.0))
    quar = _final_w(GroupSpec(**kw, transport_corrupt=1.0))
    assert torch.equal(lost, quar)


def test_delay_line_headroom_is_knob_derived():
    kw = dict(n_agents=4, threshold=1, minibatch=2, max_delay=1)
    spec = dict(kw, transport_loss=0.1, transport_jitter=2,
                transport_retransmit=2, transport_dup=0.1)
    assert build_exchange(GroupSpec(**spec)).max_delay == 1 + 2 + 3 + 1
    assert ref_build(RefSpec(**spec), kind="buffer").max_delay == 7
    assert build_exchange(GroupSpec(**kw)).max_delay == 1


def test_faulty_share_step_launches_the_kernel_wrapper():
    """On the CPU the share step runs the plain version: no launch is
    counted; the faulty run still updates every agent every share."""
    before = ops.fused_wavg.launches
    spec = GroupSpec(n_agents=3, threshold=1, minibatch=1, m_pieces=6,
                     transport_loss=0.5, transport_seed=1)
    ddal, gs = _toy(spec)
    gs, _ = ddal.run(gs, None, 6)
    assert ops.fused_wavg.launches == before
    assert bool(torch.isfinite(gs.agent_states["w"]).all())
