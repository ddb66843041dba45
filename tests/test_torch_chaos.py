"""Port parity for elastic membership: the numpy chaos planner, and the
buffer trainer's ``kill`` / ``revive`` against the reference's, plus
ports of the reference's chaos-lane invariants (``tests/test_chaos.py``).

The loops feed both trainers the same gradients, drawn from one numpy
table (the reference's per-agent ``key`` argument carries the agent's
row, the port's ``gen`` argument the epoch's (n, P) block), so every
store and delay-line plane is bitwise; parameters and AdamW moments are
held at ``tests/test_torch_ddal.py``'s rtol 1e-5."""
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
from repro.core import chaos as ref_chaos  # noqa: E402
from repro.rl import a2c as ref_a2c  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import chaos, topology  # noqa: E402
from repro_torch.core.ddal import DDAL  # noqa: E402
from repro_torch.core.weighting import eq4_weights  # noqa: E402
from repro_torch.rl import a2c, envs  # noqa: E402

HIDDEN = 8


def ref_gossip_uniforms(seed, rnd, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    return np.asarray(jax.random.uniform(key, (n, n)))


@pytest.mark.parametrize("seed,n,epochs,kw", [
    (3, 8, 50, dict(kill_prob=0.2, revive_after=4)),
    (7, 4, 200, dict(kill_prob=0.5, revive_after=3, min_alive=2)),
    (11, 6, 60, dict(kill_prob=0.3, revive_after=2)),
    (0, 1, 10, dict(kill_prob=1.0, revive_after=1)),
])
def test_chaos_plans_bitwise(seed, n, epochs, kw):
    want = ref_chaos.chaos_schedule(seed, n, epochs, **kw)
    got = chaos.chaos_schedule(seed, n, epochs, **kw)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    ev_ref = list(ref_chaos.membership_events(want))
    ev = list(chaos.membership_events(got))
    assert len(ev) == len(ev_ref)
    for (e, k, r), (e2, k2, r2) in zip(ev, ev_ref):
        assert e == e2
        np.testing.assert_array_equal(k, k2)
        np.testing.assert_array_equal(r, r2)


@pytest.mark.parametrize("kw", [dict(kill_prob=1.5), dict(revive_after=0),
                                dict(min_alive=0), dict(min_alive=9)])
def test_chaos_planner_refuses_like_reference(kw):
    with pytest.raises(ValueError):
        ref_chaos.chaos_schedule(0, 8, 10, **kw)
    with pytest.raises(ValueError):
        chaos.chaos_schedule(0, 8, 10, **kw)


class _Rig:
    """The reference's and the port's DDAL on the same A2C agents
    (hidden 8) and the same table of gradients."""

    def __init__(self, spec_kw, epochs, delay=None, seed=5):
        n = spec_kw["n_agents"]
        env = ref_envs.CartPole()
        ref_opt = ref_optim.adamw(3e-3)
        states = jax.vmap(lambda k: ref_a2c.init_a2c(k, env, ref_opt,
                                                     HIDDEN))(
            jax.random.split(jax.random.PRNGKey(0), n))
        np_states = jax.tree.map(np.asarray, states)
        _, self.layout = interop.flat_params(np_states.params)
        rng = np.random.default_rng(seed)
        self.table = [jax.tree.map(
            lambda x: (rng.normal(size=x.shape)
                       + rng.normal(size=x.shape[1:])).astype(np.float32),
            np_states.params) for _ in range(epochs)]
        _, app, pof = ref_a2c.make_a2c_callbacks(env, ref_opt)

        def ref_grads(state, g):
            return g, {"return": state.step.astype(jnp.float32)}, state

        def port_grads(state, g):
            return g, {"return": state.step.to(torch.float32)}, state

        self.ref = RefDDAL(RefSpec(**spec_kw), ref_grads, app, pof,
                           delay=None if delay is None else
                           jnp.asarray(delay))
        self.ref_step = jax.jit(self.ref.epoch_step)
        opt = optim.adamw(3e-3)
        _, p_app, p_pof = a2c.make_a2c_callbacks(envs.CartPole(), opt,
                                                 self.layout)
        self.port = DDAL(GroupSpec(**spec_kw), port_grads, p_app, p_pof,
                         device="cpu", layout=self.layout, delay=delay)
        self.ref_gs = self.ref.init(states)
        self.gs = self.port.init(interop.a2c_state(np_states, self.layout))

    def step(self, e):
        self.ref_gs, _ = self.ref_step(self.ref_gs, self.table[e])
        self.gs, _ = self.port.epoch_step(self.gs, interop.flat_params(
            self.table[e], layout=self.layout)[0])

    def kill(self, mask):
        self.ref_gs = self.ref.kill(self.ref_gs, jnp.asarray(mask))
        self.gs = self.port.kill(self.gs, mask)

    def revive(self, mask):
        self.ref_gs = self.ref.revive(self.ref_gs, jnp.asarray(mask))
        self.gs = self.port.revive(self.gs, mask)

    def check(self, what, qb=0):
        want = jax.tree.map(np.asarray, self.ref_gs)
        gs = self.gs
        np.testing.assert_array_equal(gs.alive, want.alive)
        np.testing.assert_array_equal(gs.nbr, want.nbr)
        st = interop.knowledge_store(want.stores, self.layout, q_block=qb)
        fl = interop.sparse_inflight(want.flight, self.layout, q_block=qb)
        for got, ref, names in ((gs.stores, st, ("grads", "T", "R",
                                                 "valid", "ptr", "scale")),
                                (gs.flight, fl, ("grads", "T", "R", "valid",
                                                 "scale"))):
            for name in names:
                if getattr(ref, name) is None:
                    assert getattr(got, name) is None
                    continue
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(), getattr(ref, name).numpy(),
                    err_msg=f"{name} {what}")
        want_a = interop.a2c_state(want.agent_states, self.layout)
        got_a = gs.agent_states
        np.testing.assert_allclose(got_a.params.numpy(),
                                   want_a.params.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"params {what}")
        for key in ("m", "v"):
            w = want_a.opt_state[key].numpy()
            np.testing.assert_allclose(got_a.opt_state[key].numpy(), w,
                                       rtol=1e-5,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f"{key} {what}")
        np.testing.assert_array_equal(got_a.step.numpy(),
                                      want_a.step.numpy())


@pytest.mark.parametrize("kw", [
    dict(topology="full", m_pieces=10),                 # aligned blocks
    dict(topology="ring", exchange_delay="uniform", max_delay=2),
    dict(topology="ring", exchange_delay="uniform", max_delay=1,
         knowledge_quant_block=128),
    dict(topology="random_k", degree=3, resample_every=3),
], ids=["full-aligned", "ring-delay2", "ring-delay1-int8", "dynamic"])
def test_chaos_driven_loop_matches_reference(kw, monkeypatch):
    """Fourteen epochs driven by a ``chaos_schedule`` (kills in warm-up
    and in sharing, revivals): stores and delay lines bitwise after every
    epoch and every membership event."""
    monkeypatch.setattr(topology, "gossip_uniforms", ref_gossip_uniforms)
    n, epochs = 5, 14
    spec_kw = dict(n_agents=n, threshold=2, minibatch=2, m_pieces=6,
                   elastic=True)
    spec_kw.update(kw)
    plan = chaos.chaos_schedule(4, n, epochs, kill_prob=0.25,
                                revive_after=3, min_alive=2)
    assert (~plan).any()
    events = {e: (k, r) for e, k, r in chaos.membership_events(plan)}
    rig = _Rig(spec_kw, epochs)
    qb = kw.get("knowledge_quant_block", 0)
    for e in range(epochs):
        if e in events:
            kill, revive = events[e]
            if kill.any():
                rig.kill(kill)
                rig.check(f"kill {e}", qb)
            if revive.any():
                rig.revive(revive)
        before = rig.gs.agent_states.params.clone()
        rig.step(e)
        rig.check(f"epoch {e}", qb)
        dead = ~plan[e]
        assert torch.equal(rig.gs.agent_states.params[dead], before[dead])


def test_dead_agent_is_frozen_and_dark():
    """Mid-sharing kill: the corpse's row freezes, its store is emptied,
    no plane to or from it stays in flight, and nothing lands in its
    ring afterwards; the survivors keep exchanging."""
    n = 3
    rig = _Rig(dict(n_agents=n, threshold=0, minibatch=1, m_pieces=4,
                    elastic=True), 9)
    for e in range(4):
        rig.step(e)
    dead = np.array([False, True, False])
    rig.kill(dead)
    gs = rig.gs
    assert not bool(gs.stores.valid[1].any())
    valid = gs.flight.valid.numpy()
    assert not valid[1].any() and not valid[gs.nbr == 1].any()
    frozen = gs.agent_states.params[1].clone()
    for e in range(4, 9):
        rig.step(e)
        rig.check(f"epoch {e}")
    gs = rig.gs
    assert torch.equal(gs.agent_states.params[1], frozen)
    assert not bool(gs.stores.valid[1].any())
    assert bool(gs.stores.valid[0].any())


@pytest.mark.parametrize("topo", ["full", "ring"])
def test_dead_agent_has_exactly_zero_eq4_weight(topo):
    """Whatever a dead agent's gradients are after its death (zeros or
    1e6 garbage), the survivors' stores, eq. 4 weights and parameters
    come out bitwise the same: a corpse's pieces carry exactly zero
    weight; on the aligned path its slots are invalid holes whose
    weight is exactly 0."""
    n, dead = 4, np.array([False, False, True, False])
    out = []
    for fill in (0.0, 1e6):
        spec = GroupSpec(n_agents=n, threshold=1, minibatch=1, m_pieces=8,
                         topology=topo, elastic=True)
        opt = optim.adamw(3e-3)
        state, layout = a2c.init_a2c(torch.Generator().manual_seed(0), n,
                                     envs.CartPole(), opt, HIDDEN)
        _, app, pof = a2c.make_a2c_callbacks(envs.CartPole(), opt, layout)
        rng = np.random.default_rng(1)
        table = torch.from_numpy(rng.normal(
            size=(10, n, layout.size)).astype(np.float32))

        def grads(st, e, fill=fill):
            g = table[e].clone()
            if e >= 3:
                g[2] = fill
            return g, {"return": st.step.to(torch.float32)}, st

        ddal = DDAL(spec, grads, app, pof, device="cpu", layout=layout)
        gs = ddal.init(state)
        for e in range(10):
            if e == 3:
                gs = ddal.kill(gs, dead)
            gs, _ = ddal.epoch_step(gs, e)
        w = eq4_weights(gs.stores.T, gs.stores.R, gs.stores.valid)
        out.append((gs, w))
    (g0, w0), (g1, w1) = out
    assert torch.equal(w0, w1)
    assert torch.equal(g0.stores.grads[~dead], g1.stores.grads[~dead])
    assert torch.equal(g0.agent_states.params, g1.agent_states.params)
    holes = ~g0.stores.valid[~dead]
    assert bool((w0[~dead][holes] == 0).all())
    if topo == "full":       # the aligned path keeps the corpse's slots
        assert bool(holes.any())


def test_revival_replays_nothing_stale():
    """With every edge 3 epochs late, pieces sent before the death must
    not surface after the revival: every valid piece of the revived ring
    was sent at or after the revival epoch (T is the send epoch)."""
    n, d = 3, 3
    rig = _Rig(dict(n_agents=n, threshold=0, minibatch=1, m_pieces=8,
                    elastic=True, t_weighting="epochs"), 12,
               delay=np.full((n, n), d, np.int32))
    dead = np.array([False, True, False])
    for e in range(12):
        if e == 5:
            rig.kill(dead)
        if e == 7:
            rig.revive(dead)
        rig.step(e)
        rig.check(f"epoch {e}")
    T = rig.gs.stores.T[1].numpy()
    valid = rig.gs.stores.valid[1].numpy()
    assert valid.any() and (T[valid] >= 7).all()


def test_all_alive_elastic_is_the_plain_path():
    """elastic=True with nobody dying gives the non-elastic numbers."""
    out = []
    for elastic in (False, True):
        rig = _Rig(dict(n_agents=4, threshold=1, minibatch=2, m_pieces=4,
                        topology="ring", elastic=elastic), 8)
        for e in range(8):
            rig.step(e)
        out.append(rig.gs)
    assert torch.equal(out[0].agent_states.params,
                       out[1].agent_states.params)
    for a, b in zip(out[0].stores[:5], out[1].stores[:5]):
        assert torch.equal(a, b)
