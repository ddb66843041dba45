"""Port parity for adaptive gossip: ``sample_gossip``, ``DynamicTopology``
and the ``dynamic`` and ``relevance_topk`` schedules against the
reference, on the reference's recorded random draws.

Torch cannot draw threefry's streams, so the port's hooks
(``topology.gossip_uniforms``, ``schedules.topk_draws``) are replaced
by the reference's ``jax.random`` draws of the same round. Given the
same draws the tables are bitwise; so are the delay lines and stores of
whole DDAL loops over them (seeded gradients, rtol 1e-5 for params)."""
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
from repro.core import topology as ref_topo  # noqa: E402
from repro.core.exchange import schedules as ref_sched  # noqa: E402
from repro.rl import a2c as ref_a2c  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.ddal import DDAL  # noqa: E402
from repro_torch.core.exchange import schedules  # noqa: E402
from repro_torch.rl import a2c, envs  # noqa: E402

HIDDEN = 8


def ref_gossip_uniforms(seed, rnd, n):
    """The reference's round draw of ``DynamicTopology.round_table``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    return np.asarray(jax.random.uniform(key, (n, n)))


def ref_topk_draws(seed, rnd, n):
    """The reference's three round draws of ``sample_table``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    kg, ke, ku = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(kg, (n, n), minval=1e-12,
                                          maxval=1.0)),
            np.asarray(jax.random.uniform(ke, (n,))),
            np.asarray(jax.random.uniform(ku, (n, n))))


@pytest.fixture
def ref_draws(monkeypatch):
    monkeypatch.setattr(topology, "gossip_uniforms", ref_gossip_uniforms)
    monkeypatch.setattr(schedules, "topk_draws", ref_topk_draws)


@pytest.mark.parametrize("n,k,seed,dead", [
    (5, 3, 0, None), (8, 4, 3, None), (6, 6, 1, None),
    (8, 4, 2, [1, 5]), (6, 4, 4, [0, 2, 3, 4]),    # 1 live other < k−1
    (4, 2, 9, [0, 1, 2, 3]),
])
def test_sample_gossip_bitwise_on_the_same_draws(n, k, seed, dead):
    key = jax.random.PRNGKey(seed)
    alive = None
    if dead is not None:
        alive = np.ones(n, bool)
        alive[dead] = False
    want = np.asarray(ref_topo.sample_gossip(
        key, n, k, None if alive is None else jnp.asarray(alive)))
    got = topology.sample_gossip(np.asarray(jax.random.uniform(key, (n, n))),
                                 k, alive)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        topology.sample_gossip(np.zeros((n, n), np.float32), n + 1)


def test_dynamic_topology_table_sequence_bitwise(ref_draws):
    """Ten epochs of a DynamicTopology resampled every 3 epochs, with
    dense delay and relevance carries and a dead agent from epoch 4:
    the carried tables and the materialised Topologies are bitwise."""
    n, k = 7, 3
    rng = np.random.default_rng(0)
    dd = rng.integers(0, 3, (n, n)).astype(np.int32)
    dr = rng.random((n, n)).astype(np.float32)
    ref = ref_topo.DynamicTopology(
        base=ref_topo.random_k(n, k, 5), resample_every=3,
        seed=11).with_dense(delay=jnp.asarray(dd), relevance=jnp.asarray(dr))
    port = topology.DynamicTopology(
        base=topology.random_k(n, k, 5), resample_every=3,
        seed=11).with_dense(delay=dd, relevance=dr)
    assert port.max_delay == ref.max_delay
    r_nbr = jnp.asarray(ref.base.nbr)
    p_nbr = port.base.nbr
    for e in range(10):
        alive = None if e < 4 else np.array([True] * 3 + [False] + [True] * 3)
        r_alive = None if alive is None else jnp.asarray(alive)
        r_nbr = ref.refresh_table(e, r_nbr, r_alive)
        p_nbr = port.refresh_table(e, p_nbr, alive)
        np.testing.assert_array_equal(p_nbr, np.asarray(r_nbr))
        want, got = ref.with_table(r_nbr), port.with_table(p_nbr)
        for name in ("nbr", "mask", "delay", "relevance"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)),
                                          err_msg=f"{name} {e}")
        np.testing.assert_array_equal(
            port.at_epoch(e, alive).nbr,
            np.asarray(ref.at_epoch(e, None if alive is None
                                    else jnp.asarray(alive)).nbr))
    static = topology.DynamicTopology(base=topology.random_k(n, k, 5),
                                      resample_every=0, seed=1)
    assert static.at_epoch(3) is static.base


@pytest.mark.parametrize("n,k,eps,dead", [
    (8, 4, 0.0, None), (8, 4, 0.5, None), (6, 3, 1.0, None),
    (8, 4, 0.0, [2, 3, 5, 6, 7]),        # 2 live others < k−1: −inf ties
    (6, 5, 0.3, [0, 1, 4]),
    (5, 4, 0.0, [0, 1, 2, 3, 4]),        # every column −inf
])
def test_relevance_topk_sample_table_bitwise(ref_draws, n, k, eps, dead):
    """``sample_table`` on a learned R over several rounds; with dead
    columns fewer than k−1 live candidates can remain, and the −inf
    ties must break toward the lower index as ``lax.top_k`` does."""
    rng = np.random.default_rng(n * 10 + k)
    R = (rng.random((n, n)) * 0.999 + 1e-3).astype(np.float32)
    alive = None
    if dead is not None:
        alive = np.ones(n, bool)
        alive[dead] = False
    ref = ref_sched.RelevanceTopKSchedule(ref_topo.random_k(n, k, 1), 2, 7,
                                          eps)
    port = schedules.RelevanceTopKSchedule(topology.random_k(n, k, 1), 2, 7,
                                           eps)
    for step in (0, 1, 2, 6, 13):
        r_alive = None if alive is None else jnp.asarray(alive)
        want = np.asarray(ref.sample_table(step, jnp.asarray(R), r_alive))
        got = port.sample_table(step, torch.from_numpy(R), alive)
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        np.testing.assert_array_equal(port.explore_mask(step),
                                      np.asarray(ref.explore_mask(step)))
        assert (got[:, 0] == np.arange(n)).all()
    # the uniform estimator's R (None): the same code path
    np.testing.assert_array_equal(port.sample_table(4, None),
                                  np.asarray(ref.sample_table(4, None)))


def test_explore_mask_rate_on_the_default_draws():
    """With the port's own draws the exploring share of destinations
    follows ε (64 destinations × 200 rounds: within 0.02 of ε)."""
    for eps in (0.1, 0.5):
        s = schedules.RelevanceTopKSchedule(topology.random_k(64, 4, 0), 1,
                                            3, eps)
        rate = np.mean([s.explore_mask(r).mean() for r in range(200)])
        assert abs(rate - eps) < 0.02, (eps, rate)
    assert not schedules.RelevanceTopKSchedule(
        topology.random_k(16, 4, 0), 1, 3, 0.0).explore_mask(5).any()


@pytest.mark.parametrize("args,msg", [
    (dict(resample_every=0), "resample_every >= 1"),
    (dict(eps=1.5), "explore_eps"),
    (dict(base="star"), "padded edge mask"),
    (dict(base="prior"), "per-edge relevance prior"),
])
def test_relevance_topk_constructor_errors_like_reference(args, msg):
    kw = dict(resample_every=2, seed=0, eps=0.1)
    base = args.pop("base", None)
    kw.update(args)
    bases = {None: (ref_topo.random_k(6, 3, 0), topology.random_k(6, 3, 0)),
             "star": (ref_topo.star(6), topology.star(6)),
             "prior": (ref_topo.random_k(6, 3, 0).with_relevance(
                 jnp.full((6, 3), 0.5)),
                 topology.random_k(6, 3, 0).with_relevance(
                     np.full((6, 3), 0.5), per_edge=True))}
    rb, pb = bases[base]
    with pytest.raises(ValueError, match=msg):
        ref_sched.RelevanceTopKSchedule(rb, **kw)
    with pytest.raises(ValueError, match=msg):
        schedules.RelevanceTopKSchedule(pb, **kw)


def _ref_grads(state, key):
    del key
    s = state.step.astype(jnp.float32)
    g = jax.tree.map(lambda p: p * (p * 0.3 - 0.1) + 0.01 * s,
                     state.params)
    return g, {"return": s}, state


def _port_grads(state, gen):
    del gen
    p = state.params
    s = state.step.to(torch.float32).unsqueeze(-1)
    return p * (p * 0.3 - 0.1) + 0.01 * s, {"return": s[:, 0]}, state


@pytest.mark.parametrize("kw", [
    dict(topology="random_k", degree=3, resample_every=2,
         exchange_delay="uniform", max_delay=1),
    dict(topology="random_k", degree=3, resample_every=3,
         exchange_schedule="relevance_topk", explore_eps=0.3,
         relevance_mode="grad_cos", relevance_ema=0.8),
], ids=["dynamic-delay1", "relevance_topk-grad_cos"])
def test_ddal_loop_over_resampled_gossip_matches_reference(ref_draws, kw):
    """Nine epochs (warm-up, then share epochs) of DDAL over a resampled
    gossip graph, on seeded gradients: the carried table, the stores'
    and the delay line's T, R-free metadata and ptr bitwise, the pieces
    and the parameters at rtol 1e-5; the learned R at atol 2e-6."""
    n = 6
    spec_kw = dict(n_agents=n, threshold=2, minibatch=2, m_pieces=6, **kw)
    env = ref_envs.CartPole()
    ref_opt = ref_optim.adamw(3e-3)
    states = jax.vmap(lambda k: ref_a2c.init_a2c(k, env, ref_opt, HIDDEN))(
        jax.random.split(jax.random.PRNGKey(0), n))
    _, app, pof = ref_a2c.make_a2c_callbacks(env, ref_opt)
    ref_ddal = RefDDAL(RefSpec(**spec_kw), _ref_grads, app, pof)
    ref_gs = ref_ddal.init(states)
    ref_step = jax.jit(ref_ddal.epoch_step)
    np_states = jax.tree.map(np.asarray, states)
    _, layout = interop.flat_params(np_states.params)
    opt = optim.adamw(3e-3)
    _, p_app, p_pof = a2c.make_a2c_callbacks(envs.CartPole(), opt, layout)
    ddal = DDAL(GroupSpec(**spec_kw), _port_grads, p_app, p_pof,
                device="cpu")
    gs = ddal.init(interop.a2c_state(np_states, layout))
    assert ddal.max_delay == ref_ddal.max_delay
    tables = set()
    for epoch in range(9):
        ref_gs, _ = ref_step(ref_gs, jax.random.split(
            jax.random.PRNGKey(epoch), n))
        gs, _ = ddal.epoch_step(gs, None)
        want = jax.tree.map(np.asarray, ref_gs)
        np.testing.assert_array_equal(gs.nbr, want.nbr, err_msg=f"{epoch}")
        tables.add(gs.nbr.tobytes())
        st = interop.knowledge_store(want.stores, layout)
        fl = interop.sparse_inflight(want.flight, layout)
        for got, ref in ((gs.stores, st), (gs.flight, fl)):
            for name in ("valid", "T"):
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(), getattr(ref, name).numpy(),
                    err_msg=f"{name} {epoch}")
            np.testing.assert_allclose(got.R.numpy(), ref.R.numpy(),
                                       atol=2e-6)
            np.testing.assert_allclose(got.grads.numpy(), ref.grads.numpy(),
                                       rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(gs.stores.ptr.numpy(), st.ptr.numpy())
        np.testing.assert_allclose(gs.relevance.numpy(),
                                   np.asarray(want.relevance), atol=2e-6)
        want_a = interop.a2c_state(want.agent_states, layout)
        np.testing.assert_allclose(gs.agent_states.params.numpy(),
                                   want_a.params.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"params {epoch}")
    assert len(tables) >= 3          # the graph did move
