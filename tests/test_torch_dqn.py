"""Port parity: the DDADQN agent, its networks, GridWorld and the dense
delay-line oracle (``repro_torch.rl.dqn``, ``rl.networks``,
``rl.envs.GridWorld``, ``core.knowledge.InFlight`` against the JAX
reference).

The same numpy inputs go through both sides. JAX's threefry draws
cannot be reproduced in torch, so the ε-greedy draws and the replay
indices are taken from the reference's keys and fed to the port's
hooks (``dqn.explore_draws``, ``dqn.sample_indices``), as the loop
test does (``test_torch_dqn_learning._Draws``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as ref_optim  # noqa: E402
from repro.core import knowledge as RK  # noqa: E402
from repro.rl import dqn as ref_dqn  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro.rl import networks as ref_nets  # noqa: E402
from repro.rl import rollout as ref_rollout  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.common.pytree import PlaneLayout  # noqa: E402
from repro_torch.core import knowledge as K  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.rl import dqn, envs, networks, rollout  # noqa: E402
from test_torch_dqn_learning import _Draws, _recording_gen_grads  # noqa: E402

N = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_q_params(seed, obs_dim, n_actions, hidden, n=N):
    return _np(jax.vmap(lambda k: ref_nets.init_dueling_q(
        k, obs_dim, n_actions, hidden))(
        jax.random.split(jax.random.PRNGKey(seed), n)))


# ---------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------
@pytest.mark.parametrize("obs_dim,n_actions,P", [(4, 2, 8835),
                                                 (25, 4, 10309)],
                         ids=["cartpole", "gridworld5"])
def test_dueling_q_values_and_layout(obs_dim, n_actions, P):
    """P and the leaf order of the dueling tree (10 leaves, the 1-element
    ``val`` output bias included) are ``jax.tree_util``'s; the Q values
    of n stacked agents within rtol 1e-6."""
    ref = _ref_q_params(0, obs_dim, n_actions, 64)
    rows, layout = interop.flat_params(ref)
    assert layout.size == P and len(layout.paths) == 10
    ref_paths = [tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(
                     jax.tree.map(lambda x: x[0], ref))[0]]
    assert list(layout.paths) == ref_paths
    port_tree = networks.init_dueling_q(torch.Generator().manual_seed(0),
                                        N, obs_dim, n_actions, 64)
    own = PlaneLayout.from_tree(port_tree, lead=1)
    assert own.paths == layout.paths and own.shapes == layout.shapes
    assert dict(zip(own.paths, own.sizes))[("val", 1, "b")] == 1
    assert dict(zip(own.paths, own.sizes))[("adv", 1, "b")] == n_actions

    obs = np.random.default_rng(1).normal(
        size=(N, 17, obs_dim)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(ref_nets.dueling_q_values))(
        jax.tree.map(jnp.asarray, ref), jnp.asarray(obs)))
    got = networks.dueling_q_values(layout.unflatten(rows),
                                    torch.from_numpy(obs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_group_policy_act_greedy_and_sampling():
    """Greedy: actions equal to the reference's, logits within rtol
    1e-6; sampling needs a generator (the reference's ValueError) and
    then draws valid actions."""
    A, B = 4, 11
    planes = _np(jax.vmap(lambda k: ref_nets.init_policy_value(
        k, 4, 2, 16))(jax.random.split(jax.random.PRNGKey(2), A)))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, A, B).astype(np.int32)
    obs = rng.normal(size=(B, 4)).astype(np.float32)
    want_a, want_l = jax.jit(ref_nets.group_policy_act)(
        jax.tree.map(jnp.asarray, planes), jnp.asarray(ids),
        jnp.asarray(obs))
    rows, layout = interop.flat_params(planes)
    tree = layout.unflatten(rows)
    got_a, got_l = networks.group_policy_act(
        tree, torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(obs))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="needs a"):
        networks.group_policy_act(tree, torch.from_numpy(ids),
                                  torch.from_numpy(obs), temperature=1.0)
    act, _ = networks.group_policy_act(
        tree, torch.from_numpy(ids), torch.from_numpy(obs),
        gen=torch.Generator().manual_seed(0), temperature=0.7)
    assert act.shape == (B,) and bool(((act >= 0) & (act < 2)).all())


# ---------------------------------------------------------------------
# GridWorld
# ---------------------------------------------------------------------
@pytest.mark.parametrize("size,max_steps", [(5, 50), (3, 8), (1, 4)])
def test_gridworld_reset_obs_step_bitwise(size, max_steps):
    """Reset, observation and step over seeded action sequences (a
    down/right bias reaches the goal; the last steps run past
    ``max_steps`` so the sticky ``done`` and the 0 reward after it
    show) equal the reference's, bit for bit."""
    n, steps = 6, max_steps + 5
    ref_env = ref_envs.GridWorld(size=size, max_steps=max_steps)
    env = envs.GridWorld(size=size, max_steps=max_steps)
    assert (env.obs_dim, env.n_actions) == (ref_env.obs_dim,
                                            ref_env.n_actions)
    rng = np.random.default_rng(size)
    acts = rng.choice(4, size=(steps, n), p=[0.1, 0.4, 0.1, 0.4])
    ref_s = jax.vmap(ref_env.reset)(jax.random.split(
        jax.random.PRNGKey(0), n))
    s = env.reset(torch.Generator(), n)
    np.testing.assert_array_equal(env.obs(s).numpy(),
                                  np.asarray(jax.vmap(ref_env.obs)(ref_s)))
    ref_step = jax.jit(jax.vmap(ref_env.step))
    reached = False
    for t in range(steps):
        ref_s, ref_o, ref_r, ref_d = ref_step(ref_s, jnp.asarray(
            acts[t], jnp.int32))
        s, o, r, d = env.step(s, torch.from_numpy(acts[t]))
        for got, want in zip((*s, o, r, d), (*ref_s, ref_o, ref_r, ref_d)):
            assert got.dtype == torch.from_numpy(np.array(want)).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        reached |= bool((r == 1.0).any())
    assert bool(s.done.all()) and (reached or size == 1)


# ---------------------------------------------------------------------
# the replay ring
# ---------------------------------------------------------------------
def _traj(rng, n, t, obs_dim, prefix):
    """A numpy trajectory (agent-major) with a prefix or a scattered
    live mask."""
    if prefix:
        live = np.arange(t)[None, :] < rng.integers(0, t + 1, (n, 1))
    else:
        live = rng.random((n, t)) < 0.6
    mask = live.astype(np.float32)
    return dict(obs=rng.normal(size=(n, t, obs_dim)).astype(np.float32),
                actions=rng.integers(0, 4, (n, t)).astype(np.int32),
                rewards=(rng.normal(size=(n, t)) * mask).astype(np.float32),
                next_obs=rng.normal(size=(n, t, obs_dim)).astype(np.float32),
                dones=rng.random((n, t)) < 0.1, mask=mask)


def _port_traj(tr):
    return rollout.Trajectory(
        obs=torch.from_numpy(tr["obs"]),
        actions=torch.from_numpy(tr["actions"].astype(np.int64)),
        rewards=torch.from_numpy(tr["rewards"]),
        next_obs=torch.from_numpy(tr["next_obs"]),
        dones=torch.from_numpy(tr["dones"]),
        mask=torch.from_numpy(tr["mask"]))


def _assert_replay(got, want):
    want = interop.replay(_np(want))
    for name in dqn.Replay._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "scattered"])
@pytest.mark.parametrize("capacity", [10_000, 7])
def test_replay_add_traj_bitwise(capacity, prefix):
    """Four episodes of 100 steps appended in turn: every plane, ``ptr``
    and ``size`` bitwise equal to the reference's scan, at the paper's
    capacity and at C = 7 < T, where the ring wraps within an episode
    and later live steps overwrite earlier ones."""
    n, t, d = 3, 100, 4
    rng = np.random.default_rng(capacity + prefix)
    ref = jax.vmap(lambda _: ref_dqn.make_replay(capacity, d))(jnp.arange(n))
    got = dqn.make_replay(n, capacity, d, "cpu")
    _assert_replay(got, ref)
    add = jax.jit(jax.vmap(ref_dqn.replay_add_traj))
    for _ in range(4):
        tr = _traj(rng, n, t, d, prefix)
        ref = add(ref, ref_rollout.Trajectory(
            **{k: jnp.asarray(v) for k, v in tr.items()}))
        got = dqn.replay_add_traj(got, _port_traj(tr))
        _assert_replay(got, ref)
    if capacity == 7:
        assert int(got.size.min()) == 7 and int(got.ptr.max()) > 100


def test_replay_sample_on_given_indices(monkeypatch):
    """The minibatch equals the reference's on the reference's indices;
    the port's own indices lie in [0, max(size, 1))."""
    n, C, B = 3, 50, 16
    rng = np.random.default_rng(4)
    tr = _traj(rng, n, 40, 25, prefix=False)
    ref = jax.vmap(ref_dqn.replay_add_traj)(
        jax.vmap(lambda _: ref_dqn.make_replay(C, 25))(jnp.arange(n)),
        ref_rollout.Trajectory(**{k: jnp.asarray(v) for k, v in tr.items()}))
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    want = jax.vmap(lambda r, k: ref_dqn.replay_sample(r, k, B))(ref, keys)
    idx = jax.vmap(lambda r, k: jax.random.randint(
        k, (B,), 0, jnp.maximum(r.size, 1)))(ref, keys)
    rep = interop.replay(_np(ref))
    size = rep.size.clone()
    own = dqn.sample_indices(size, 4000, torch.Generator().manual_seed(0))
    assert bool((own >= 0).all()) and bool((own < size[:, None]).all())
    assert sorted(set(own[0].tolist())) == list(range(int(size[0])))
    zero = dqn.sample_indices(torch.zeros(2, dtype=torch.int32), 8,
                              torch.Generator())
    assert not bool(zero.any())
    monkeypatch.setattr(dqn, "sample_indices", lambda s, b, g: torch.from_numpy(
        np.array(idx).astype(np.int64)))
    got = dqn.replay_sample(rep, None, B)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------
# ε, the loss, the callbacks
# ---------------------------------------------------------------------
@pytest.mark.parametrize("decay", [10, 500, 2_000, 7])
def test_epsilon_schedule_bitwise(decay):
    """ε over the anneal and past it, bitwise equal to the reference's
    compiled formula (the closure ``make_dqn_callbacks`` uses)."""
    cfg = ref_dqn.DQNConfig(eps_decay=decay)

    def eps(t):
        frac = jnp.clip(t.astype(jnp.float32) / cfg.eps_decay, 0.0, 1.0)
        return cfg.eps_start + frac * (cfg.eps_end - cfg.eps_start)

    t = np.arange(0, 2 * decay + 3, dtype=np.int32)
    want = np.asarray(jax.jit(eps)(jnp.asarray(t)))
    got = dqn.epsilon(dqn.DQNConfig(eps_decay=decay), torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _batch(rng, n, b, obs_dim, n_actions):
    return (rng.normal(size=(n, b, obs_dim)).astype(np.float32),
            rng.integers(0, n_actions, (n, b)).astype(np.int32),
            rng.normal(size=(n, b)).astype(np.float32),
            rng.normal(size=(n, b, obs_dim)).astype(np.float32),
            rng.random((n, b)) < 0.3)


def test_dqn_loss_and_gradient():
    """Per-agent loss and its gradient against ``jax.value_and_grad``
    within rtol 1e-5 / atol 1e-6: done rows, and for agent 0 a Q tie in
    every row (two advantage columns made equal), where both argmaxes
    take the first action; the target net differs from the online one,
    so the other action would change the loss."""
    rng = np.random.default_rng(6)
    params = jax.tree.map(np.array, _ref_q_params(7, 4, 2, 64))
    target = _ref_q_params(8, 4, 2, 64)
    for leaf in ("w", "b"):
        params["adv"][1][leaf][0, ..., 1] = params["adv"][1][leaf][0, ..., 0]
    batch = _batch(rng, N, 32, 4, 2)
    jb = tuple(jnp.asarray(x) for x in batch)
    loss_w, grads_w = jax.jit(jax.vmap(jax.value_and_grad(ref_dqn.dqn_loss),
                                       in_axes=(0, 0, 0, None)))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, target),
        jb, 0.99)
    q_next = np.asarray(jax.jit(jax.vmap(ref_nets.dueling_q_values))(
        jax.tree.map(jnp.asarray, params), jb[3]))
    assert (q_next[0, :, 0] == q_next[0, :, 1]).all()
    rows, layout = interop.flat_params(params)
    trow = interop.flat_params(target, layout=layout)[0]
    flat = rows.clone().requires_grad_(True)
    pb = (torch.from_numpy(batch[0]), torch.from_numpy(batch[1]).long(),
          torch.from_numpy(batch[2]), torch.from_numpy(batch[3]),
          torch.from_numpy(batch[4]))
    loss = dqn.dqn_loss(layout.unflatten(flat), layout.unflatten(trow), pb,
                        0.99)
    (grads,) = torch.autograd.grad(loss.sum(), flat)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_w),
                               rtol=1e-5, atol=1e-6)
    want = interop.flat_params(_np(grads_w), layout=layout)[0].numpy()
    np.testing.assert_allclose(grads.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    assert not bool((trow == rows).all())


def _ref_states(env, opt, cfg, n, seed):
    return jax.vmap(lambda k: ref_dqn.init_dqn(k, env, opt, cfg))(
        jax.random.split(jax.random.PRNGKey(seed), n))


def test_gen_grads_on_injected_draws(monkeypatch):
    """One epoch of the callbacks on GridWorld at ε ≈ 0.5 (both branches
    of the ε-greedy choice taken): the port's ``gen_grads`` on the
    reference's draws gives the same replay (bitwise), ε (bitwise),
    returns, and loss and gradients within rtol 1e-5."""
    env_r, env = ref_envs.GridWorld(), envs.GridWorld()
    cfg_kw = dict(batch=16, capacity=64, eps_decay=10, hidden=32)
    cfg_r, cfg = ref_dqn.DQNConfig(**cfg_kw), dqn.DQNConfig(**cfg_kw)
    opt_r, opt = ref_optim.adamw(1e-3), optim.adamw(1e-3)
    states = _ref_states(env_r, opt_r, cfg_r, N, 9)
    states = states._replace(eps_t=jnp.full((N,), 5, jnp.int32))
    gen_r, _, _ = ref_dqn.make_dqn_callbacks(env_r, opt_r, cfg_r)
    keys = jax.random.split(jax.random.PRNGKey(10), N)
    g_w, m_w, s_w = jax.jit(jax.vmap(_recording_gen_grads(
        env_r, cfg_r, gen_r)))(states, keys)
    draws = _Draws()
    draws.load(m_w)
    eps = float(m_w["epsilon"][0])
    assert (draws.u < eps).any() and (draws.u >= eps).any()
    monkeypatch.setattr(dqn, "explore_draws", draws.explore)
    monkeypatch.setattr(dqn, "sample_indices", draws.indices)
    _, layout = interop.flat_params(_np(states.params))
    gen_g, _, _ = dqn.make_dqn_callbacks(env, opt, cfg, layout)
    grads, metrics, new = gen_g(interop.dqn_state(_np(states), layout),
                                torch.Generator())
    _assert_replay(new.replay, s_w.replay)
    np.testing.assert_array_equal(metrics["epsilon"].numpy(),
                                  np.asarray(m_w["epsilon"]))
    # sums of 50 rewards of -0.01 in another order: within one rounding
    np.testing.assert_allclose(metrics["return"].numpy(),
                               np.asarray(m_w["return"]), rtol=1e-6)
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(m_w["loss"]), rtol=1e-5, atol=1e-6)
    want = interop.flat_params(_np(g_w), layout=layout)[0].numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(grads.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    assert new.eps_t.tolist() == [6] * N


def test_near_empty_buffer_zero_gradient_adamw_still_steps():
    """With fewer steps in the ring than a minibatch the gradient is
    zero on both sides, and ``apply_grads`` still steps AdamW: the count
    moves, the moments decay and the parameters move on the old
    moments, as the reference's do (rtol 1e-6)."""
    env_r, env = ref_envs.GridWorld(), envs.GridWorld()
    cfg_kw = dict(batch=64, capacity=128, hidden=16)
    cfg_r, cfg = ref_dqn.DQNConfig(**cfg_kw), dqn.DQNConfig(**cfg_kw)
    opt_r, opt = ref_optim.adamw(1e-3), optim.adamw(1e-3)
    states = _ref_states(env_r, opt_r, cfg_r, N, 11)
    rng = np.random.default_rng(12)
    states = states._replace(opt_state={
        "m": jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape), jnp.float32), states.params),
        "v": jax.tree.map(lambda x: jnp.asarray(
            rng.random(x.shape) + 0.1, jnp.float32), states.params),
        "count": jnp.full((N,), 3, jnp.int32)})
    gen_r, app_r, _ = ref_dqn.make_dqn_callbacks(env_r, opt_r, cfg_r)
    g_w, _, s_w = jax.jit(jax.vmap(gen_r))(states, jax.random.split(
        jax.random.PRNGKey(13), N))
    assert int(s_w.replay.size.max()) <= env.max_steps < cfg.batch
    assert not np.asarray(jax.tree.leaves(
        jax.tree.map(lambda x: jnp.any(x != 0), g_w))).any()
    want = _np(jax.jit(jax.vmap(app_r))(s_w, g_w))
    _, layout = interop.flat_params(_np(states.params))
    gen_g, app, _ = dqn.make_dqn_callbacks(env, opt, cfg, layout)
    start = interop.dqn_state(_np(states), layout)
    grads, _, mid = gen_g(start, torch.Generator().manual_seed(0))
    assert not bool(grads.any()) and int(mid.replay.size.max()) < cfg.batch
    got = app(mid, grads)
    w = interop.dqn_state(want, layout)
    assert got.opt_state["count"].tolist() == [4] * N == \
        w.opt_state["count"].tolist()
    assert got.step.tolist() == w.step.tolist() == [1] * N
    for g, ww in ((got.params, w.params), (got.opt_state["m"],
                                           w.opt_state["m"]),
                  (got.opt_state["v"], w.opt_state["v"])):
        np.testing.assert_allclose(g.numpy(), ww.numpy(), rtol=1e-6,
                                   atol=1e-9)
    assert not bool((got.params == start.params).all())


def test_target_sync_per_agent():
    """``apply_grads`` copies θ → θ⁻ only for the agents whose step
    count reaches a multiple of ``target_period``, as the reference's
    does per agent."""
    env_r, env = ref_envs.CartPole(), envs.CartPole()
    cfg_kw = dict(capacity=16, target_period=3, hidden=16)
    cfg_r, cfg = ref_dqn.DQNConfig(**cfg_kw), dqn.DQNConfig(**cfg_kw)
    opt_r, opt = ref_optim.adamw(1e-3), optim.adamw(1e-3)
    n = 4
    states = _ref_states(env_r, opt_r, cfg_r, n, 14)
    states = states._replace(
        step=jnp.asarray([2, 1, 5, 0], jnp.int32),
        target_params=_ref_states(env_r, opt_r, cfg_r, n, 15).params)
    rng = np.random.default_rng(16)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape),
                                               jnp.float32), states.params)
    _, app_r, _ = ref_dqn.make_dqn_callbacks(env_r, opt_r, cfg_r)
    want = interop.dqn_state(_np(jax.jit(jax.vmap(app_r))(states, grads)),
                             interop.flat_params(_np(states.params))[1])
    _, layout = interop.flat_params(_np(states.params))
    _, app, _ = dqn.make_dqn_callbacks(env, opt, cfg, layout)
    start = interop.dqn_state(_np(states), layout)
    got = app(start, interop.flat_params(_np(grads), layout=layout)[0])
    synced = [True, False, True, False]
    assert got.step.tolist() == want.step.tolist() == [3, 2, 6, 1]
    for i, s in enumerate(synced):
        expect = got.params[i] if s else start.target_params[i]
        assert torch.equal(got.target_params[i], expect)
    np.testing.assert_allclose(got.params.numpy(), want.params.numpy(),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.target_params.numpy(),
                               want.target_params.numpy(), rtol=1e-6,
                               atol=1e-9)


# ---------------------------------------------------------------------
# the dense delay-line oracle
# ---------------------------------------------------------------------
def _assert_dense(got, want, p):
    for name in ("T", "R", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.grads.numpy(),
                                  np.asarray(want.grads["w"]).reshape(
                                      got.grads.shape))


def _assert_stores(got, want):
    for name in ("T", "R", "valid", "ptr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.grads.numpy(),
                                  np.asarray(want.grads["w"]))


@pytest.mark.parametrize("n,D,m,start", [(3, 2, 4, 0), (4, 1, 8, 3),
                                         (5, 3, 3, 2)])
def test_dense_inflight_matches_reference_and_sparse_full(n, D, m, start):
    """Epochs of send + deliver over random pieces, per-edge delays and
    relevance, sharing from epoch ``start`` on: the dense delay line and
    the stores bitwise equal to the reference's after every epoch, and
    the port's sparse delay line at the ``full`` topology leaves the
    same stores."""
    p, epochs = 5, 9
    rng = np.random.default_rng(n * 10 + D)
    ref_send, ref_deliver = jax.jit(RK.send), jax.jit(RK.deliver)
    delay = rng.integers(0, D + 1, (n, n)).astype(np.int32)
    params = {"w": jnp.zeros((p,))}
    ref_f = RK.make_inflight(params, n, D)
    ref_s = jax.vmap(lambda _: RK.make_store(params, m))(jnp.arange(n))
    dense = K.make_inflight(n, D, p, "cpu")
    stores = K.make_store(n, m, p, "cpu")
    topo = T.full(n).with_delay(delay)
    sparse = K.make_sparse_inflight(n, topo.degree, D, p, "cpu")
    stores_s = K.make_store(n, m, p, "cpu")
    for e in range(epochs):
        on = e >= start
        pieces = rng.normal(size=(n, p)).astype(np.float32)
        Tw = rng.uniform(1, 5, (n,)).astype(np.float32)
        R = np.ones((n, n), np.float32)
        ref_f = ref_send(ref_f, {"w": jnp.asarray(pieces)}, jnp.asarray(Tw),
                         jnp.asarray(R), jnp.asarray(delay), e, on)
        ref_f, ref_s = ref_deliver(ref_f, ref_s, e)
        dense = K.send(dense, torch.from_numpy(pieces), torch.from_numpy(Tw),
                       torch.from_numpy(R), delay, e, on)
        dense, stores = K.deliver(dense, stores, e)
        sparse = K.sparse_send(sparse, topo, torch.from_numpy(pieces),
                               torch.from_numpy(Tw), e, on)
        sparse, stores_s = K.sparse_deliver(sparse, stores_s, e)
        _assert_dense(dense, ref_f, p)
        _assert_stores(stores, ref_s)
        for name in ("grads", "T", "R", "valid", "ptr"):
            assert torch.equal(getattr(stores_s, name),
                               getattr(stores, name)), (e, name)
    assert bool(stores.valid.any())


def test_dense_inflight_carries_relevance():
    """R travels per edge (src → dst) into the stores, as the
    reference's does."""
    n, D, p, m = 3, 1, 2, 6
    rng = np.random.default_rng(17)
    ref_send, ref_deliver = jax.jit(RK.send), jax.jit(RK.deliver)
    delay = np.ones((n, n), np.int32)
    params = {"w": jnp.zeros((p,))}
    ref_f = RK.make_inflight(params, n, D)
    ref_s = jax.vmap(lambda _: RK.make_store(params, m))(jnp.arange(n))
    dense, stores = K.make_inflight(n, D, p, "cpu"), K.make_store(n, m, p,
                                                                  "cpu")
    for e in range(4):
        pieces = rng.normal(size=(n, p)).astype(np.float32)
        Tw = rng.uniform(1, 5, (n,)).astype(np.float32)
        R = rng.random((n, n)).astype(np.float32)
        ref_f = ref_send(ref_f, {"w": jnp.asarray(pieces)}, jnp.asarray(Tw),
                         jnp.asarray(R), jnp.asarray(delay), e, True)
        ref_f, ref_s = ref_deliver(ref_f, ref_s, e)
        dense = K.send(dense, torch.from_numpy(pieces), torch.from_numpy(Tw),
                       torch.from_numpy(R), delay, e, True)
        dense, stores = K.deliver(dense, stores, e)
        _assert_dense(dense, ref_f, p)
        _assert_stores(stores, ref_s)
