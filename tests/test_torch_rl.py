"""Port parity: CartPole, the episode rollout, the A2C networks and
loss (``repro_torch.rl`` against ``repro.rl``).

JAX's threefry draws cannot be reproduced in torch, so the rollout is
held by replaying the reference's draws — its initial states and its
action sequence — through the port's ``reset`` / ``select_action``
hooks."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.rl import a2c as ref_a2c  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro.rl import networks as ref_nets  # noqa: E402
from repro.rl import rollout as ref_rollout  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.rl import a2c, envs, networks, rollout  # noqa: E402

N, HIDDEN = 6, 16


def _ref_params(seed=0):
    params = jax.vmap(lambda k: ref_nets.init_policy_value(
        k, 4, 2, HIDDEN))(jax.random.split(jax.random.PRNGKey(seed), N))
    return jax.tree.map(np.asarray, params)


def _ref_episodes(params, seed=3, env=None):
    """N reference episodes of the A2C policy, as numpy."""
    env = env or ref_envs.CartPole()

    def one(p, k):
        def select(obs, kk):
            return jax.random.categorical(kk, ref_nets.policy_logits(p, obs))
        return ref_rollout.run_episode(env, select, k)

    traj = jax.vmap(one)(jax.tree.map(jnp.asarray, params),
                         jax.random.split(jax.random.PRNGKey(seed), N))
    return jax.tree.map(np.asarray, traj)


def _t(x):
    """A writable copy: arrays taken from JAX are read-only."""
    return torch.from_numpy(np.array(x))


def _state(cols, t=None, done=None):
    n = cols.shape[0]
    return envs.CartPoleState(
        *(torch.from_numpy(np.ascontiguousarray(cols[:, i]))
          for i in range(4)),
        torch.from_numpy(np.zeros(n, np.int32) if t is None else t),
        torch.from_numpy(np.zeros(n, bool) if done is None else done))


def test_cartpole_constants_match():
    ref, port = ref_envs.CartPole(), envs.CartPole()
    for f in ("gravity", "masscart", "masspole", "length", "force_mag",
              "tau", "x_threshold", "max_steps", "obs_dim", "n_actions"):
        assert getattr(ref, f) == getattr(port, f), f
    assert np.float32(ref.theta_threshold) == np.float32(port.theta_threshold)


def test_cartpole_step_matches_reference():
    """One step on shared states and actions: rel 1e-6, with the
    integer / boolean outputs exact. States straddle the failure
    thresholds, the step cap and already-done episodes."""
    rng = np.random.default_rng(0)
    n = 512
    cols = np.stack([rng.uniform(-2.6, 2.6, n), rng.uniform(-2, 2, n),
                     rng.uniform(-0.25, 0.25, n), rng.uniform(-3, 3, n)],
                    axis=1).astype(np.float32)
    t = rng.integers(0, 101, n).astype(np.int32)
    done = rng.random(n) < 0.2
    action = rng.integers(0, 2, n).astype(np.int32)
    env = ref_envs.CartPole()
    ref_s = ref_envs.CartPoleState(*(jnp.asarray(cols[:, i])
                                     for i in range(4)),
                                   jnp.asarray(t), jnp.asarray(done))
    ns, obs, r, d = jax.vmap(env.step)(ref_s, jnp.asarray(action))
    gs, gobs, gr, gd = envs.CartPole().step(
        _state(cols, t, done), torch.from_numpy(action.astype(np.int64)))
    for name in ("x", "x_dot", "theta", "theta_dot"):
        np.testing.assert_allclose(getattr(gs, name).numpy(),
                                   np.asarray(getattr(ns, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(gobs.numpy(), np.asarray(obs), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(gs.t.numpy(), np.asarray(ns.t))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(d))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(r))


def test_cartpole_reset_draws_in_range():
    s = envs.CartPole().reset(torch.Generator().manual_seed(0), 1000)
    obs = envs.CartPole().obs(s)
    assert obs.shape == (1000, 4) and obs.dtype == torch.float32
    assert float(obs.abs().max()) <= 0.05
    assert not bool(s.done.any()) and int(s.t.max()) == 0


def _replay(traj):
    """The port's env and action hooks replaying a reference episode."""
    s0 = traj.obs[:, 0]

    class ReplayCartPole(envs.CartPole):
        def reset(self, gen, n):
            return _state(s0)

    step = iter(range(traj.actions.shape[1]))

    def select(obs, gen):
        return torch.from_numpy(traj.actions[:, next(step)].astype(np.int64))

    return ReplayCartPole(), select


def test_run_episode_replayed_draws():
    """The port's fixed-length rollout on the reference's s0 and action
    draws: actions, rewards, dones and the post-terminal mask are
    identical; observations agree to rel 1e-6 over the live steps.

    Tolerance: the two libraries' fp32 sin/cos differ by 1 ulp for a
    few per cent of arguments, and the inverted pendulum amplifies a
    1-ulp state difference by about e^(4.4/s · 0.02 s) per step, so the
    live part of an episode (at most tens of steps here) is held at
    rel 1e-6 with an absolute floor of 2e-6 for components near zero.
    Post-terminal steps keep integrating a fallen pole, where that
    growth runs on unchecked; they are masked out of every loss."""
    traj = _ref_episodes(_ref_params())
    env, select = _replay(traj)
    got = rollout.run_episode(env, select, torch.Generator(), N)
    np.testing.assert_array_equal(got.actions.numpy(), traj.actions)
    np.testing.assert_array_equal(got.mask.numpy(), traj.mask)
    np.testing.assert_array_equal(got.dones.numpy(), traj.dones)
    np.testing.assert_array_equal(got.rewards.numpy(), traj.rewards)
    live = traj.mask.astype(bool)
    for name in ("obs", "next_obs"):
        np.testing.assert_allclose(getattr(got, name).numpy()[live],
                                   getattr(traj, name)[live],
                                   rtol=1e-6, atol=2e-6, err_msg=name)
    np.testing.assert_array_equal(rollout.episode_return(got).numpy(),
                                  traj.rewards.sum(axis=-1))


def test_layout_follows_jax_leaf_order():
    params = _ref_params()
    flat, layout = interop.flat_params(params)
    leaves = jax.tree_util.tree_leaves(params)
    assert layout.paths == tuple(
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0])
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([x.reshape(N, -1) for x in leaves], 1))
    back = layout.unflatten(flat)
    for (path, x), y in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree_util.tree_leaves(
                                jax.tree.map(lambda t: t.numpy(), back))):
        np.testing.assert_array_equal(x, y)


def test_paper_width_param_count():
    """The paper's A2C (hidden 64) is 4610 policy + 4545 value = 9155
    elements per agent — one flat row."""
    gen = torch.Generator().manual_seed(0)
    state, layout = a2c.init_a2c(gen, 2, envs.CartPole(), optim.adamw(1e-3))
    assert layout.size == 9155 and state.params.shape == (2, 9155)
    assert layout.paths[0] == ("policy", 0, "b")


def test_networks_forward_matches_reference():
    params = _ref_params(1)
    flat, layout = interop.flat_params(params)
    obs = np.random.default_rng(0).normal(size=(N, 7, 4)).astype(np.float32)
    tree = layout.unflatten(flat)
    want_l = jax.vmap(ref_nets.policy_logits)(params, obs)
    want_v = jax.vmap(ref_nets.state_value)(params, obs)
    np.testing.assert_allclose(
        networks.policy_logits(tree, torch.from_numpy(obs)).numpy(),
        np.asarray(want_l), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        networks.state_value(tree, torch.from_numpy(obs)).numpy(),
        np.asarray(want_v), rtol=1e-5, atol=1e-6)


def test_a2c_loss_and_grads_on_reference_weights():
    """a2c_loss and its gradients, the port's one backward pass over
    the agents' summed losses against the reference's per-agent
    value_and_grad: rtol 1e-5."""
    params = _ref_params(2)
    traj = _ref_episodes(params, seed=5)
    want_loss, want_g = jax.vmap(jax.value_and_grad(ref_a2c.a2c_loss),
                                 in_axes=(0, 0, None))(
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, traj), 0.99)
    flat, layout = interop.flat_params(params)
    flat.requires_grad_(True)
    port_traj = rollout.Trajectory(
        obs=_t(traj.obs), actions=_t(traj.actions.astype(np.int64)),
        rewards=_t(traj.rewards), next_obs=_t(traj.next_obs),
        dones=_t(traj.dones), mask=_t(traj.mask))
    loss = a2c.a2c_loss(layout.unflatten(flat), port_traj, 0.99)
    (grads,) = torch.autograd.grad(loss.sum(), flat)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss),
                               rtol=1e-5, atol=1e-6)
    want_flat = interop.flat_params(jax.tree.map(np.asarray, want_g),
                                    layout=layout)[0].numpy()
    scale = np.abs(want_flat).max(axis=1, keepdims=True)
    np.testing.assert_allclose(grads.numpy(), want_flat, rtol=1e-5,
                               atol=1e-6 * float(scale.max()))


def test_gen_grads_runs_and_returns_per_agent_rows():
    gen = torch.Generator().manual_seed(0)
    opt = optim.adamw(3e-3)
    state, layout = a2c.init_a2c(gen, 3, envs.CartPole(), opt, hidden=8)
    gen_grads, apply_grads, params_of = a2c.make_a2c_callbacks(
        envs.CartPole(), opt, layout)
    grads, metrics, same = gen_grads(state, gen)
    assert grads.shape == state.params.shape and same is state
    assert metrics["return"].shape == (3,)
    assert bool(torch.isfinite(grads).all())
    new = apply_grads(state, grads)
    assert new.step.tolist() == [1, 1, 1]
    assert not torch.equal(params_of(new), state.params)


def test_sample_categorical_follows_softmax():
    """Gumbel-max sampling (the method of jax.random.categorical): the
    action frequencies match softmax(logits) within 4 standard errors."""
    logits = torch.tensor([[0.0, 1.0, -1.0], [2.0, 2.0, -3.0]])
    rows = 100_000
    gen = torch.Generator().manual_seed(0)
    acts = a2c.sample_categorical(logits.repeat(rows, 1), gen)
    freq = torch.stack([torch.bincount(acts[i::2], minlength=3)
                        for i in range(2)]).to(torch.float64) / rows
    p = torch.softmax(logits.to(torch.float64), dim=-1)
    se = torch.sqrt(p * (1 - p) / rows)
    assert bool((torch.abs(freq - p) <= 4 * se + 1e-12).all()), (freq, p)
