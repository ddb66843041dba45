"""Port parity for observation-statistics relevance: ``obs_moments``,
``obs_overlap``, the ``obs_stats`` estimator (Chan's merge, the EMA,
elastic holds), the agents' ``track_obs`` side channel, and the
GroupMDP example's online run on the reference's recorded draws.

Tolerance: rtol 1e-6 (with an absolute floor of 1e-6 of each plane's
largest element) for the moments and the relevance — the port reduces
over the same elements in another order."""
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
from repro.core import relevance as ref_rel  # noqa: E402
from repro.core.exchange import build_exchange as ref_build  # noqa: E402
from repro.core.exchange import estimators as ref_est  # noqa: E402
from repro.rl import a2c as ref_a2c  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro.rl import networks as ref_nets  # noqa: E402
from repro.rl import rollout as ref_rollout  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import relevance as rel  # noqa: E402
from repro_torch.core.ddal import DDAL  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402
from repro_torch.core.exchange import estimators as est  # noqa: E402
from repro_torch.core.group_mdp import AgentEnv, GroupMDP  # noqa: E402
from repro_torch.rl import a2c, dqn, envs, rollout  # noqa: E402


def close(got, want, err=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=1e-6,
        atol=1e-6 * max(float(np.abs(want).max(initial=0.0)), 1e-30),
        err_msg=err)


def _trajectory(rng, n, T, d):
    mask = np.ones((n, T), np.float32)
    for i in range(n):
        mask[i, rng.integers(1, T + 1):] = 0.0
    obs = rng.normal(size=(n, T, d)).astype(np.float32)
    return obs, mask


def test_obs_moments_match_reference():
    rng = np.random.default_rng(0)
    obs, mask = _trajectory(rng, 3, 40, 5)
    z = np.zeros((3, 40), np.float32)
    got = rollout.obs_moments(rollout.Trajectory(
        torch.from_numpy(obs), torch.zeros((3, 40), dtype=torch.int64),
        torch.from_numpy(z), torch.from_numpy(obs),
        torch.zeros((3, 40), dtype=torch.bool), torch.from_numpy(mask)))
    for i in range(3):
        want = ref_rollout.obs_moments(ref_rollout.Trajectory(
            jnp.asarray(obs[i]), jnp.zeros(40, jnp.int32), jnp.asarray(z[i]),
            jnp.asarray(obs[i]), jnp.zeros(40, bool), jnp.asarray(mask[i])))
        for g, w in zip(got, want):
            close(g[i], w)


def test_obs_overlap_matches_reference():
    rng = np.random.default_rng(1)
    mean = rng.normal(size=(5, 7)).astype(np.float32)
    scale = np.abs(rng.normal(size=5)).astype(np.float32)
    scale[2] = 0.0                            # the eps floor
    got = rel.obs_overlap(torch.from_numpy(mean), torch.from_numpy(scale))
    close(got, ref_rel.obs_overlap(jnp.asarray(mean), jnp.asarray(scale)))
    assert torch.allclose(got, got.T) and bool((got.diagonal() == 1).all())


def test_estimator_chan_merge_and_ema_match_reference():
    """Eight rounds of ``observe``: warm-up rounds (the moments merge,
    the EMA holds), a zero-count batch (everything holds), dead agents
    (their moments and relevance entries hold), then sharing rounds."""
    n, d = 4, 6
    rng = np.random.default_rng(2)
    ref = ref_est.ObsStatsEstimator(0.8, d)
    port = est.ObsStatsEstimator(0.8, d)
    rs, ps = ref.init(n), port.init(n)
    for r in range(8):
        cnt = rng.integers(1, 30, n).astype(np.float32)
        if r == 3:
            cnt[:] = 0
        obs_sum = (rng.normal(size=(n, d)) * cnt[:, None]
                   + r).astype(np.float32)
        sq = (np.sum(obs_sum ** 2, 1) / np.maximum(cnt, 1) + cnt
              ).astype(np.float32)
        enabled = r >= 2
        alive = None if r < 5 else np.array([True, False, True, True])
        rs = ref.observe(rs, aux=(jnp.asarray(obs_sum), jnp.asarray(sq),
                                  jnp.asarray(cnt)),
                         enabled=enabled,
                         alive=None if alive is None else jnp.asarray(alive))
        ps = port.observe(ps, aux=tuple(torch.from_numpy(x) for x in
                                        (obs_sum, sq, cnt)),
                          enabled=enabled,
                          alive=None if alive is None else
                          torch.from_numpy(alive))
        for name, g, w in zip(ps._fields, ps, rs):
            close(g, w, f"{name} round {r}")
    assert not np.allclose(np.asarray(rs.rel), 1.0)
    # with no aux the state holds
    assert port.observe(ps, aux=None) is ps
    with pytest.raises(ValueError, match="obs_dim"):
        est.ObsStatsEstimator(0.8, None)


def test_track_obs_through_both_agents(monkeypatch):
    """``track_obs`` puts each episode's moments in the metrics of the
    A2C and the DQN callbacks: the reference's ``obs_moments`` of the
    same episode, and the group entry points turn it on for
    ``obs_stats`` only."""
    seen = []
    real = rollout.run_episode

    def recording(env, select, gen, n):
        traj = real(env, select, gen, n)
        seen.append(traj)
        return traj

    monkeypatch.setattr(a2c, "run_episode", recording)
    monkeypatch.setattr(dqn, "run_episode", recording)
    env = envs.GridWorld(size=4)
    spec = GroupSpec(n_agents=3, threshold=1, minibatch=1, m_pieces=4,
                     topology="ring", exchange_estimator="obs_stats")
    for make in (a2c.make_a2c_group, dqn.make_dqn_group):
        kw = dict(hidden=8) if make is a2c.make_a2c_group else dict(
            cfg=dqn.DQNConfig(hidden=8, capacity=64, batch=4))
        ddal, gs = make(env, optim.adamw(1e-3), spec,
                        torch.Generator().manual_seed(0), device="cpu", **kw)
        seen.clear()
        gs, m = ddal.epoch_step(gs, torch.Generator().manual_seed(1))
        traj = seen[-1]
        for i in range(3):
            want = ref_rollout.obs_moments(ref_rollout.Trajectory(
                *(jnp.asarray(np.asarray(x[i])) for x in traj)))
            for g, w in zip(m["obs_moments"], want):
                close(g[i], w)
        np.testing.assert_array_equal(gs.relevance.count.numpy(),
                                      m["obs_moments"][2].numpy())
        plain, _ = make(env, optim.adamw(1e-3), GroupSpec(n_agents=3),
                        torch.Generator().manual_seed(0), device="cpu", **kw)
        _, m2 = plain.epoch_step(_, torch.Generator().manual_seed(1))
        assert "obs_moments" not in m2


def test_group_mdp_validates_like_reference():
    spec = GroupSpec(n_agents=3)
    agents = tuple(AgentEnv(envs.GridWorld()) for _ in range(3))
    g = GroupMDP(agents=agents, spec=spec, relevance=np.eye(3))
    assert g.n == 3
    with pytest.raises(ValueError, match="n_agents=3"):
        GroupMDP(agents=agents[:2], spec=spec)
    with pytest.raises(ValueError, match="relevance"):
        GroupMDP(agents=agents, spec=spec, relevance=np.eye(2))
    h = GroupMDP.homogeneous(envs.CartPole(), 4)
    assert h.spec.n_agents == 4 and h.n == 4 and h.relevance is None


def test_heterogeneous_example_online_run_matches_reference(monkeypatch):
    """The GroupMDP example's online ``obs_stats`` group (three GridWorld
    agents on a ring, hidden 64, γ 0.95) for its first 20 epochs on the
    reference's recorded episodes, its warm-up cut from 50 to 10 epochs
    so the EMA and two share steps run: returns and the estimator's
    moments and relevance at rtol 1e-6, parameters at rtol 1e-5 with
    the absolute floor of 1e-3·lr that ``test_torch_learning`` gives
    them (an AdamW step on a gradient element that cancels to ~1e-9 is
    at its steepest in the gradient; seen here: 2.1e-7 on 1 of 35,919
    elements)."""
    n = 3
    spec_kw = dict(n_agents=n, threshold=10, minibatch=5, m_pieces=16,
                   topology="ring", exchange_estimator="obs_stats",
                   relevance_ema=0.8)
    ref_env = ref_envs.GridWorld(size=5)
    ref_opt = ref_optim.adamw(3e-3)
    states = jax.vmap(lambda k: ref_a2c.init_a2c(k, ref_env, ref_opt))(
        jax.random.split(jax.random.PRNGKey(2), n))

    def gen_grads(state, key):
        def select(obs, k):
            return jax.random.categorical(
                k, ref_nets.policy_logits(state.params, obs))
        traj = ref_rollout.run_episode(ref_env, select, key)
        loss, grads = jax.value_and_grad(ref_a2c.a2c_loss)(
            state.params, traj, 0.95, entropy_coef=0.01)
        return grads, {"loss": loss,
                       "return": ref_rollout.episode_return(traj),
                       "obs_moments": ref_rollout.obs_moments(traj),
                       "actions": traj.actions}, state

    _, app, pof = ref_a2c.make_a2c_callbacks(ref_env, ref_opt, gamma=0.95)
    ex = ref_build(RefSpec(**spec_kw), kind="buffer",
                   obs_dim=ref_env.obs_dim)
    ref_ddal = RefDDAL(RefSpec(**spec_kw), gen_grads, app, pof, exchange=ex)
    ref_gs = ref_ddal.init(states)
    ref_step = jax.jit(ref_ddal.epoch_step)

    actions = {}

    def replay(logits, gen):
        a = torch.from_numpy(actions["a"][:, actions["t"]])
        actions["t"] += 1
        return a

    monkeypatch.setattr(a2c, "sample_categorical", replay)
    np_states = jax.tree.map(np.asarray, states)
    _, layout = interop.flat_params(np_states.params)
    env = envs.GridWorld(size=5)
    opt = optim.adamw(3e-3)
    spec = GroupSpec(**spec_kw)
    exchange = build_exchange(spec, obs_dim=env.obs_dim)
    assert exchange.wants_obs
    cbs = a2c.make_a2c_callbacks(env, opt, layout, gamma=0.95,
                                 track_obs=True)
    ddal = DDAL(spec, *cbs, exchange=exchange, device="cpu", layout=layout)
    gs = ddal.init(interop.a2c_state(np_states, layout))
    for epoch in range(20):
        ref_gs, ref_m = ref_step(ref_gs, jax.random.split(
            jax.random.PRNGKey(300 + epoch), n))
        actions.update(a=np.array(ref_m["actions"]).astype(np.int64), t=0)
        gs, m = ddal.epoch_step(gs, torch.Generator())
        close(m["return"], ref_m["return"], f"return {epoch}")
        for name, g, w in zip(gs.relevance._fields, gs.relevance,
                              ref_gs.relevance):
            close(g, w, f"{name} {epoch}")
        want = interop.a2c_state(jax.tree.map(np.asarray,
                                              ref_gs.agent_states), layout)
        np.testing.assert_allclose(gs.agent_states.params.numpy(),
                                   want.params.numpy(), rtol=1e-5,
                                   atol=1e-3 * 3e-3,
                                   err_msg=f"params {epoch}")
    assert not np.allclose(gs.relevance.rel.numpy(), 1.0)
