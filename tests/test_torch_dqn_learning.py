"""Port parity for the whole DDADQN loop at the paper's width (dueling
DQN, hidden 64) with real gradients.

The test runs the reference's DDAL with the reference's own episode,
replay, loss and gradients, and takes from each epoch's keys the
draws the reference made: the initial states, the ε-greedy uniforms
and random actions, and the replay indices. The port's DDAL replays
them through its ``reset`` and its two draw hooks
(``dqn.explore_draws``, ``dqn.sample_indices``), so both trainers see
the same episodes: after every epoch the returns, ε, the replay rings,
the parameters, the target parameters and the AdamW state are held,
through warm-up, share and hold epochs, target syncs and (on short
first episodes) the near-empty buffer.
"""
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
from repro.rl import dqn as ref_dqn  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core.ddal import DDAL  # noqa: E402
from repro_torch.rl import dqn, envs  # noqa: E402

LR = 1e-3
CFG = dict(batch=16, target_period=3, eps_decay=10, capacity=1_000)


def _recording_gen_grads(env, cfg, gen_grads):
    """The reference's DQN ``gen_grads``, also returning in its metrics
    the draws it made from its key (the key splits of ``gen_grads`` and
    ``run_episode``): the initial observation, each step's uniform and
    random action, and the replay indices."""

    def recording(state, key):
        grads, metrics, new = gen_grads(state, key)
        k_ep, k_sample = jax.random.split(key)
        k_reset, k_steps = jax.random.split(k_ep)
        keys = jax.vmap(jax.random.split)(
            jax.random.split(k_steps, env.max_steps))
        metrics = dict(
            metrics,
            s0=env.obs(env.reset(k_reset)),
            u=jax.vmap(jax.random.uniform)(keys[:, 0]),
            rand=jax.vmap(lambda k: jax.random.randint(
                k, (), 0, env.n_actions))(keys[:, 1]),
            idx=jax.random.randint(k_sample, (cfg.batch,), 0,
                                   jnp.maximum(new.replay.size, 1)))
        return grads, metrics, new

    return recording


class _Draws:
    """One epoch's reference draws, fed to the port's hooks."""

    def load(self, metrics):
        self.s0 = np.array(metrics["s0"])
        self.u = np.array(metrics["u"])                      # (n, T)
        self.rand = np.array(metrics["rand"]).astype(np.int64)
        self.idx = np.array(metrics["idx"]).astype(np.int64)
        self.t = 0

    def reset_cartpole(self, gen, n):
        return envs.CartPoleState(
            *(torch.from_numpy(np.ascontiguousarray(self.s0[:, i]))
              for i in range(4)),
            torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.bool))

    def explore(self, n, n_actions, gen):
        t = self.t
        self.t += 1
        return (torch.from_numpy(self.u[:, t]),
                torch.from_numpy(self.rand[:, t]))

    def indices(self, size, batch, gen):
        return torch.from_numpy(self.idx)


SLICE2 = dict(topology="ring", exchange_delay="uniform", max_delay=2,
              relevance_mode="grad_cos", relevance_ema=0.9,
              relevance_sketch_dim=256, knowledge_quant_block=128)


@pytest.mark.parametrize("n,kw,grid,updates", [
    (2, dict(topology="full"), False, 6),
    (4, dict(topology="ring", exchange_delay="uniform", max_delay=1),
     False, 5),
    (3, dict(topology="full"), True, 6),
    (4, SLICE2, False, 5),
], ids=["n2-full", "n4-ring-delay1", "n3-full-gridworld5",
        "n4-ring-delay2-sketch256-int8"])
def test_full_dqn_loop_with_real_gradients_matches_reference(
        n, kw, grid, updates, monkeypatch):
    """Nine epochs at hidden 64: epochs 0, 1 independent; 2, 4, 6, 8
    share; 3, 5, 7 hold. Returns equal (GridWorld's sums of -0.01 within
    one rounding: they are summed in another order); ε bitwise; the
    replay rings bitwise on GridWorld, and on CartPole with the
    observations at rel 1e-6 and a 2e-6 floor (the two libraries' fp32
    sin/cos differ by 1 ulp); parameters, target parameters and AdamW
    moments within rtol 1e-5, with floors of 1e-3·lr for the parameters
    and 1e-6 of the largest element for the moments (the a2c loop's,
    for the same reasons: the loss sums the minibatch in another order,
    and AdamW's step is steepest where a gradient element is near
    zero); step counters equal.

    The configuration (batch 16, target period 3, ε anneal over 10
    epochs) makes the nine epochs cover real gradients, two target
    syncs (steps 3 and 6) and at least two share steps; the test
    asserts each. With a delay of 1 or 2 the first pieces arrive after
    the share step of epoch 2 (or 4... see ``updates``), which finds
    Σw = 0 and skips the update.

    The fourth case is the slice-2 spec (learned relevance from
    256-wide gradient sketches, int8 knowledge planes): an int8 value
    on a rounding tie can land one step apart, as in the a2c loop
    (``test_torch_learning._check_learned_int8``); such flips are
    counted and bounded, and a parameter element whose share step read
    one is held to the AdamW step bound only (2·lr per such step)."""
    from test_torch_learning import _check_learned_int8
    spec_kw = dict(n_agents=n, threshold=2, minibatch=2, m_pieces=4, **kw)
    ref_env = ref_envs.GridWorld() if grid else ref_envs.CartPole()
    env = envs.GridWorld() if grid else envs.CartPole()
    ref_cfg, cfg = ref_dqn.DQNConfig(**CFG), dqn.DQNConfig(**CFG)
    ref_opt = ref_optim.adamw(LR)
    states = jax.vmap(lambda k: ref_dqn.init_dqn(k, ref_env, ref_opt,
                                                 ref_cfg))(
        jax.random.split(jax.random.PRNGKey(0), n))
    gen_r, app_r, pof_r = ref_dqn.make_dqn_callbacks(ref_env, ref_opt,
                                                     ref_cfg)
    ref_ddal = RefDDAL(RefSpec(**spec_kw),
                       _recording_gen_grads(ref_env, ref_cfg, gen_r),
                       app_r, pof_r)
    ref_gs = ref_ddal.init(states)
    ref_step = jax.jit(ref_ddal.epoch_step)

    draws = _Draws()
    monkeypatch.setattr(dqn, "explore_draws", draws.explore)
    monkeypatch.setattr(dqn, "sample_indices", draws.indices)
    if not grid:
        class ReplayCartPole(envs.CartPole):
            def reset(self, gen, n):
                return draws.reset_cartpole(gen, n)

        env = ReplayCartPole()
    np_states = jax.tree.map(np.asarray, states)
    _, layout = interop.flat_params(np_states.params)
    assert layout.size == (10309 if grid else 8835)
    cbs = list(dqn.make_dqn_callbacks(env, optim.adamw(LR), cfg, layout))
    real = []

    def gen_grads(state, gen):
        grads, metrics, new = cbs[0](state, gen)
        real.append(float(grads.abs().max()) > 0)
        return grads, metrics, new

    ddal = DDAL(GroupSpec(**spec_kw), gen_grads, *cbs[1:], device="cpu",
                layout=layout)
    gs = ddal.init(interop.dqn_state(np_states, layout))

    qb = kw.get("knowledge_quant_block", 0)
    taint = np.zeros((n, layout.size), bool)
    tainted_updates, synced, near_empty = 0, 0, 0
    prev = gs.agent_states
    step_of_slot = np.zeros((n, cfg.capacity), np.int64)
    for epoch in range(9):
        ref_gs, ref_m = ref_step(ref_gs, jax.random.split(
            jax.random.PRNGKey(100 + epoch), n))
        draws.load(ref_m)
        gs, m = ddal.epoch_step(gs, torch.Generator())
        assert draws.t == env.max_steps
        np.testing.assert_allclose(m["return"].numpy(),
                                   np.asarray(ref_m["return"]),
                                   rtol=1e-6 if grid else 0)
        np.testing.assert_array_equal(m["epsilon"].numpy(),
                                      np.asarray(ref_m["epsilon"]))
        np.testing.assert_allclose(m["loss"].numpy(),
                                   np.asarray(ref_m["loss"]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"loss {epoch}")
        want = interop.dqn_state(jax.tree.map(np.asarray,
                                              ref_gs.agent_states), layout)
        got = gs.agent_states
        # each slot's step within its episode (live steps are a prefix)
        for i in range(n):
            p0, added = int(prev.replay.ptr[i]), int(want.replay.ptr[i]
                                                      - prev.replay.ptr[i])
            slots = (p0 + np.arange(added)) % cfg.capacity
            step_of_slot[i, slots] = np.arange(added)
        _check_replay(got.replay, want.replay, None if grid else
                      step_of_slot)
        if qb:
            flipped = _check_learned_int8(gs, ref_gs, layout, qb)
            if epoch >= 2 and epoch % 2 == 0:
                taint |= flipped
            tainted_updates += bool(taint.any()) and epoch % 2 == 0
        keep = ~taint
        for name in ("params", "target_params"):
            g, w = getattr(got, name).numpy(), getattr(want, name).numpy()
            np.testing.assert_allclose(g[keep], w[keep], rtol=1e-5,
                                       atol=1e-3 * LR,
                                       err_msg=f"{name} {epoch}")
            np.testing.assert_array_less(np.abs(g - w)[taint],
                                         2 * LR * tainted_updates
                                         + 1e-3 * LR)
        for key in ("m", "v"):
            w = want.opt_state[key].numpy()
            np.testing.assert_allclose(
                got.opt_state[key].numpy()[keep], w[keep], rtol=1e-5,
                atol=1e-6 * float(np.abs(w).max()),
                err_msg=f"{key} {epoch}")
        for name in ("step", "eps_t"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(want, name).numpy())
        np.testing.assert_array_equal(got.opt_state["count"].numpy(),
                                      want.opt_state["count"].numpy())
        # θ⁻ ← θ for exactly the agents whose update reached a multiple
        # of the target period; the others keep their θ⁻
        at_sync = (got.step != prev.step) & (got.step % cfg.target_period
                                             == 0)
        for i in range(n):
            assert torch.equal(got.target_params[i],
                               got.params[i] if at_sync[i]
                               else prev.target_params[i]), (epoch, i)
        synced += int(at_sync.sum())
        near_empty += int((got.replay.size < cfg.batch).sum())
        prev = got
    assert taint.sum() <= 20, int(taint.sum())
    assert sum(real) >= 8 and synced >= n
    print(f"agent-epochs that learned from a near-empty buffer: "
          f"{near_empty}")
    # two warm-up updates, then every share step that found a piece
    assert gs.agent_states.step.tolist() == [updates] * n
    assert updates - 2 >= 2


def _check_replay(got, want, step_of_slot):
    """The replay rings: bitwise, or (CartPole, ``step_of_slot`` the
    step within its episode of every slot) with the observations at
    rel 1e-6 and an absolute floor of max(2e-6, 1e-7·e^(0.088·t)) at
    step t. The two libraries' fp32 steps differ by about an ulp (sin /
    cos, and XLA fuses a product and a sum into one rounding where
    torch rounds twice), and the inverted pendulum amplifies a state
    difference by about e^(4.4/s · 0.02 s) = e^0.088 per step; a
    greedy episode runs up to 100 steps (seen: 3.8e-5 at step 91, where
    the floor is 3.0e-4)."""
    for name in ("actions", "rewards", "dones", "ptr", "size"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    for name in ("obs", "next_obs"):
        g, w = getattr(got, name).numpy(), getattr(want, name).numpy()
        if step_of_slot is None:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        floor = np.maximum(2e-6, 1e-7 * np.exp(0.088 * step_of_slot))
        np.testing.assert_array_less(np.abs(g - w),
                                     1e-6 * np.abs(w) + floor[..., None],
                                     err_msg=name)
