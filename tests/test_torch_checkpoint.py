"""Port parity for checkpoints of the buffer trainer's ``GroupState``:
the port's ``.npz`` files use the reference's key paths, so a file
written by either package restores in the other and training continues
as it would have.

The loops feed both trainers the same table of gradients (as in
``tests/test_torch_chaos.py``), so stores, delay lines (checksum planes
aside, which agree within 1e-6 of their absolute sums) and gossip
tables are bitwise; the learned relevance and the R it puts on each
piece at atol 2e-6 (``tests/test_torch_ddal.py``); parameters at rtol
1e-5."""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as ref_optim  # noqa: E402
from repro.checkpoint import restore as ref_restore  # noqa: E402
from repro.checkpoint import save as ref_save  # noqa: E402
from repro.configs.base import GroupSpec as RefSpec  # noqa: E402
from repro.core import DDAL as RefDDAL  # noqa: E402
from repro.rl import a2c as ref_a2c  # noqa: E402
from repro.rl import dqn as ref_dqn  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.checkpoint import npz  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.ddal import DDAL  # noqa: E402
from repro_torch.rl import a2c, dqn, envs  # noqa: E402

HIDDEN = 8
# elastic, faulty transport with staleness and decay, int8 planes
FAULTY = dict(n_agents=4, threshold=2, minibatch=2, m_pieces=6,
              topology="ring", elastic=True, transport_loss=0.2,
              transport_corrupt=0.1, transport_dup=0.1, transport_jitter=1,
              max_staleness=5, transport_decay=0.9, transport_seed=2,
              knowledge_quant_block=128)
# resampled gossip with learned relevance
DYNAMIC = dict(n_agents=5, threshold=2, minibatch=2, m_pieces=6,
               topology="random_k", degree=3, resample_every=3,
               elastic=True, relevance_mode="grad_cos",
               exchange_delay="uniform", max_delay=1)


def ref_gossip_uniforms(seed, rnd, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    return np.asarray(jax.random.uniform(key, (n, n)))


@pytest.fixture(autouse=True)
def _ref_draws(monkeypatch):
    monkeypatch.setattr(topology, "gossip_uniforms", ref_gossip_uniforms)


class _Rig:
    """Both trainers on the same A2C agents and one gradient table."""

    def __init__(self, spec_kw, epochs):
        n = spec_kw["n_agents"]
        env = ref_envs.CartPole()
        ref_opt = ref_optim.adamw(3e-3)
        states = jax.vmap(lambda k: ref_a2c.init_a2c(k, env, ref_opt,
                                                     HIDDEN))(
            jax.random.split(jax.random.PRNGKey(0), n))
        np_states = jax.tree.map(np.asarray, states)
        _, self.layout = interop.flat_params(np_states.params)
        rng = np.random.default_rng(3)
        self.table = [jax.tree.map(
            lambda x: (rng.normal(size=x.shape)
                       + rng.normal(size=x.shape[1:])).astype(np.float32),
            np_states.params) for _ in range(epochs)]
        _, app, pof = ref_a2c.make_a2c_callbacks(env, ref_opt)
        self.ref = RefDDAL(
            RefSpec(**spec_kw),
            lambda s, g: (g, {"return": s.step.astype(jnp.float32)}, s),
            app, pof)
        self.ref_step = jax.jit(self.ref.epoch_step)
        opt = optim.adamw(3e-3)
        _, p_app, p_pof = a2c.make_a2c_callbacks(envs.CartPole(), opt,
                                                 self.layout)
        self.port = DDAL(
            GroupSpec(**spec_kw),
            lambda s, g: (g, {"return": s.step.to(torch.float32)}, s),
            p_app, p_pof, device="cpu", layout=self.layout)
        self.ref_gs = self.ref.init(states)
        self.gs = self.port.init(interop.a2c_state(np_states, self.layout))
        self.qb = spec_kw.get("knowledge_quant_block", 0)

    def run_ref(self, gs, start, stop):
        for e in range(start, stop):
            if e == 5 and gs.alive is not None:
                gs = self.ref.kill(gs, jnp.asarray([False, True] + [False] *
                                                   (len(gs.alive) - 2)))
            gs, _ = self.ref_step(gs, self.table[e])
        return gs

    def run_port(self, gs, start, stop):
        for e in range(start, stop):
            if e == 5 and gs.alive is not None:
                gs = self.port.kill(gs, np.array([False, True] + [False] *
                                                 (len(gs.alive) - 2)))
            gs, _ = self.port.epoch_step(gs, interop.flat_params(
                self.table[e], layout=self.layout)[0])
        return gs

    def assert_same(self, gs, ref_gs, what):
        want = jax.tree.map(np.asarray, ref_gs)
        qb = self.qb
        assert gs.epoch == int(want.epoch)
        np.testing.assert_array_equal(gs.nbr, want.nbr)
        np.testing.assert_array_equal(gs.alive, want.alive)
        st = interop.knowledge_store(want.stores, self.layout, q_block=qb)
        fl = interop.sparse_inflight(want.flight, self.layout, q_block=qb)
        for got, ref in ((gs.stores, st), (gs.flight, fl)):
            for name in ("grads", "T", "valid", "ptr", "scale", "born"):
                if getattr(ref, name, None) is None:
                    continue
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(), getattr(ref, name).numpy(),
                    err_msg=f"{name} {what}")
            # R carries the learned relevance: its cosines reduce in
            # another order (``tests/test_torch_ddal.py``)
            np.testing.assert_allclose(got.R.numpy(), ref.R.numpy(),
                                       atol=2e-6, err_msg=f"R {what}")
        if fl.chk is not None:
            live = fl.valid.numpy()
            np.testing.assert_array_equal(gs.flight.chk.numpy()[live],
                                          fl.chk.numpy()[live])
        np.testing.assert_allclose(gs.relevance.numpy(), want.relevance,
                                   atol=2e-6)
        want_a = interop.a2c_state(want.agent_states, self.layout)
        np.testing.assert_allclose(gs.agent_states.params.numpy(),
                                   want_a.params.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"params {what}")


def _equal_states(a, b):
    assert a.epoch == b.epoch
    np.testing.assert_array_equal(a.nbr, b.nbr)
    if a.alive is None:
        assert b.alive is None
    else:
        np.testing.assert_array_equal(a.alive, b.alive)

    def eq(x, y):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, dict):
            for k in x:
                eq(x[k], y[k])
        elif hasattr(x, "_fields"):
            for u, v in zip(x, y):
                eq(u, v)

    for x, y in zip((a.agent_states, a.stores, a.flight, a.relevance),
                    (b.agent_states, b.stores, b.flight, b.relevance)):
        eq(x, y)


@pytest.mark.parametrize("kw", [FAULTY, DYNAMIC], ids=["faulty", "dynamic"])
def test_round_trip_is_bitwise_and_continues(kw, tmp_path):
    rig = _Rig(kw, 12)
    gs = rig.run_port(rig.gs, 0, 7)
    path = os.path.join(tmp_path, "group.npz")
    npz.save_group(path, gs, rig.layout, step=7)
    assert npz.restore_step(path) == 7
    back = npz.restore_group(path, rig.port.init(rig.gs.agent_states),
                             rig.layout)
    _equal_states(back, gs)
    cont = rig.run_port(back, 7, 12)
    straight = rig.run_port(gs, 7, 12)
    _equal_states(cont, straight)


def test_dqn_round_trip_and_reference_reads_it(tmp_path):
    """A DDADQN group (replay rings, target parameters, ε counters):
    the port's round trip is bitwise, and the reference restores the
    port's file into its own template with the same values."""
    n = 3
    spec = GroupSpec(n_agents=n, threshold=1, minibatch=1, m_pieces=4,
                     topology="ring")
    cfg = dqn.DQNConfig(hidden=8, capacity=32, batch=4)
    ddal, gs = dqn.make_dqn_group(envs.CartPole(), optim.adamw(1e-3), spec,
                                  torch.Generator().manual_seed(0),
                                  cfg, device="cpu")
    gs, _ = ddal.run(gs, torch.Generator().manual_seed(1), 4)
    path = os.path.join(tmp_path, "dqn.npz")
    npz.save_group(path, gs, ddal.layout)
    back = npz.restore_group(path, gs, ddal.layout)
    _equal_states(back, gs)
    _, ref_gs = ref_dqn.make_dqn_group(
        ref_envs.CartPole(), ref_optim.adamw(1e-3),
        RefSpec(n_agents=n, threshold=1, minibatch=1, m_pieces=4,
                topology="ring"),
        jax.random.PRNGKey(0), ref_dqn.DQNConfig(hidden=8, capacity=32,
                                                 batch=4))
    got = ref_restore(path, jax.eval_shape(lambda: ref_gs))
    mine = interop.group_tree(gs, ddal.layout)
    np.testing.assert_array_equal(np.asarray(got.agent_states.replay.obs),
                                  mine.agent_states.replay.obs)
    np.testing.assert_array_equal(
        np.asarray(got.agent_states.target_params["trunk"][0]["w"]),
        mine.agent_states.target_params["trunk"][0]["w"])
    assert int(got.epoch) == 4


@pytest.mark.parametrize("kw", [FAULTY, DYNAMIC], ids=["faulty", "dynamic"])
def test_reference_checkpoint_restores_in_the_port(kw, tmp_path):
    """The reference trains 7 epochs and saves; the port restores the
    file into its own state and continues 5 epochs beside the
    reference: equal after every epoch."""
    rig = _Rig(kw, 12)
    ref_gs = rig.run_ref(rig.ref_gs, 0, 7)
    path = os.path.join(tmp_path, "ref.npz")
    ref_save(path, ref_gs, step=7)
    gs = npz.restore_group(path, rig.gs, rig.layout)
    assert npz.restore_step(path) == 7
    rig.assert_same(gs, ref_gs, "restored")
    for e in range(7, 12):
        ref_gs = rig.run_ref(ref_gs, e, e + 1)
        gs = rig.run_port(gs, e, e + 1)
        rig.assert_same(gs, ref_gs, f"epoch {e}")


@pytest.mark.parametrize("kw", [FAULTY, DYNAMIC], ids=["faulty", "dynamic"])
def test_port_checkpoint_restores_in_the_reference(kw, tmp_path):
    """The other way: the port trains and saves, the reference restores
    the file into its ``eval_shape`` template and continues beside the
    port."""
    rig = _Rig(kw, 12)
    gs = rig.run_port(rig.gs, 0, 7)
    path = os.path.join(tmp_path, "port.npz")
    npz.save_group(path, gs, rig.layout, step=7)
    ref_gs = ref_restore(path, jax.eval_shape(lambda: rig.ref_gs))
    rig.assert_same(gs, ref_gs, "restored")
    for e in range(7, 12):
        ref_gs = rig.run_ref(ref_gs, e, e + 1)
        gs = rig.run_port(gs, e, e + 1)
        rig.assert_same(gs, ref_gs, f"epoch {e}")


def test_strict_and_non_strict_restore(tmp_path):
    """A pre-elastic checkpoint (no ``.alive``) into an elastic state:
    strict names the missing leaf; non-strict keeps the template's
    all-alive mask and restores the rest."""
    kw = dict(n_agents=3, threshold=1, minibatch=1, m_pieces=4,
              topology="ring")
    plain = _Rig(kw, 4)
    gs = plain.run_port(plain.gs, 0, 3)
    path = os.path.join(tmp_path, "plain.npz")
    npz.save_group(path, gs, plain.layout)
    elastic = _Rig(dict(kw, elastic=True), 4)
    with pytest.raises(ValueError, match=r"missing leaf '\.alive'"):
        npz.restore_group(path, elastic.gs, elastic.layout)
    back = npz.restore_group(path, elastic.gs, elastic.layout, strict=False)
    assert back.alive.all() and back.epoch == 3
    assert torch.equal(back.agent_states.params, gs.agent_states.params)
    assert torch.equal(back.stores.grads, gs.stores.grads)


def test_damaged_files_raise_one_value_error(tmp_path):
    rig = _Rig(FAULTY, 3)
    gs = rig.run_port(rig.gs, 0, 3)
    path = os.path.join(tmp_path, "g.npz")
    npz.save_group(path, gs, rig.layout)
    with open(path, "rb") as f:
        data = f.read()
    cut = os.path.join(tmp_path, "cut.npz")
    with open(cut, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(ValueError, match="unreadable|truncated"):
        npz.restore_group(cut, gs, rig.layout)
    # a wider group: every shape mismatch named, with both shapes
    wide = _Rig(dict(FAULTY, n_agents=5), 1)
    with pytest.raises(ValueError) as err:
        npz.restore_group(path, wide.gs, wide.layout)
    msg = str(err.value)
    assert "shape mismatch at '.stores.T': checkpoint (4, 6) vs " \
           "template (5, 6)" in msg
    assert "problems" in msg and "'.alive'" in msg
