"""Port parity for the slice as a whole: ``DDAL.epoch_step`` of the port
against the reference's on the same agents and the same gradients, and
the port's ``GroupSpec`` against the reference's.

Both trainers get deterministic gradients — an elementwise polynomial
of each agent's parameters and step count, the same fp32 ops on both
sides — so the comparison covers everything after ``gen_grads``: the
delay lines, the stores, the eq. 4 share step and the AdamW update."""
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
from repro.rl import a2c as ref_a2c  # noqa: E402
from repro.rl import envs as ref_envs  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs.base import GroupSpec, NotPortedError  # noqa: E402
from repro_torch.core.ddal import DDAL  # noqa: E402
from repro_torch.kernels.ddal_wavg import ops  # noqa: E402
from repro_torch.rl import a2c, envs  # noqa: E402

HIDDEN = 8


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


@pytest.mark.parametrize("topology,delay,max_delay", [
    ("full", "none", 0),          # aligned k-block delivery
    ("ring", "uniform", 1),       # general delivery, delayed arrivals
    ("star", "hops", 0),          # padded slots, per-edge delays
    ("random_k", "uniform", 2),   # gossip graph, two-epoch delay
])
def test_epoch_steps_match_reference(topology, delay, max_delay):
    """A warm-up epoch, then share epochs: stores, delay line and agent
    states after every epoch, rtol 1e-5."""
    kw = dict(n_agents=4, threshold=1, minibatch=1, m_pieces=6,
              topology=topology, degree=3, exchange_delay=delay,
              max_delay=max_delay)
    env = ref_envs.CartPole()
    ref_opt = ref_optim.adamw(3e-3)
    states = jax.vmap(lambda k: ref_a2c.init_a2c(k, env, ref_opt, HIDDEN))(
        jax.random.split(jax.random.PRNGKey(0), 4))
    _, app, pof = ref_a2c.make_a2c_callbacks(env, ref_opt)
    ref_ddal = RefDDAL(RefSpec(**kw), _ref_grads, app, pof)
    ref_gs = ref_ddal.init(states)
    ref_step = jax.jit(ref_ddal.epoch_step)

    np_states = jax.tree.map(np.asarray, states)
    _, layout = interop.flat_params(np_states.params)
    opt = optim.adamw(3e-3)
    _, p_app, p_pof = a2c.make_a2c_callbacks(envs.CartPole(), opt, layout)
    ddal = DDAL(GroupSpec(**kw), _port_grads, p_app, p_pof, device="cpu")
    gs = ddal.init(interop.a2c_state(np_states, layout))
    assert ddal.max_delay == ref_ddal.max_delay

    for epoch in range(5):
        ref_gs, _ = ref_step(ref_gs, jax.random.split(
            jax.random.PRNGKey(epoch), 4))
        gs, _ = ddal.epoch_step(gs, None)
        want = jax.tree.map(np.asarray, ref_gs)
        got_a = gs.agent_states
        want_a = interop.a2c_state(want.agent_states, layout)
        np.testing.assert_allclose(got_a.params.numpy(),
                                   want_a.params.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"params {epoch}")
        for key in ("m", "v"):
            np.testing.assert_allclose(
                got_a.opt_state[key].numpy(),
                want_a.opt_state[key].numpy(), rtol=1e-5, atol=1e-9)
        np.testing.assert_array_equal(got_a.step.numpy(),
                                      want_a.step.numpy())
        st = interop.knowledge_store(want.stores, layout)
        fl = interop.sparse_inflight(want.flight, layout)
        for got, ref in ((gs.stores, st), (gs.flight, fl)):
            for name in ("valid", "T", "R"):
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(), getattr(ref, name).numpy(),
                    err_msg=f"{name} {epoch}")
            np.testing.assert_allclose(got.grads.numpy(), ref.grads.numpy(),
                                       rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(gs.stores.ptr.numpy(), st.ptr.numpy())
        assert gs.epoch == int(want.epoch)


SLICE2 = dict(n_agents=8, threshold=2, minibatch=2, m_pieces=6,
              topology="ring", exchange_delay="uniform", max_delay=2,
              relevance_mode="grad_cos", relevance_ema=0.9,
              relevance_sketch_dim=256, knowledge_quant_block=128)


@pytest.mark.parametrize("kw", [
    SLICE2,
    dict(SLICE2, relevance_sketch_dim=0, topology="full", m_pieces=16),
], ids=["ring-sketch256-int8", "full-exact-int8"])
def test_learned_relevance_int8_epoch_steps_match_reference(kw):
    """The slice's spec, at a small width: two warm-up epochs, then share
    epochs (2, 4, 6; the one at 2 finds no piece yet, the delay being
    2) and sharing epochs without an update (3, 5), on gradients drawn
    from one numpy table by both sides. After every epoch: the int8
    planes, scales, T, valid and ptr of the stores and the delay line
    bitwise; the learned relevance, and the R each piece carries (the
    prior times that relevance), within atol 2e-6 (the cosines reduce
    the flat row in another order than the reference's per-leaf sums);
    parameters within rtol 1e-5 and AdamW moments within rtol 1e-5 with
    an absolute floor of 1e-6 of their largest element: the eq. 4
    weights carry the relevance's 1e-7-scale differences into ḡ, whose
    elements that cancel to near zero then differ on the scale of its
    largest terms, as in ``test_torch_learning``."""
    n, qb = kw["n_agents"], kw["knowledge_quant_block"]
    env = ref_envs.CartPole()
    ref_opt = ref_optim.adamw(3e-3)
    states = jax.vmap(lambda k: ref_a2c.init_a2c(k, env, ref_opt, HIDDEN))(
        jax.random.split(jax.random.PRNGKey(0), n))
    np_states = jax.tree.map(np.asarray, states)
    _, layout = interop.flat_params(np_states.params)
    rng = np.random.default_rng(5)
    table = [jax.tree.map(
        lambda x: (rng.normal(size=x.shape)
                   + rng.normal(size=x.shape[1:])).astype(np.float32),
        np_states.params) for _ in range(7)]

    def ref_grads(state, g):
        # vmapped per agent: the "key" handed in is the agent's gradient
        return g, {"return": state.step.astype(jnp.float32)}, state

    calls = []

    def port_grads(state, gen):
        g = interop.flat_params(table[len(calls)], layout=layout)[0]
        calls.append(1)
        return g, {"return": state.step.to(torch.float32)}, state

    _, app, pof = ref_a2c.make_a2c_callbacks(env, ref_opt)
    ref_ddal = RefDDAL(RefSpec(**kw), ref_grads, app, pof)
    ref_gs = ref_ddal.init(states)
    ref_step = jax.jit(ref_ddal.epoch_step)
    opt = optim.adamw(3e-3)
    _, p_app, p_pof = a2c.make_a2c_callbacks(envs.CartPole(), opt, layout)
    ddal = DDAL(GroupSpec(**kw), port_grads, p_app, p_pof, device="cpu",
                layout=layout)
    gs = ddal.init(interop.a2c_state(np_states, layout))
    assert gs.stores.scale.shape[-1] == layout.blocks(qb).n_blocks

    for epoch in range(7):
        ref_gs, _ = ref_step(ref_gs, jax.tree.map(jnp.asarray,
                                                  table[epoch]))
        gs, _ = ddal.epoch_step(gs, None)
        want = jax.tree.map(np.asarray, ref_gs)
        st = interop.knowledge_store(want.stores, layout, q_block=qb)
        fl = interop.sparse_inflight(want.flight, layout, q_block=qb)
        for got, ref in ((gs.stores, st), (gs.flight, fl)):
            for name in ("grads", "scale", "T", "valid"):
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(), getattr(ref, name).numpy(),
                    err_msg=f"{name} {epoch}")
            np.testing.assert_allclose(got.R.numpy(), ref.R.numpy(),
                                       rtol=0, atol=2e-6)
        np.testing.assert_array_equal(gs.stores.ptr.numpy(), st.ptr.numpy())
        np.testing.assert_allclose(gs.relevance.numpy(),
                                   interop.relevance(want.relevance).numpy(),
                                   rtol=0, atol=2e-6,
                                   err_msg=f"relevance {epoch}")
        got_a = gs.agent_states
        want_a = interop.a2c_state(want.agent_states, layout)
        np.testing.assert_allclose(got_a.params.numpy(),
                                   want_a.params.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=f"params {epoch}")
        for key in ("m", "v"):
            w = want_a.opt_state[key].numpy()
            np.testing.assert_allclose(
                got_a.opt_state[key].numpy(), w, rtol=1e-5,
                atol=1e-6 * float(np.abs(w).max()), err_msg=f"{key} {epoch}")
        np.testing.assert_array_equal(got_a.step.numpy(),
                                      want_a.step.numpy())
    # learned: off the uniform prior, inside [min_rel, 1]
    rel = gs.relevance.numpy()
    assert (rel < 1.0).any() and (rel >= 1e-3).all() and (rel <= 1.0).all()
    # epochs 0, 1 independent; 4, 6 share (epoch 2's store is empty)
    assert gs.agent_states.step.tolist() == [4] * n


def test_twenty_epoch_cpu_run_stays_finite():
    spec = GroupSpec(n_agents=2, threshold=5, minibatch=5, m_pieces=8)
    launches = ops.fused_wavg.launches
    ddal, gs = a2c.make_a2c_group(
        envs.CartPole(), optim.adamw(3e-3), spec,
        torch.Generator().manual_seed(0), device="cpu", hidden=HIDDEN)
    gs, metrics = ddal.run(gs, torch.Generator().manual_seed(1), 20)
    assert metrics["return"].shape == (20, 2)
    assert bool(torch.isfinite(metrics["return"]).all())
    assert bool(torch.isfinite(gs.agent_states.params).all())
    assert bool(gs.stores.valid.all()) and gs.epoch == 20
    # share epochs 5, 10, 15 updated the agents: 5 warm-up steps + 3
    assert gs.agent_states.step.tolist() == [8, 8]
    assert ops.fused_wavg.launches == launches     # CPU: plain version


def test_run_with_legacy_wavg_path_matches_fused():
    """``use_wavg_kernel=True`` (weights outside, plain contraction)
    trains the same group as the fused share step."""
    spec = GroupSpec(n_agents=3, threshold=2, minibatch=2, m_pieces=4,
                     topology="ring")
    out = []
    for legacy in (False, True):
        opt = optim.adamw(3e-3)
        gen = torch.Generator().manual_seed(0)
        state, layout = a2c.init_a2c(gen, 3, envs.CartPole(), opt, HIDDEN)
        _, app, pof = a2c.make_a2c_callbacks(envs.CartPole(), opt, layout)
        ddal = DDAL(spec, _port_grads, app, pof, use_wavg_kernel=legacy,
                    device="cpu")
        gs, _ = ddal.run(ddal.init(state), None, 7)
        out.append(gs.agent_states.params)
    torch.testing.assert_close(out[0], out[1], rtol=1e-6, atol=1e-7)


UNPORTED = [
    dict(elastic=True),
    dict(transport_loss=0.1), dict(transport_dup=0.1),
    dict(transport_corrupt=0.1), dict(transport_jitter=1),
    dict(transport_retransmit=1), dict(transport_decay=0.5),
    dict(max_staleness=3),
    dict(topology="random_k", degree=2, resample_every=5),
    dict(exchange_estimator="obs_stats"), dict(exchange_combiner="flat"),
    dict(exchange_schedule="dynamic", topology="random_k", degree=2,
         resample_every=1),
    dict(exchange_transport="faulty"), dict(knowledge_mode="streaming"),
    dict(topology="hierarchical", degree=2, pods=2),
]
# nothing is refused by name any more: the streaming trainer's settings
# construct since Slice D, the pod dispatch since Slice E (the buffer
# trainer ignores ``pods`` as the reference's does), and the buffer
# trainer refuses the streaming combiner as the reference's build does
STILL_UNPORTED = ()
STREAMING_ONLY = ("exchange_combiner",)


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: ",".join(kw))
def test_unported_fields_are_refused_by_name(kw):
    """The knobs that were refused before the buffer trainer's robustness
    slice now construct and run four epochs of a DDA3C group on the CPU
    (sharing from epoch 1, so every knob is exercised), ``pods`` too (the
    buffer trainer keeps its ``store`` combiner, as the reference's);
    the streaming ``flat`` combiner constructs but the buffer trainer
    refuses it with the reference's ``ValueError``."""
    spec_kw = dict(n_agents=4, **kw)
    RefSpec(**spec_kw)                       # valid for the reference
    if any(k in kw for k in STILL_UNPORTED):
        with pytest.raises(NotPortedError):
            GroupSpec(**spec_kw)
        return
    spec = GroupSpec(threshold=1, minibatch=1, m_pieces=4, **spec_kw)
    if any(k in kw for k in STREAMING_ONLY):
        with pytest.raises(ValueError, match="'store' combiner"):
            a2c.make_a2c_group(
                envs.CartPole(), optim.adamw(3e-3), spec,
                torch.Generator().manual_seed(0), device="cpu",
                hidden=HIDDEN)
        return
    ddal, gs = a2c.make_a2c_group(
        envs.CartPole(), optim.adamw(3e-3), spec,
        torch.Generator().manual_seed(0), device="cpu", hidden=HIDDEN)
    gs, metrics = ddal.run(gs, torch.Generator().manual_seed(1), 4)
    assert gs.epoch == 4 and bool(torch.isfinite(metrics["return"]).all())
    assert bool(torch.isfinite(gs.agent_states.params).all())
    assert gs.agent_states.step.tolist() == [4] * 4


INVALID = [
    dict(topology="mesh"), dict(relevance_mode="learned"),
    dict(resample_every=-1), dict(resample_every=2),
    dict(exchange_delay="exponential"),
    dict(topology="random_k", degree=4), dict(relevance_ema=1.0),
    dict(knowledge_quant_block=100), dict(transport_loss=1.5),
    dict(max_staleness=0), dict(explore_eps=2.0), dict(pods=-1),
    dict(exchange_transport="none", transport_loss=0.2),
]


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(kw))
def test_invalid_specs_raise_value_error_like_reference(kw):
    spec_kw = dict(n_agents=4, **kw)
    with pytest.raises(ValueError):
        RefSpec(**spec_kw)
    with pytest.raises(ValueError):
        GroupSpec(**spec_kw)


def test_default_spec_and_ported_choices_construct():
    for kw in (dict(), dict(exchange_delay="hops"),
               dict(exchange_delay="uniform", max_delay=2),
               dict(exchange_schedule="static", exchange_estimator="uniform",
                    exchange_combiner="store", exchange_transport="none"),
               dict(topology="torus2d"), dict(topology="star"),
               dict(knowledge_quant_block=128),
               dict(relevance_mode="grad_cos"),
               dict(relevance_mode="grad_cos", relevance_sketch_dim=256),
               dict(exchange_estimator="grad_cos"),
               dict(exchange_estimator="grad_cos+sketch",
                    relevance_sketch_dim=64)):
        assert GroupSpec(n_agents=4, **kw) == GroupSpec(n_agents=4, **kw)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    """Without ``device="cpu"`` the entry points run on the card, and
    with no card they raise rather than carry on on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    spec = GroupSpec(n_agents=2)
    with pytest.raises(RuntimeError, match="cuda"):
        a2c.make_a2c_group(envs.CartPole(), optim.adamw(1e-3), spec,
                           torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        DDAL(spec, _port_grads, None, None)
