"""Port parity: the functional optimisers and schedules
(``repro_torch.optim`` against ``repro.optim``) on A2C-shaped params."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as ref_optim  # noqa: E402
from repro.rl import networks as ref_nets  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim  # noqa: E402

N, HIDDEN = 3, 8


def _stacked_tree(seed, scale):
    """An (N, ...) A2C-shaped pytree of seeded numpy values."""
    shapes = jax.vmap(lambda k: ref_nets.init_policy_value(
        k, 4, 2, HIDDEN))(jax.random.split(jax.random.PRNGKey(0), N))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32),
        shapes)


def _case():
    params = _stacked_tree(1, 0.5)
    # rows 0 and 2 far above the clip norm of 1, row 1 below it
    grads = _stacked_tree(2, 1.0)
    grads = jax.tree.map(
        lambda g: g * np.array([5.0, 1e-3, 0.7], np.float32).reshape(
            (N,) + (1,) * (g.ndim - 1)), grads)
    return params, grads


def _ref_update(opt, grads, state, params, step):
    return jax.vmap(opt.update)(
        jax.tree.map(jnp.asarray, grads), state,
        jax.tree.map(jnp.asarray, params), jnp.asarray(step))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_one_update_per_agent_clipping(weight_decay):
    """One AdamW step from a warm state (count 4, nonzero moments), with
    the norm clip taken per agent: rtol 1e-6."""
    params, grads = _case()
    m0 = _stacked_tree(3, 0.1)
    v0 = jax.tree.map(np.abs, _stacked_tree(4, 0.1))
    state = {"m": m0, "v": v0, "count": np.full((N,), 4, np.int32)}
    step = np.arange(N, dtype=np.int32) + 4
    ref = ref_optim.adamw(3e-3, weight_decay=weight_decay)
    want_p, want_s = _ref_update(ref, grads, jax.tree.map(
        jnp.asarray, state), params, step)

    flat_p, layout = interop.flat_params(params)
    flat_g, _ = interop.flat_params(grads, layout=layout)
    port_state = interop.adamw_state(state, layout)
    port = optim.adamw(3e-3, weight_decay=weight_decay)
    got_p, got_s = port.update(flat_g, port_state, flat_p,
                               torch.from_numpy(step))

    np.testing.assert_allclose(
        got_p.numpy(), interop.flat_params(want_p, layout=layout)[0].numpy(),
        rtol=1e-6, atol=1e-7)
    # atol: b1·m + (1-b1)·g cancels where the two terms nearly meet, so
    # a 1-ulp difference in the clipped g (its norm is summed in another
    # order) shows up as ~1 ulp of the terms (|m| ~ 0.1 → 1e-8), not of
    # the small result
    for key in ("m", "v"):
        np.testing.assert_allclose(
            got_s[key].numpy(),
            interop.flat_params(want_s[key], layout=layout)[0].numpy(),
            rtol=1e-6, atol=1e-8)
    np.testing.assert_array_equal(got_s["count"].numpy(),
                                  np.asarray(want_s["count"]))


def test_clip_is_per_agent_not_global():
    """A row below the clip norm is left alone even when another row is
    far above it — the fault a clip over the whole (n, P) stack makes."""
    _, grads = _case()
    flat, _ = interop.flat_params(grads)
    clipped, norm = optim.optimizers.global_norm_clip(flat, 1.0)
    assert norm[0] > 1.0 and norm[1] < 1.0
    np.testing.assert_array_equal(clipped[1].numpy(), flat[1].numpy())
    np.testing.assert_allclose(
        torch.linalg.vector_norm(clipped[0]).item(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name,kw", [("sgd", {"clip": 1.0}),
                                     ("sgd", {}),
                                     ("momentum", {"clip": 1.0})])
def test_sgd_momentum_one_update(name, kw):
    params, grads = _case()
    step = np.zeros((N,), np.int32)
    ref = ref_optim.make_optimizer(name, 0.05, **kw)
    state = jax.vmap(ref.init)(jax.tree.map(jnp.asarray, params))
    want_p, _ = _ref_update(ref, grads, state, params, step)
    flat_p, layout = interop.flat_params(params)
    port = optim.make_optimizer(name, 0.05, **kw)
    got_p, _ = port.update(interop.flat_params(grads, layout=layout)[0],
                           port.init(flat_p), flat_p,
                           torch.from_numpy(step))
    np.testing.assert_allclose(
        got_p.numpy(), interop.flat_params(want_p, layout=layout)[0].numpy(),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("make", [
    lambda m: m.constant_schedule(3e-3),
    lambda m: m.cosine_schedule(1e-2, 100, floor=1e-4),
    lambda m: m.warmup_cosine(1e-2, 10, 100, floor=1e-4),
])
def test_schedules(make):
    steps = np.array([0, 1, 5, 10, 37, 99, 100, 250], np.int32)
    want = np.array([np.asarray(make(ref_optim)(jnp.int32(s)))
                     for s in steps])
    got = make(optim)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_with_schedule_per_agent_lr():
    """A schedule gives every agent row its own learning rate."""
    params, grads = _case()
    step = np.array([0, 10, 60], np.int32)
    sched = (ref_optim.warmup_cosine(1e-2, 10, 100),
             optim.warmup_cosine(1e-2, 10, 100))
    ref = ref_optim.adamw(sched[0])
    state = jax.vmap(ref.init)(jax.tree.map(jnp.asarray, params))
    want_p, _ = _ref_update(ref, grads, state, params, step)
    flat_p, layout = interop.flat_params(params)
    port = optim.adamw(sched[1])
    got_p, _ = port.update(interop.flat_params(grads, layout=layout)[0],
                           port.init(flat_p), flat_p,
                           torch.from_numpy(step))
    np.testing.assert_allclose(
        got_p.numpy(), interop.flat_params(want_p, layout=layout)[0].numpy(),
        rtol=1e-6, atol=1e-7)
