"""Port parity: the streaming DDAL trainer (``repro_torch.core.
sharded_ddal``) against the reference's ``make_group_train_step``, at
``.reduced()`` llama3.2-3b and mamba2-780m, fp32 compute, 4 agents,
seven exchange configurations (``CASES``), split over this file
(llama: full, grad_cos, ring, int8), ``test_torch_streaming_faults.py``
(llama: sketch, elastic, faulty) and ``test_torch_streaming_ssm*.py``
(mamba) so that each file stays short; threshold 2
and minibatch 2: two warm-up steps, share steps 2 and 4, an
accumulation step 3 between them. Both sides start from the
reference's initial state (``interop.train_state``) and read the
reference's ``make_group_batch``.

Each exchange configuration runs two port trainers beside the
reference's:

* **A, the same gradients.** The reference's step runs with a
  ``loss_fn`` whose value is the reference model's loss and whose
  gradient is exactly the reference model's ``jax.grad`` at the
  reference's parameters (``loss + (⟨p, g⟩ − ⟨sg(p), g⟩)``, computed
  by a jitted ``vmap(value_and_grad(model.loss))`` beside the step);
  the port's step gets the same loss and gradients through the same
  construction in torch. So everything after the gradient is compared:
  losses, window sums (tg, rg, tsum, rsum), the alive mask and the
  step flags bitwise; the int8 planes of the window bitwise; the window
  sketch within 1e-5 of the window's Σ|g| per row; the learned
  relevance within 1e-6; parameters within 1e-6 (absolute, parameters
  are O(1); the eq. 4 sums and AdamW run in another fp32 order).
* **B, the port's own model** (every case but the sketched one, whose
  plain CPU sketch of a second gradient stream would double the file's
  time; A holds its sketch). The port's loss and autograd gradient:
  losses within rtol 1e-5 / atol 1e-5 of the reference's; parameters
  within 2e-4 absolute (0.2·lr) but for at most 1e-4 of the elements,
  and every element within 2·lr per update applied so far. AdamW's
  first steps normalise g by |g| + eps, so an element whose gradient is
  near eps moves by up to lr on an ulp-level gradient difference.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import optim as ref_optim  # noqa: E402
from repro.configs import get_arch_config as ref_arch  # noqa: E402
from repro.configs.base import GroupSpec as RefSpec  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.core import sharded_ddal as RSD  # noqa: E402
from repro.core.exchange import build_exchange as ref_build  # noqa: E402
from repro.data import StreamSpec as RefStream  # noqa: E402
from repro.data import make_group_batch as ref_batch  # noqa: E402
from repro.kernels.ddal_wavg import ops as ref_wavg_ops  # noqa: E402
from repro.models import get_model as ref_model  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import sharded_ddal as SD  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402
from repro_torch.kernels.ddal_wavg import ops as wavg_ops  # noqa: E402

N, STEPS, LR = 4, 5, 1e-3
SHAPE = RefShape("parity", 32, 2, "train")
CASES = {
    "full_uniform": dict(),
    "grad_cos": dict(relevance_mode="grad_cos"),
    "grad_cos_sketch": dict(relevance_mode="grad_cos",
                            relevance_sketch_dim=64),
    "ring": dict(topology="ring"),
    "int8": dict(topology="ring", knowledge_quant_block=128),
    "elastic": dict(topology="ring", elastic=True, relevance_mode="grad_cos"),
    "faulty": dict(topology="ring", transport_loss=0.3,
                   transport_corrupt=0.2, relevance_mode="grad_cos"),
}
KILL_AT, REVIVE_AT, VICTIM = 3, 4, 2     # elastic: before these steps


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree):
    return [x for _, x in tree_leaves_with_paths(tree)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(cfg, jitted per-agent value_and_grad of the model loss, initial
    params and AdamW state, the batches), shared by every case."""
    cfg = ref_arch(arch).reduced()
    model = ref_model(cfg)
    grad_fn = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: model.loss(cfg, p, b))))
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    params = jax.jit(jax.vmap(lambda k: model.init(cfg, k)))(keys)
    opt = ref_optim.adamw(LR)
    opt_state = jax.vmap(opt.init)(params)
    make = jax.jit(functools.partial(ref_batch, cfg, SHAPE, RefStream(seed=0),
                                     N))
    batches = [make(t) for t in range(STEPS)]
    return cfg, grad_fn, params, opt_state, batches


def _ref_linear(p, feed):
    def dot(a):
        return sum(jnp.vdot(x, y) for x, y in
                   zip(jax.tree.leaves(a), jax.tree.leaves(feed["g"])))
    return feed["loss"] + (dot(p) - dot(jax.lax.stop_gradient(p)))


def _port_linear(p, feed):
    pl, gl = _leaves(p), _leaves(feed["g"])
    a = sum((x * y).sum() for x, y in zip(pl, gl))
    b = sum((x.detach() * y).sum() for x, y in zip(pl, gl))
    return feed["loss"] + (a - b)


def _assert_tree(got, want, what, atol=0.0, rtol=0.0):
    for g, w in zip(_leaves(got) if isinstance(got, dict) else [got],
                    jax.tree.leaves(want)):
        if atol == 0.0 and rtol == 0.0:
            np.testing.assert_array_equal(_np(g), np.asarray(w), what)
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=rtol,
                                       atol=atol, err_msg=what)


def _assert_loose(got, want, what, bound):
    """Within 2e-4 but for ≤ 1e-4 of the elements, all within ``bound``."""
    over = total = 0
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        d = np.abs(_np(g) - np.asarray(w))
        assert d.max() <= bound, (what, float(d.max()), bound)
        over += int((d > 2e-4).sum())
        total += d.size
    assert over <= 1e-4 * total, (what, over, total)


def run_parity(arch: str, case: str):
    kw = CASES[case]
    cfg, grad_fn, params, opt_state, batches = _reference(arch)
    pcfg = get_arch_config(arch).reduced()
    base = dict(n_agents=N, threshold=2, minibatch=2,
                knowledge_mode="streaming", **kw)
    rspec, pspec = RefSpec(**base), GroupSpec(**base)
    rex = ref_build(rspec, kind="streaming")
    alive = jnp.ones((N,), bool) if rspec.elastic else None
    rstate = RSD.TrainState(
        params=params, opt_state=opt_state,
        know=RSD.init_knowledge(params, rel=rex.streaming_rel_init(),
                                sketch_dim=rex.sketch_dim, alive=alive),
        step=jnp.zeros((), jnp.int32))
    ref_step = jax.jit(RSD.make_group_train_step(
        cfg, rspec, ref_optim.adamw(LR), loss_fn=_ref_linear))
    a = interop.train_state(jax.tree.map(np.asarray, rstate))
    b = interop.train_state(jax.tree.map(np.asarray, rstate))
    opt = optim.adamw(LR)
    step_a = SD.make_group_train_step(pcfg, pspec, opt, loss_fn=_port_linear)
    step_b = SD.make_group_train_step(pcfg, pspec, opt)
    pex = build_exchange(pspec, kind="streaming")
    own = rex.sketch_dim == 0          # run B beside A
    if rex.transport is not None:
        for t in (2, 4):
            nbr = np.asarray(rex.schedule.base.nbr)
            np.testing.assert_array_equal(
                pex.transport.deliver_mask(t, nbr),
                np.asarray(rex.transport.deliver_mask(t, jnp.asarray(nbr))))
    l1 = np.zeros((N,))
    saved = None
    for t in range(STEPS):
        if rspec.elastic and t == KILL_AT:
            dead = np.arange(N) == VICTIM
            saved = (rstate, SD.clone_state(a), SD.clone_state(b))
            rstate = RSD.kill_agents(rstate, jnp.asarray(dead))
            a = SD.kill_agents(a, torch.from_numpy(dead))
            b = SD.kill_agents(b, torch.from_numpy(dead))
            l1[VICTIM] = 0.0
        if rspec.elastic and t == REVIVE_AT:
            back = np.arange(N) == VICTIM
            rstate = RSD.revive_agents(rstate, jnp.asarray(back), saved[0])
            a = SD.revive_agents(a, torch.from_numpy(back), saved[1])
            b = SD.revive_agents(b, torch.from_numpy(back), saved[2])
        batch = batches[t]
        loss, g = grad_fn(rstate.params, batch)
        if t >= 2:
            live = np.ones(N) if not rspec.elastic else np.asarray(
                rstate.know.alive, np.float64)
            l1 += live * sum(np.abs(np.asarray(x, np.float64)).reshape(
                N, -1).sum(1) for x in jax.tree.leaves(g))
        rstate, rm = ref_step(rstate, {"loss": loss, "g": g})
        a, am = step_a(a, {"loss": _t(loss), "g": jax.tree.map(_t, g)})
        what = f"{arch} {case} step {t}"
        assert am["shared"] == int(rm["shared"]), what
        assert a.step == int(rstate.step) == t + 1
        np.testing.assert_array_equal(_np(am["loss"]), np.asarray(rm["loss"]))
        if own:
            b, bm = step_b(b, {k: _t(v) for k, v in batch.items()})
            assert bm["shared"] == am["shared"] and b.step == a.step, what
            np.testing.assert_allclose(_np(bm["loss"]), np.asarray(loss),
                                       rtol=1e-5, atol=1e-5, err_msg=what)
        rk, ak = rstate.know, a.know
        for name in ("tg", "rg", "tsum", "rsum"):
            _assert_tree(getattr(ak, name), getattr(rk, name),
                         f"{what}: {name}")
        if rk.alive is not None:
            np.testing.assert_array_equal(_np(ak.alive), np.asarray(rk.alive))
        if rk.sk is not None:
            diff = np.abs(_np(ak.sk) - np.asarray(rk.sk))
            assert (diff <= 1e-5 * l1[:, None] + 1e-12).all(), what
        if rk.rel is not None:
            _assert_tree(ak.rel, rk.rel, f"{what}: rel", atol=1e-6)
        if rspec.knowledge_quant_block and int(rm["shared"]) == 0 and t > 2:
            qb = rspec.knowledge_quant_block
            quant = jax.jit(functools.partial(ref_wavg_ops.quantize_tree,
                                              q_block=qb, lead=1))
            for name in ("tg", "rg"):
                rq, rs = quant(getattr(rk, name))
                pq, ps = wavg_ops.quantize_tree(getattr(ak, name), qb)
                _assert_tree(pq, rq, f"{what}: int8 {name}")
                _assert_tree(ps, rs, f"{what}: scales {name}")
        _assert_tree(a.params, rstate.params, f"{what}: params A", atol=1e-6)
        if own:
            updates = min(t + 1, 2) + (t >= 2) + (t >= 4)
            _assert_loose(b.params, rstate.params, f"{what}: params B",
                          2 * LR * updates)
        if int(rm["shared"]):
            l1[:] = 0.0
    _assert_tree(a.opt_state["count"], rstate.opt_state["count"], "count")
    # the moments carry the clip factor 1 / ‖g‖: XLA's fp32 sum of an
    # agent's squared gradient is 3e-4 off its fp64 value at this size
    # (llama: 5.100441 against 5.1019259), torch's within 1e-6, so m and
    # v agree to 1e-3 of their leaf's largest entry, while AdamW's ratio
    # m / √v cancels the factor
    for name in ("m", "v"):
        for g, w in zip(_leaves(a.opt_state[name]),
                        jax.tree.leaves(rstate.opt_state[name])):
            w = np.asarray(w)
            np.testing.assert_allclose(_np(g), w, rtol=0,
                                       atol=1e-3 * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("case", ["full_uniform", "grad_cos", "ring",
                                  "int8"])
def test_train_steps_match_reference_llama(case):
    run_parity("llama3.2-3b", case)
