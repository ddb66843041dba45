"""Port parity of the streaming trainer's pieces
(``repro_torch.core.sharded_ddal``, ``kernels.ddal_wavg.ops.
quantize_tree``, ``kernels.grad_sketch.ops.sketch_pytree``,
``core.relevance.grad_cosine`` of a tree, the exchange protocol's
streaming build) against the reference's on the same inputs, and the
streaming checkpoint both ways. Tolerances: eq. 4 results rtol 1e-6 /
atol 1e-7 (sums over agents and small matmuls in another fp32 order);
int8 planes, scales, masks and sketch signs bitwise; sketches within
1e-5·Σ|g| per row."""
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
from repro.core import relevance as RREL  # noqa: E402
from repro.core import sharded_ddal as RSD  # noqa: E402
from repro.core.exchange import build_exchange as ref_build  # noqa: E402
from repro.core.exchange import cli_options as ref_cli  # noqa: E402
from repro.kernels.ddal_wavg import ops as ref_wavg_ops  # noqa: E402
from repro.kernels.grad_sketch import ops as ref_sketch_ops  # noqa: E402
from repro.kernels.grad_sketch import ref as ref_sketch_ref  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.common.pytree import tree_leaves_with_paths  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import GroupSpec, NotPortedError  # noqa: E402
from repro_torch.core import relevance as REL  # noqa: E402
from repro_torch.core import sharded_ddal as SD  # noqa: E402
from repro_torch.core.exchange import build_exchange, cli_options  # noqa: E402
from repro_torch.kernels.ddal_wavg import ops as wavg_ops  # noqa: E402
from repro_torch.kernels.grad_sketch import ops as sketch_ops  # noqa: E402

LR = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree):
    return [x for _, x in tree_leaves_with_paths(tree)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree(got, want, what, atol=0.0, rtol=0.0):
    for g, w in zip(_leaves(got) if isinstance(got, dict) else [got],
                    jax.tree.leaves(want)):
        if atol == 0.0 and rtol == 0.0:
            np.testing.assert_array_equal(_np(g), np.asarray(w), what)
        else:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=rtol,
                                       atol=atol, err_msg=what)


def _random_know(rng, n=3, elastic=False, sketch=0):
    tree = {"a": rng.normal(size=(n, 7, 5)).astype(np.float32),
            "b": {"w": rng.normal(size=(n, 300)).astype(np.float32),
                  "c": rng.normal(size=(n,)).astype(np.float32)}}
    tree2 = jax.tree.map(lambda x: x * 0.5 + 0.1, tree)
    alive = np.array([True, False, True])[:n] if elastic else None
    return RSD.Knowledge(
        tg=tree, tsum=np.array([2.0, 3.0, 5.0], np.float32)[:n], rg=tree2,
        rsum=np.array([1.0, 2.0, 2.0], np.float32)[:n],
        sk=(rng.normal(size=(n, sketch)).astype(np.float32)
            if sketch else None), alive=alive)


def _port_know(k):
    return SD.Knowledge(
        tg=jax.tree.map(_t, k.tg), tsum=_t(k.tsum), rg=jax.tree.map(_t, k.rg),
        rsum=_t(k.rsum), sk=None if k.sk is None else _t(k.sk),
        alive=None if k.alive is None else _t(k.alive))


@pytest.mark.parametrize("uniform", [True, False])
def test_combine_global_and_dense(uniform):
    rng = np.random.default_rng(0)
    k = _random_know(rng)
    R = rng.uniform(0.1, 1.0, (3, 3)).astype(np.float32)
    want = jax.jit(lambda kk: RSD._combine(kk, jnp.asarray(R), uniform))(k)
    got = SD._combine(_port_know(k), _t(R), uniform)
    _assert_tree(got, want, "combine", rtol=1e-6, atol=1e-7)


def test_edge_sums_combine_topo_and_dropped_edges():
    from repro.core.topology import ring as ref_ring
    from repro_torch.core.topology import ring
    rng = np.random.default_rng(1)
    k = _random_know(rng)
    rtopo, ptopo = ref_ring(3), ring(3)
    rel = rng.uniform(0.2, 1.0, np.shape(rtopo.nbr)).astype(np.float32)
    rtopo = rtopo._replace(relevance=jnp.asarray(rel))
    ptopo = ptopo._replace(relevance=rel)
    pk = _port_know(k)
    tn, td, rn, rd = RSD._edge_sums(k, rtopo.nbr, rtopo.mask, rtopo.relevance)
    ptn, ptd, prn, prd = SD._edge_sums(
        pk, torch.as_tensor(np.asarray(ptopo.nbr)),
        torch.as_tensor(np.asarray(ptopo.mask)), _t(rel))
    _assert_tree(ptd, td, "tden", rtol=1e-6)
    _assert_tree(prd, rd, "rden", rtol=1e-6)
    _assert_tree(SD._finish_combine(ptn, ptd, prn, prd),
                 RSD._finish_combine(tn, td, rn, rd), "finish", rtol=1e-6,
                 atol=1e-7)
    keep = np.array([[True, False, True], [True, True, False],
                     [True, True, True]])
    want = RSD._combine_topo(k, RSD.drop_topology_edges(rtopo, keep))
    got = SD._combine_topo(pk, SD.drop_topology_edges(ptopo, keep))
    _assert_tree(got, want, "dropped edges", rtol=1e-6, atol=1e-7)


def test_mask_quantize_kill_revive_pieces():
    rng = np.random.default_rng(2)
    k = _random_know(rng, elastic=True, sketch=8)
    pk = _port_know(k)
    m = RSD.mask_knowledge(k, k.alive)
    pm = SD.mask_knowledge(pk, pk.alive)
    for name in ("tg", "rg", "tsum", "rsum", "sk"):
        _assert_tree(getattr(pm, name), getattr(m, name), name)
    q = jax.jit(lambda kk: RSD.quantize_knowledge_roundtrip(kk, 128))(k)
    pq = SD.quantize_knowledge_roundtrip(pk, 128)
    _assert_tree(pq.tg, q.tg, "round trip tg")
    _assert_tree(pq.rg, q.rg, "round trip rg")
    assert SD.mask_knowledge(pk, None) is pk
    assert SD.quantize_knowledge_roundtrip(pk, 0) is pk


@pytest.mark.parametrize("q_block", [32, 128])
def test_quantize_tree_bitwise(q_block):
    """The int8 wire format over stacked leaves, bitwise against the
    reference's compiled ``quantize_tree`` (q_block 32 is below what
    ``GroupSpec`` accepts; the function takes it)."""
    rng = np.random.default_rng(q_block)
    tree = {"w": (rng.normal(size=(3, 5, 77)) * 3).astype(np.float32),
            "z": {"b": rng.normal(size=(3, 32)).astype(np.float32),
                  "e": np.zeros((3, 40), np.float32)}}
    rq, rs = jax.jit(functools.partial(ref_wavg_ops.quantize_tree,
                                       q_block=q_block, lead=1))(tree)
    pq, ps = wavg_ops.quantize_tree(jax.tree.map(_t, tree), q_block)
    _assert_tree(pq, rq, "q")
    _assert_tree(ps, rs, "scale")
    back = jax.jit(functools.partial(ref_wavg_ops.dequantize_tree,
                                     q_block=q_block))(rq, rs)
    _assert_tree(wavg_ops.dequantize_tree(pq, ps, q_block), back, "deq")


def test_sketch_pytree_signs_and_sums():
    """Leaf order and offsets: one-hot gradients at chosen positions of
    every leaf give the reference's sign rows bitwise; a random tree's
    sketch is within the 1e-5·Σ|g| gate of the reference's."""
    n, d, seed = 2, 96, REL.fold_seed(3, 7)
    shapes = {"b": (300,), "a": (6, 9), "c": {"z": (2,), "y": (5000,)}}
    tree = jax.tree.map(lambda s: np.zeros((n,) + s, np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    leaves = jax.tree.leaves(tree)
    sizes = [x[0].size for x in leaves]
    offsets = np.cumsum([0] + sizes[:-1])
    picks = []
    for x, off, size in zip(leaves, offsets, sizes):
        p = size - 1
        x.reshape(n, -1)[0, p] = 1.0
        picks.append(off + p)
    got = sketch_ops.sketch_pytree(jax.tree.map(_t, tree), seed, d)
    want = sum(np.asarray(ref_sketch_ref.sign_block(jnp.int32(seed), q, 1, d))
               for q in picks)
    np.testing.assert_array_equal(_np(got[0]), want[0])
    np.testing.assert_array_equal(_np(got[1]), np.zeros(d, np.float32))
    rng = np.random.default_rng(5)
    tree = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                        tree)
    got = _np(sketch_ops.sketch_pytree(jax.tree.map(_t, tree), seed, d))
    want = np.asarray(ref_sketch_ops.sketch_pytree(tree, jnp.int32(seed), d,
                                                   impl="xla"))
    l1 = sum(np.abs(x).reshape(n, -1).sum(1) for x in jax.tree.leaves(tree))
    assert (np.abs(got - want) <= 1e-5 * l1[:, None]).all()


def test_grad_cosine_of_a_tree():
    rng = np.random.default_rng(6)
    tree = {"x": rng.normal(size=(4, 30)).astype(np.float32),
            "y": {"z": rng.normal(size=(4, 3, 3)).astype(np.float32)}}
    tree["x"][1] = 0.0
    tree["y"]["z"][1] = 0.0
    want = np.asarray(RREL.grad_cosine(tree))
    got = _np(REL.grad_cosine(jax.tree.map(_t, tree)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------
# configuration: what the streaming trainer accepts and refuses
# ---------------------------------------------------------------------
def test_cli_options_are_the_references():
    assert cli_options() == ref_cli()


def test_streaming_specs_construct():
    for kw in (dict(knowledge_mode="streaming"),
               dict(knowledge_mode="streaming", exchange_combiner="flat"),
               dict(exchange_combiner="flat")):
        GroupSpec(n_agents=4, **kw)
        RefSpec(n_agents=4, **kw)


@pytest.mark.parametrize("kw,kind", [
    (dict(exchange_combiner="store"), "streaming"),
    (dict(exchange_combiner="flat"), "buffer"),
    (dict(exchange_delay="uniform", max_delay=1), "streaming"),
    (dict(exchange_estimator="obs_stats"), "streaming"),
    (dict(max_staleness=4), "streaming"),
    (dict(transport_loss=0.1, transport_jitter=1), "streaming"),
    (dict(transport_loss=0.1, transport_retransmit=1), "streaming"),
])
def test_build_refuses_like_reference(kw, kind):
    spec_kw = dict(n_agents=4, topology="ring", **kw)
    with pytest.raises(ValueError):
        ref_build(RefSpec(**spec_kw), kind=kind, obs_dim=4)
    with pytest.raises(ValueError):
        build_exchange(GroupSpec(**spec_kw), kind=kind, obs_dim=4)


@pytest.mark.parametrize("kw", [
    dict(topology="hierarchical", degree=2, pods=2),
    dict(topology="hierarchical", degree=2, exchange_combiner="pod"),
])
def test_pod_dispatch_still_refused(kw):
    """The pod dispatch constructs since Slice E and builds the ``pod``
    combiner for the streaming trainer; what it still refuses is what
    the reference's refuses: a faulty transport (the dispatch cannot
    drop per-round edges), with the reference's message."""
    RefSpec(n_agents=4, **kw)
    ex = build_exchange(GroupSpec(n_agents=4, **kw), kind="streaming")
    assert ex.combiner.__qualname__.startswith("make_pod_combiner")
    faulty = dict(n_agents=4, transport_loss=0.2, **kw)
    with pytest.raises(ValueError, match="transport faults") as ref_err:
        ref_build(RefSpec(**faulty), kind="streaming")
    with pytest.raises(ValueError, match="transport faults") as port_err:
        build_exchange(GroupSpec(**faulty), kind="streaming")
    assert str(port_err.value) == str(ref_err.value)


def test_mesh_refused_and_prebuilt_exchange_checked():
    cfg = get_arch_config("llama3.2-3b").reduced()
    spec = GroupSpec(n_agents=2, knowledge_mode="streaming")
    with pytest.raises(NotPortedError, match="Slice E"):
        SD.make_group_train_step(cfg, spec, optim.adamw(LR), mesh=object())
    with pytest.raises(ValueError, match="streaming"):
        SD.make_group_train_step(cfg, spec, optim.adamw(LR),
                                 exchange=build_exchange(spec, kind="buffer"))


def test_state_init_and_checkpoint_roundtrip(tmp_path):
    """``init_train_state`` on the CPU: the carried pieces the estimator
    wants; ``save_train`` / ``restore_train`` give the same tensors, and
    the reference's ``restore`` reads the port's file."""
    from repro.checkpoint import restore as ref_restore
    from repro_torch.checkpoint import restore_train, save_train
    cfg = get_arch_config("llama3.2-3b").reduced()
    spec = GroupSpec(n_agents=2, knowledge_mode="streaming", elastic=True,
                     relevance_mode="grad_cos", relevance_sketch_dim=16)
    opt = optim.adamw(LR)
    state = SD.init_train_state(cfg, spec, opt, seed=1, device="cpu")
    assert state.know.sk.shape == (2, 16) and state.know.rel.shape == (2, 2)
    assert state.know.alive.tolist() == [True, True] and state.step == 0
    a, b = (_leaves(state.params)[0][i] for i in range(2))
    assert not torch.equal(a, b)                  # agents drawn apart
    path = str(tmp_path / "s.npz")
    save_train(path, state._replace(step=3), step=3)
    back = restore_train(path, state)
    assert back.step == 3
    for x, y in zip(_leaves(back.params), _leaves(state.params)):
        assert torch.equal(x, y)
    rcfg = ref_arch("llama3.2-3b").reduced()
    rspec = RefSpec(n_agents=2, knowledge_mode="streaming", elastic=True,
                    relevance_mode="grad_cos", relevance_sketch_dim=16)
    like = RSD.init_train_state(rcfg, rspec, ref_optim.adamw(LR),
                                jax.random.PRNGKey(0))
    got = ref_restore(path, like)
    assert int(got.step) == 3
    for x, y in zip(jax.tree.leaves(got.params), _leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(x), _np(y))
