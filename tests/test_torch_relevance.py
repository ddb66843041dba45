"""Port parity: learned relevance (``repro_torch.core.relevance``, the
``combine_relevance`` / ``relevance_matrix`` of
``repro_torch.core.weighting`` and the gradient estimators of
``repro_torch.core.exchange``) against the reference on the same
numpy inputs.

Cosines reduce one flat row where the reference reduces per leaf and
then over leaves (and, sketched, per leaf with a materialised sign
block), so they are held to atol 2e-6, the bound
``benchmarks/bench_relevance_sketch.py`` gives multi-leaf
reassociation. The elementwise maps, the EMA, the edge gathers and the
relevance matrices are the same fp32 ops in the same order: bitwise."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import GroupSpec as RefSpec  # noqa: E402
from repro.core import relevance as RREL  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.core import weighting as RW  # noqa: E402
from repro.core.exchange import build_exchange as ref_build  # noqa: E402
from repro.rl import networks as ref_nets  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import relevance as REL  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core import weighting as W  # noqa: E402
from repro_torch.core.exchange import build_exchange  # noqa: E402

COS_ATOL = 2e-6


def _grads(n, seed, hidden=16, aligned=0.0):
    """A reference-shaped gradient tree of n agents and its flat rows;
    ``aligned`` mixes a shared direction in, so cosines spread."""
    params = jax.tree.map(np.asarray, ref_nets.init_policy_value(
        jax.random.PRNGKey(0), 4, 2, hidden))
    rng = np.random.default_rng(seed)

    def leaf(x):
        common = rng.normal(size=x.shape)
        own = rng.normal(size=(n,) + x.shape)
        return (aligned * common + own).astype(np.float32)

    tree = jax.tree.map(leaf, params)
    return tree, interop.flat_params(tree)[0]


def _cos_case(n, p, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, p)).astype(np.float32)
    g[1] += 0.8 * g[0]                     # one aligned pair
    if n > 3:
        g[3] = 0.0                         # an all-zero row
    return g


@pytest.mark.parametrize("n,p", [(2, 7), (5, 300), (8, 256)])
def test_cosine_rows(n, p):
    g = _cos_case(n, p, seed=n * p)
    got = REL.cosine_rows(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(RREL.cosine_rows(
        jnp.asarray(g))), rtol=0, atol=COS_ATOL)
    assert (np.diag(got) == 1.0).all()


@pytest.mark.parametrize("aligned", [0.0, 1.5])
def test_grad_cosine_flat_row_vs_per_leaf(aligned):
    tree, flat = _grads(6, seed=3, aligned=aligned)
    got = REL.grad_cosine(flat).numpy()
    want = np.asarray(RREL.grad_cosine(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(got, want, rtol=0, atol=COS_ATOL)


@pytest.mark.parametrize("dim,rnd", [(256, 0), (256, 117), (100, 5)])
def test_sketch_cosine_flat_row_vs_per_leaf(dim, rnd):
    tree, flat = _grads(8, seed=dim + rnd, aligned=1.0)
    seed = REL.fold_seed(0, rnd)
    got = REL.sketch_cosine(flat, dim, seed).numpy()
    want = np.asarray(RREL.sketch_cosine(jax.tree.map(jnp.asarray, tree),
                                         dim, jnp.int32(seed)))
    np.testing.assert_allclose(got, want, rtol=0, atol=COS_ATOL)


def test_to_relevance_bitwise():
    cos = np.concatenate([np.linspace(-1, 1, 401),
                          [-0.999, -0.998, 0.0, 1e-8]]).astype(np.float32)
    np.testing.assert_array_equal(
        REL.to_relevance(torch.from_numpy(cos)).numpy(),
        np.asarray(RREL.to_relevance(jnp.asarray(cos))))
    np.testing.assert_array_equal(
        REL.to_relevance(torch.from_numpy(cos), 0.2).numpy(),
        np.asarray(RREL.to_relevance(jnp.asarray(cos), 0.2)))


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("decay", [0.9, 0.5, 0.0])
def test_ema_update_bitwise(decay, enabled):
    rng = np.random.default_rng(int(decay * 10))
    prev = rng.random((6, 6)).astype(np.float32)
    obs = rng.random((6, 6)).astype(np.float32)
    got = REL.ema_update(torch.from_numpy(prev), torch.from_numpy(obs),
                         decay, enabled).numpy()
    want = RREL.ema_update(jnp.asarray(prev), jnp.asarray(obs), decay,
                           jnp.asarray(enabled))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("make", [lambda m: m.ring(8), lambda m: m.star(5),
                                  lambda m: m.random_k(7, 3, seed=1)])
def test_gather_edges_and_combine_relevance_bitwise(make):
    ref_topo, topo = make(RT), make(T)
    n = topo.n_agents
    dense = np.random.default_rng(n).random((n, n)).astype(np.float32)
    got = REL.gather_edges(torch.from_numpy(dense),
                           torch.from_numpy(topo.nbr.astype(np.int64)))
    want = RREL.gather_edges(jnp.asarray(dense), jnp.asarray(ref_topo.nbr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    prior = topo.relevance
    np.testing.assert_array_equal(
        W.combine_relevance(torch.from_numpy(prior), got).numpy(),
        np.asarray(RW.combine_relevance(jnp.asarray(prior), want)))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("mode", ["uniform", "ring", "custom"])
def test_relevance_matrix_bitwise(mode, n):
    adj = (np.random.default_rng(n).random((n, n)) > 0.5).astype(np.float32)
    kw = dict(adjacency=adj) if mode == "custom" else {}
    np.testing.assert_array_equal(
        W.relevance_matrix(n, mode, **kw).numpy(),
        np.asarray(RW.relevance_matrix(n, mode, **kw)))


def test_relevance_matrix_refuses_what_the_reference_refuses():
    for kw in (dict(mode="custom"), dict(mode="learned")):
        with pytest.raises(ValueError):
            RW.relevance_matrix(3, **kw)
        with pytest.raises(ValueError):
            W.relevance_matrix(3, **kw)


@pytest.mark.parametrize("sketch_dim", [0, 256])
def test_update_relevance_rounds(sketch_dim):
    """Four rounds of the flag-dispatch reference, a warm-up round
    (``enabled=False``) among them."""
    rel_ref = RREL.init_relevance(5)
    rel = REL.init_relevance(5)
    for rnd, enabled in enumerate((False, True, True, True)):
        tree, flat = _grads(5, seed=rnd, hidden=8, aligned=0.7)
        rel_ref = RREL.update_relevance(
            rel_ref, jax.tree.map(jnp.asarray, tree), "grad_cos", 0.9,
            jnp.asarray(enabled), sketch_dim=sketch_dim, seed=11, rnd=rnd)
        rel = REL.update_relevance(rel, flat, "grad_cos", 0.9, enabled,
                                   sketch_dim=sketch_dim, seed=11, rnd=rnd)
        np.testing.assert_allclose(rel.numpy(), np.asarray(rel_ref),
                                   rtol=0, atol=COS_ATOL)
    assert REL.update_relevance(rel, flat, "uniform", 0.9) is rel


@pytest.mark.parametrize("kw,name", [
    (dict(relevance_mode="grad_cos"), "GradCosEstimator"),
    (dict(relevance_mode="grad_cos", relevance_sketch_dim=64),
     "SketchedGradCosEstimator"),
    (dict(exchange_estimator="grad_cos+sketch", relevance_sketch_dim=32,
          topology_seed=9), "SketchedGradCosEstimator"),
])
def test_estimators_observe_and_apply_relevance(kw, name):
    """The protocol's ``observe`` over warm-up and sharing rounds, and
    ``apply_relevance``: prior × gathered learned R on the ring's edge
    table (bitwise, given the same learned matrix)."""
    spec_kw = dict(n_agents=6, topology="ring", relevance_ema=0.8, **kw)
    ref_ex = ref_build(RefSpec(**spec_kw), kind="buffer")
    ex = build_exchange(GroupSpec(**spec_kw))
    assert type(ex.estimator).__name__ == name
    assert type(ref_ex.estimator).__name__ == name
    rel_ref = ref_ex.init_relevance()
    rel = ex.init_relevance("cpu")
    for rnd in range(4):
        tree, flat = _grads(6, seed=10 + rnd, hidden=8, aligned=1.0)
        rel_ref = ref_ex.observe(rel_ref, grads=jax.tree.map(jnp.asarray,
                                                             tree),
                                 rnd=rnd, enabled=rnd > 0)
        rel = ex.observe(rel, grads=flat, rnd=rnd, enabled=rnd > 0)
        np.testing.assert_allclose(rel.numpy(), np.asarray(rel_ref),
                                   rtol=0, atol=COS_ATOL)
    assert not (rel.numpy() == 1.0).all()
    learned = np.array(rel_ref)
    want = ref_ex.apply_relevance(ref_ex.static_topology, learned)
    got = ex.apply_relevance(ex.static_topology, torch.from_numpy(learned))
    np.testing.assert_array_equal(got.relevance.numpy(),
                                  np.asarray(want.relevance))
    np.testing.assert_array_equal(got.nbr, np.asarray(want.nbr))


def test_uniform_estimator_leaves_the_topology_alone():
    ex = build_exchange(GroupSpec(n_agents=4, topology="ring"))
    rel = ex.init_relevance("cpu")
    assert ex.observe(rel, grads=torch.ones(4, 3), rnd=5) is rel
    topo = ex.static_topology
    assert ex.apply_relevance(topo, rel) is topo
