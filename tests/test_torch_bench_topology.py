"""The topology-scaling sweep's twin (``repro_torch.benchmarks.
bench_topology_scaling``) against the reference's ``benchmarks/
bench_topology_scaling.py``, at small sizes on the CPU.

The groups are built by both modules' own helpers and run as each
package runs them; nothing is timed. Held, for n ∈ {4, 16} and every
topology of the sweep: ``flight_bytes``, the degree and
``dense_equiv_bytes`` equal exactly (the dense seed's delay line
too), and the toy params after 5 epochs within rtol 1e-6 — ``random_k``
on the numpy tables both packages build, ``dynamic_k`` with the port's
round draws replaced by the reference's ``jax.random`` ones. The
``--pods`` cells' analytic bytes equal exactly and pass the
acceptance; the hetero env plays each agent's own padded env."""
from __future__ import annotations

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import bench_topology_scaling as ref_bench  # noqa: E402
from repro.core import topology as ref_T  # noqa: E402
from repro.core.pod_dispatch import (cross_pod_bytes as ref_cross,  # noqa: E402
                                     flat_exchange_bytes as ref_flat,
                                     split_topology as ref_split)
from repro_torch.benchmarks import bench_topology_scaling as bench  # noqa: E402
from repro_torch.core import topology  # noqa: E402

TOPOLOGIES = ["full", "ring", "torus2d", "random_k", "dynamic_k",
              "hierarchical"]
PARAMS, EPOCHS, MAX_DELAY, MINIBATCH, DEGREE = 16, 5, 2, 5, 4


def ref_gossip_uniforms(seed, rnd, n):
    """The reference's round draw of ``DynamicTopology.round_table``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    return np.asarray(jax.random.uniform(key, (n, n)))


@pytest.mark.parametrize("n", [4, 16])
def test_delay_line_bytes_equal(n):
    for topo in TOPOLOGIES:
        _, rd, rgs = ref_bench._sparse_thunk(n, topo, DEGREE, PARAMS,
                                             EPOCHS, MAX_DELAY, MINIBATCH,
                                             resample_every=5)
        _, pd, pgs = bench._sparse_thunk(n, topo, DEGREE, PARAMS, EPOCHS,
                                         MAX_DELAY, MINIBATCH,
                                         resample_every=5)
        assert bench.flight_bytes(pgs.flight) == ref_bench.flight_bytes(
            rgs.flight), topo
        assert pd.static_topology.degree == rd.topology.degree, topo
        assert pd.max_delay == rd.max_delay, topo
        assert (bench.dense_equiv_bytes(n, pd.max_delay, PARAMS)
                == ref_bench.dense_equiv_bytes(n, rd.max_delay, PARAMS))
    _, rf = ref_bench._dense_seed_thunk(n, PARAMS, EPOCHS, MAX_DELAY,
                                        MINIBATCH)
    _, pf = bench._dense_seed_thunk(n, PARAMS, EPOCHS, MAX_DELAY,
                                    MINIBATCH)
    assert bench.flight_bytes(pf) == ref_bench.flight_bytes(rf)


@pytest.mark.parametrize("n", [4, 16])
def test_toy_params_after_five_epochs(monkeypatch, n):
    monkeypatch.setattr(topology, "gossip_uniforms", ref_gossip_uniforms)
    for topo in TOPOLOGIES:
        r_run, _, _ = ref_bench._sparse_thunk(n, topo, DEGREE, PARAMS,
                                              EPOCHS, MAX_DELAY, MINIBATCH,
                                              resample_every=2)
        p_run, _, _ = bench._sparse_thunk(n, topo, DEGREE, PARAMS, EPOCHS,
                                          MAX_DELAY, MINIBATCH,
                                          resample_every=2)
        want = np.asarray(r_run()[0].agent_states["w"])
        got = p_run().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=topo)
        assert np.abs(want).max() > 0, topo        # the group did learn


def test_dense_seed_params_after_five_epochs():
    r_run, _ = ref_bench._dense_seed_thunk(4, PARAMS, 6, MAX_DELAY, 2)
    p_run, _ = bench._dense_seed_thunk(4, PARAMS, 6, MAX_DELAY, 2)
    want = np.asarray(r_run()[0])
    np.testing.assert_allclose(p_run().numpy(), want, rtol=1e-6, atol=0)


def _ref_pod_bytes(pods, pod_size, n_params):
    n = pods * pod_size
    topo = ref_T.hierarchical(n, pod_size)
    edges = ref_split(topo, ref_T.hierarchical_layout(n, pod_size))
    return {"l_edges": int(np.asarray(edges.ledge).sum()),
            "cross_mb": ref_cross(edges, n_params) / 2**20,
            "flat_mb": ref_flat(topo, n_params) / 2**20}


def test_pod_rows_bytes_equal_and_accepted():
    n, params = 16, 4096
    pod_rows = []
    for pods in (1, 2, 4, 8):
        got = bench.pod_bytes(pods, n // pods, params)
        want = _ref_pod_bytes(pods, n // pods, params)
        for k, v in want.items():
            assert got[k] == v, (pods, k)
        pod_rows.append(got)
    agent_rows = [bench.pod_bytes(4, s, params) for s in (2, 4, 8)]
    for r, s in zip(agent_rows, (2, 4, 8)):
        assert r["cross_mb"] == _ref_pod_bytes(4, s, params)["cross_mb"]
    assert bench.pod_acceptance(pod_rows, agent_rows) == (True, True)


def test_pod_row_combines_agree():
    """The timed cell's two decompositions compute the same ḡ."""
    from repro_torch.core.pod_dispatch import make_pod_dispatch
    from repro_torch.core.sharded_ddal import _combine_topo
    topo = topology.hierarchical(8, 4)
    lay = topology.hierarchical_layout(8, 4)
    know = bench.pod_knowledge(8, 64)
    flat = _combine_topo(know, topo)["w"]
    pod = make_pod_dispatch(topo, lay)(know)["w"]
    np.testing.assert_allclose(pod.numpy(), flat.numpy(), rtol=1e-5,
                               atol=1e-6)
    row = bench.bench_pod_row(2, 4, 64)
    assert row["flat_ms"] > 0 and row["pod_ms"] > 0


def test_mixed_env_plays_each_agents_env():
    """Agent i of the hetero env steps CartPole (even i) or GridWorld (odd
    i), observations zero-padded to 25 and actions folded back, as the
    reference's ``_Padded`` does per agent."""
    from repro_torch.rl.envs import CartPole, GridWorld
    env = bench._Mixed((0, 1, 0, 1))
    gen = torch.Generator().manual_seed(0)
    s = env.reset(gen, 4)
    cart, grid = CartPole(), GridWorld(max_steps=100)
    cs = cart.reset(torch.Generator().manual_seed(0), 4)
    gs = grid.reset(gen, 4)
    for t in range(30):
        a = torch.tensor([t % 4, (t * 3) % 4, 3, 1])
        s, o, r, d = env.step(s, a)
        cs, co, cr, cd = cart.step(cs, a % 2)
        gs, go, gr, gd = grid.step(gs, a % 4)
        for i in (0, 2):
            assert torch.equal(o[i, :4], co[i]) and not o[i, 4:].any()
            assert r[i] == cr[i] and d[i] == cd[i]
        for i in (1, 3):
            assert torch.equal(o[i], go[i])
            assert r[i] == gr[i] and d[i] == gd[i]
        assert torch.equal(s.done, d)


def test_hetero_cell_keys_match_reference():
    row = bench.bench_hetero(4, 4, 2, 2, "grad_cos", device="cpu")
    assert set(row) == {"resample", "relevance", "cart_ret", "grid_ret",
                        "rel_within", "rel_cross"}
    assert all(np.isfinite(v) for k, v in row.items()
               if k not in ("relevance",))
