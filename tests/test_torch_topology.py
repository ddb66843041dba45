"""Port parity: the static topology tables are built by the same numpy
code on both sides, so they must be bitwise-equal
(``repro_torch.core.topology`` against ``repro.core.topology``)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs.base import GroupSpec as RefSpec  # noqa: E402
from repro.core import topology as R  # noqa: E402
from repro_torch.configs.base import GroupSpec  # noqa: E402
from repro_torch.core import topology as P  # noqa: E402


def _assert_same(port, ref):
    for name in ("nbr", "mask", "delay", "relevance"):
        a = np.asarray(getattr(port, name))
        b = np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


CONSTRUCTORS = [
    ("full", lambda m: m.full(5)),
    ("full1", lambda m: m.full(1)),
    ("ring", lambda m: m.ring(8)),
    ("ring2", lambda m: m.ring(2)),
    ("torus2d", lambda m: m.torus2d(3, 4)),
    ("star", lambda m: m.star(6, hub=2)),
    ("random_k", lambda m: m.random_k(10, 4, seed=7)),
    ("hierarchical", lambda m: m.hierarchical(10, pod_size=4)),
]


@pytest.mark.parametrize("name,make", CONSTRUCTORS, ids=[c[0] for c in
                                                         CONSTRUCTORS])
def test_constructor_tables_bitwise(name, make):
    _assert_same(make(P), make(R))


@pytest.mark.parametrize("name,make", CONSTRUCTORS[2:], ids=[
    c[0] for c in CONSTRUCTORS[2:]])
def test_hops_and_hop_delays_bitwise(name, make):
    port, ref = make(P), make(R)
    np.testing.assert_array_equal(P.hop_distances(port),
                                  R.hop_distances(ref))
    _assert_same(P.delay_from_hops(port, 2), R.delay_from_hops(ref, 2))
    _assert_same(P.delay_from_hops(P.full(port.n_agents), 1, graph=port),
                 R.delay_from_hops(R.full(ref.n_agents), 1, graph=ref))
    assert port.max_delay == ref.max_delay
    assert port.n_edges == ref.n_edges and port.degree == ref.degree


def test_annotations_bitwise():
    rng = np.random.default_rng(0)
    n = 6
    dense_d = rng.integers(0, 4, (n, n)).astype(np.int32)
    dense_r = rng.random((n, n)).astype(np.float32)
    for make in (lambda m: m.ring(n), lambda m: m.star(n)):
        port, ref = make(P), make(R)
        _assert_same(port.with_delay(dense_d), ref.with_delay(dense_d))
        _assert_same(port.with_delay(3), ref.with_delay(3))
        _assert_same(port.with_relevance(dense_r),
                     ref.with_relevance(dense_r))
        k = port.degree
        per_edge = rng.random((n, k)).astype(np.float32)
        _assert_same(port.with_relevance(per_edge, per_edge=True),
                     ref.with_relevance(per_edge, per_edge=True))


def test_disconnected_graph_raises():
    star = P.star(4)._replace(mask=np.eye(4, 4, dtype=bool))
    with pytest.raises(ValueError, match="not strongly connected"):
        P.hop_distances(star)


def test_duplicate_neighbor_raises():
    with pytest.raises(ValueError, match="duplicate in-neighbor"):
        P._from_neighbor_lists([[0, 0], [1]])


@pytest.mark.parametrize("topology,n,degree", [
    ("full", 4, 4), ("ring", 7, 4), ("torus2d", 12, 4), ("star", 5, 4),
    ("random_k", 9, 3), ("hierarchical", 8, 4)])
def test_make_topology_from_spec_bitwise(topology, n, degree):
    kw = dict(n_agents=n, topology=topology, degree=degree,
              topology_seed=3)
    _assert_same(P.make_topology(GroupSpec(**kw)),
                 R.make_topology(RefSpec(**kw)))
    d = np.arange(n * n, dtype=np.int32).reshape(n, n) % 3
    _assert_same(P.make_topology(GroupSpec(**kw), delay=d),
                 R.make_topology(RefSpec(**kw), delay=d))
