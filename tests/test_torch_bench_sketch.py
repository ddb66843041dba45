"""The relevance-sketch bench's twin (``repro_torch.benchmarks.
bench_relevance_sketch``) against the reference's ``benchmarks/
bench_relevance_sketch.py``, at small sizes on the CPU.

``bench_grads`` is numpy on both sides, so both see the same tree (held
bitwise). Held: ``gate_error``'s d-sweep max and mean within 1e-5;
``gate_equivalence`` passing on both sides; ``relevance_exchange_bytes``
equal; ``gate_time`` the same verdict and ratio on the same rows; the
flatten oracle within 1e-6 of the reference's; the memory gate's terms,
counted on ``meta`` (the sketch's peak above its inputs within the
working buffer + tail and flat in P, the exact path's within the
largest leaf + tail, the flatten oracle at the concat); and the plain
sketch bitwise the same whatever its hashing sub-block."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import bench_relevance_sketch as ref_bench  # noqa: E402
from repro.core import relevance as ref_rel  # noqa: E402
from repro.core.pod_dispatch import \
    relevance_exchange_bytes as ref_xchg  # noqa: E402
from repro_torch.benchmarks import bench_relevance_sketch as bench  # noqa: E402
from repro_torch.core import relevance as REL  # noqa: E402
from repro_torch.core.pod_dispatch import \
    relevance_exchange_bytes  # noqa: E402
from repro_torch.kernels.grad_sketch import ref as sketch_ref  # noqa: E402


def test_bench_grads_bitwise_the_reference():
    want = ref_bench.bench_grads(4, 1)
    got = bench.bench_grads(4, 1)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    single = bench.bench_grads(4, 1, single_leaf=True)
    np.testing.assert_array_equal(
        single["w"].numpy(),
        np.asarray(ref_bench.bench_grads(4, 1, single_leaf=True)["w"]))
    assert bench.tree_params(got) == ref_bench.tree_params(want)
    assert bench.max_leaf_bytes(got) == ref_bench.max_leaf_bytes(want)


def test_gate_error_sweep_matches_reference():
    want = ref_bench.gate_error(4, 1, 64)
    got = bench.gate_error(4, 1, 64)
    assert got["pass"] == want["pass"]
    assert sorted(got["sweep"]) == sorted(want["sweep"])
    for d in want["sweep"]:
        for key in ("max", "mean"):
            assert abs(got["sweep"][d][key]
                       - want["sweep"][d][key]) <= 1e-5, (d, key)


def test_gate_equivalence_passes_on_both_sides():
    want = ref_bench.gate_equivalence(4)
    got = bench.gate_equivalence(4)
    assert want["pass"] and got["pass"]
    assert got["single_leaf_bitwise"]


@pytest.mark.parametrize("n,p,d", [(8, 98_432, 256), (4, 10, 0),
                                   (16, 1 << 20, 64)])
def test_relevance_exchange_bytes_equal(n, p, d):
    assert relevance_exchange_bytes(n, p, d) == ref_xchg(n, p, d)


def test_gate_time_same_verdict_on_the_same_rows():
    rows = [{"sketch_ms": 1.0, "params": 1_000},
            {"sketch_ms": 2.2, "params": 2_000},
            {"sketch_ms": 30.0, "params": 8_000}]
    for cut in (rows, rows[:2]):
        want, got = ref_bench.gate_time(cut), bench.gate_time(cut)
        assert got["pass"] == want["pass"]
        assert got["per_param_ratio"] == want["per_param_ratio"]


def test_flatten_cosine_matches_reference():
    tree = ref_bench.bench_grads(4, 1)
    want = np.asarray(ref_rel.flatten_cosine(tree))
    got = REL.flatten_cosine(bench.bench_grads(4, 1)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_tree_sketch_cosine_matches_reference():
    tree = bench.bench_grads(4, 1)
    want = np.asarray(ref_rel.sketch_cosine(ref_bench.bench_grads(4, 1),
                                            64, jnp.int32(3)))
    got = REL.sketch_cosine(tree, 64, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _tree(n, widths):
    """A small stacked tree (leaves wider than one sketch tile and one
    narrower), so that the plain sketch's tile loop runs on ``meta``
    in well under a second."""
    rng = np.random.default_rng(len(widths))
    return {f"l{i}": torch.from_numpy(
        rng.normal(size=(n, w)).astype(np.float32))
        for i, w in enumerate(widths)}


# at d = 32 the plain sketch's working set (~0.7 MiB) sits below these
# trees' (n, P) concats, as d = 256 does from the twin's smoke scale 4
@pytest.mark.parametrize("widths", [(32_768, 6_144, 100),
                                    (65_536, 6_144, 100)])
def test_memory_terms_on_meta(widths):
    n, dim = 8, 32
    tree = _tree(n, widths)
    f = bench.memory_fields(tree, dim)
    tail = n * max(dim, n) * 4 / 2**20
    allow = max(f["max_leaf_mb"], f["working_mb"]) + tail
    concat = n * bench.tree_params(tree) * 4 / 2**20
    assert f["sketch_peak_mb"] <= allow
    assert f["exact_peak_mb"] <= allow
    assert f["sketch_peak_mb"] < concat
    assert f["exact_peak_mb"] <= f["max_leaf_mb"] + tail
    # nothing in the sketch's peak grows with P
    assert f["sketch_peak_mb"] == bench.memory_fields(
        _tree(n, (4_096 * 3, 4_096, 7)), dim)["sketch_peak_mb"]
    assert bench.peak_bytes(REL.flatten_cosine, tree) / 2**20 >= concat


def test_gate_memory_verdict(monkeypatch):
    """The gate itself, on rows whose peaks are counted on ``meta``, and
    its sanity check: the flatten oracle's peak reaches the concat."""
    n, dim = 8, 32
    trees = {1: _tree(n, (32_768, 6_144, 100)),
             2: _tree(n, (65_536, 6_144, 100))}
    monkeypatch.setattr(bench, "bench_grads",
                        lambda n_, scale, device="cpu": trees[scale])
    rows = [{"scale": s, "params": bench.tree_params(t),
             **bench.memory_fields(t, dim)} for s, t in trees.items()]
    g = bench.gate_memory(rows, n, dim)
    assert g["pass"], g
    assert g["oracle_peak_mb"] >= g["oracle_concat_mb"]
    rows[0]["sketch_peak_mb"] = g["oracle_concat_mb"]   # a regression
    assert not bench.gate_memory(rows, n, dim)["pass"]


@pytest.mark.parametrize("hash_rows", [7, 100, sketch_ref.TILE])
def test_plain_sketch_bitwise_whatever_the_hash_block(monkeypatch,
                                                      hash_rows):
    G = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 9_001)).astype(np.float32))
    want = sketch_ref.sketch_flat(G, 11, 40, offset=5)
    want_map = sketch_ref.sketch_flat(G, 11, 40, position_map=(9_101, 50,
                                                                9_001))
    monkeypatch.setattr(sketch_ref, "HASH_ROWS", hash_rows)
    assert torch.equal(sketch_ref.sketch_flat(G, 11, 40, offset=5), want)
    assert torch.equal(sketch_ref.sketch_flat(
        G, 11, 40, position_map=(9_101, 50, 9_001)), want_map)
