"""The eq. 4 share-step bench's twin (``repro_torch.benchmarks.
bench_wavg_kernel``) against the reference's ``benchmarks/
bench_wavg_kernel.py``, at small sizes on the CPU.

Both sides get the same draws (the reference's ``jax.random`` arrays,
handed to the port's gate functions as numpy). Held: ``gate_bytes``'
numbers equal exactly; the int8 codes and scales bitwise against the
reference's compiled ``quantize_flat``; ``gate_quant_error``'s
per-block errors within 1e-6; the port's own gates pass; the plain
int8 step bitwise the same at every column chunking; the multi-op
oracle (``tree_weighted_sum``) within 1e-6 of the reference's and
bitwise the port's share step."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import bench_wavg_kernel as ref_bench  # noqa: E402
from repro.common.pytree import tree_weighted_sum as ref_tws  # noqa: E402
from repro.kernels.ddal_wavg import ref as ref_k  # noqa: E402
from repro_torch.benchmarks import bench_wavg_kernel as bench  # noqa: E402
from repro_torch.common.pytree import tree_weighted_sum  # noqa: E402
from repro_torch.kernels.ddal_wavg import ref  # noqa: E402
from repro_torch.roofline.constants import HBM_BW  # noqa: E402


def _ref_draws(m, n, seed):
    G = np.array(jax.random.normal(jax.random.PRNGKey(seed), (m, n),
                                   jnp.float32))
    meta = tuple(np.array(x) for x in ref_bench._meta(m, seed=seed))
    return G, meta


def test_gate_bytes_equal_the_reference():
    want = ref_bench.gate_bytes()
    got = bench.gate_bytes()
    for key in ("fp32_mb", "int8_mb", "delay_line_ratio",
                "cross_pod_ratio", "pass"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("qb", bench.Q_BLOCKS)
def test_int8_codes_bitwise(qb):
    G, _ = _ref_draws(3, 20_000, 5)               # ragged last blocks
    want_q, want_s = jax.jit(ref_k.quantize_flat, static_argnums=1)(
        jnp.asarray(G), qb)
    q, s = ref.quantize_rows(torch.from_numpy(G), qb)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_quant_error_per_block_matches_reference():
    m, n = 8, 20_000
    want = ref_bench.gate_quant_error(m, n)
    G, meta = _ref_draws(m, n, 2)
    got = bench.gate_quant_error(m, n, G=G, meta=meta)
    assert got["pass"] and want["pass"]
    for qb in bench.Q_BLOCKS:
        for key in ("inf_err", "rel_l2", "inf_bound"):
            assert abs(got["per_block"][qb][key]
                       - want["per_block"][qb][key]) <= 1e-6, (qb, key)


def test_port_gates_pass_on_the_reference_draws():
    m, n = 6, 70_000
    G, meta = _ref_draws(m, n, 0)
    assert bench.gate_correctness(m, n, G=G, meta=meta)["pass"]
    G, meta = _ref_draws(m, n, 1)
    g = bench.gate_bitwise(m, n, G=G, meta=meta)
    assert g["flat_bitwise"] and g["tree_bitwise"]


def test_one_pass_peak_is_streamed():
    """The int8 plain step's counted peak above its inputs stays under ½
    of a full fp32 dequant and does not grow past one output plane plus
    a chunk's temporaries."""
    g = bench.gate_one_pass(m=8, n=1 << 20)
    assert g["pass"], g
    small = bench.plain_q_peak_bytes(8, 1 << 19)
    big = bench.plain_q_peak_bytes(8, 1 << 21)
    # the output plane grows with n, the chunk's temporaries do not
    assert big - small == 4 * ((1 << 21) - (1 << 19))


@pytest.mark.parametrize("chunk", [1000, 4096, 1 << 18])
def test_int8_plain_step_bitwise_at_every_chunking(monkeypatch, chunk):
    rng = np.random.default_rng(chunk)
    n, m, p = 3, 5, 10_007
    G = torch.from_numpy(rng.normal(size=(n, m, p)).astype(np.float32))
    T = torch.from_numpy(np.abs(rng.normal(size=(n, m))).astype(np.float32))
    R = torch.from_numpy(np.abs(rng.normal(size=(n, m))).astype(np.float32))
    valid = torch.from_numpy(rng.random((n, m)) > 0.3)
    blocks = bench._single_leaf(p, 128)
    Q, S = ref.quantize_flat(G, blocks)
    want = ref.fused_wavg_q(Q, S, T, R, valid, blocks)
    monkeypatch.setattr(ref, "Q_CHUNK", chunk)
    got = ref.fused_wavg_q(Q, S, T, R, valid, blocks)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tree_weighted_sum_against_reference_and_share_step():
    m, n = 7, 3_000
    G, (T, R, valid) = _ref_draws(m, n, 3)
    tree = {"a": G[:, :2_000].reshape(m, 40, 50), "b": G[:, 2_000:]}
    w = np.array(ref_bench.eq4_weights(jnp.asarray(T), jnp.asarray(R),
                                         jnp.asarray(valid)))
    want = ref_tws(jax.tree.map(jnp.asarray, tree), jnp.asarray(w))
    got = tree_weighted_sum({k: torch.from_numpy(v) for k, v in
                             tree.items()}, torch.from_numpy(w))
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    flat = tree_weighted_sum(torch.from_numpy(G), torch.from_numpy(w))
    assert torch.equal(flat, ref.wavg(torch.from_numpy(G)[None],
                                      torch.from_numpy(w)[None])[0])


def test_bounds_and_rows_are_the_h100_terms(monkeypatch):
    monkeypatch.setattr(bench, "SMOKE_SIZES", [(4, 10_000), (8, 20_000)])
    rows = bench.sweep_rows(True, "cpu")
    for r in rows:
        m, n = r["m"], r["n_params"]
        assert r["h100_bound_fused_us"] == pytest.approx(
            (4.0 * n * (m + 1) + 12.0 * m) / HBM_BW * 1e6)
        assert r["h100_bound_unfused_us"] == pytest.approx(
            4.0 * n * 2 * m / HBM_BW * 1e6)
        assert "host_plain_fused_ms" in r and not any(
            k.startswith(("v5e", "card")) for k in r)
    rec = bench.roofline_record(8, 20_000, "cpu")
    assert rec["mesh"] == "cpu" and "host_plain" in rec
    assert rec["hlo_bytes"] > 0 and rec["dominant"] == "memory"
