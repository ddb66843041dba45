"""The fault-transport bench's twin (``repro_torch.benchmarks.
bench_fault_transport``) against the reference's ``benchmarks/
bench_fault_transport.py``, at small sizes on the CPU.

The toy group's gradients draw nothing and the fault plans are numpy
draws on both sides, so the learning curves are the same computation.
Held: the fault-free curve per epoch within rtol 1e-6 of the
reference's (and the faulted one within rtol 1e-5, since its
checksums are summed in another order); the zero-rate ``faulty``
transport bitwise the default's final params; the restated gate 1, the
op sequence of ``epoch_step`` under the default spec equal to
``exchange_transport="none"``'s and different from the faulty one's;
and the port's gate 3 bounds."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import bench_fault_transport as ref_bench  # noqa: E402
from repro.configs.base import GroupSpec as RefSpec  # noqa: E402
from repro_torch.benchmarks import bench_fault_transport as bench  # noqa: E402

N, PARAMS, EPOCHS = 4, 32, 12


def _ref_specs(n):
    base_kw = dict(n_agents=n, threshold=1, minibatch=2, m_pieces=16,
                   max_delay=1)
    return {"default": RefSpec(**base_kw),
            "faulty": RefSpec(**base_kw, transport_loss=0.2,
                              transport_corrupt=0.05,
                              transport_retransmit=2, transport_jitter=1,
                              max_staleness=8, transport_decay=0.95,
                              transport_seed=0)}


def test_specs_are_the_references():
    ref_specs = _ref_specs(N)
    port = bench.specs(N)
    for name, want in ref_specs.items():
        got = port[name]
        for field in ("n_agents", "threshold", "minibatch", "m_pieces",
                      "max_delay", "transport_loss", "transport_corrupt",
                      "transport_retransmit", "transport_jitter",
                      "max_staleness", "transport_decay", "transport_seed",
                      "exchange_transport"):
            assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("name,rtol", [("default", 1e-6),
                                       ("faulty", 1e-5)])
def test_learning_curves_match_reference(name, rtol):
    want, w_ref = ref_bench.learning_curve(_ref_specs(N)[name], PARAMS,
                                           EPOCHS)
    got, w = bench.learning_curve(bench.specs(N)[name], PARAMS, EPOCHS)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=rtol,
                               atol=1e-7)


def test_zero_rate_faulty_is_bitwise_default():
    sp = bench.specs(N)
    curve_free, w_free = bench.learning_curve(sp["default"], PARAMS, EPOCHS)
    curve_zero, w_zero = bench.learning_curve(sp["zero"], PARAMS, EPOCHS)
    assert torch.equal(w_free, w_zero)
    np.testing.assert_array_equal(curve_free, curve_zero)


def test_op_sequence_identity():
    sp = bench.specs(N)
    ops_d, launch_d = bench.op_sequence(sp["default"], PARAMS)
    ops_n, launch_n = bench.op_sequence(sp["none"], PARAMS)
    assert ops_d == ops_n and launch_d == launch_n == 0
    assert len(ops_d) > 50
    # the method sees a changed program: the zero-rate faulty transport
    # stamps and checks checksums
    ops_z, _ = bench.op_sequence(sp["zero"], PARAMS)
    assert ops_z != ops_d


def test_degradation_bounds_hold():
    sp = bench.specs(8)
    free, _ = bench.learning_curve(sp["default"], 64, 20)
    fault, w = bench.learning_curve(sp["faulty"], 64, 20)
    assert np.isfinite(fault).all() and torch.isfinite(w).all()
    assert fault.sum() <= 2.0 * free.sum()
    assert fault[-1] <= max(4.0 * free[-1], 1e-5)


def test_thunks_start_from_the_same_state():
    """``epoch_thunk`` restarts from its initial state each call (the
    delay line is updated in place, so it runs on a copy)."""
    _, run = bench.epoch_thunk(bench.specs(N)["default"], PARAMS, 5)
    assert torch.equal(run(), run())
