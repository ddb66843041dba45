"""The gate benches' card-only gates, on the card: one kernel launch per
share step, the int8 share step's and the sketch's
``torch.cuda.max_memory_allocated`` above their inputs against the
restated bounds, the fault bench's launch counts beside its op
sequence, and the ablation cells' share-step launches. Every test here
needs a CUDA card and skips without one.

This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_bench_gpu.py
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.benchmarks import ablation_ddal  # noqa: E402
from repro_torch.benchmarks import bench_fault_transport as fault  # noqa: E402
from repro_torch.benchmarks import bench_relevance_sketch as sketch  # noqa: E402
from repro_torch.benchmarks import bench_wavg_kernel as wavg  # noqa: E402
from repro_torch.core import relevance as REL  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(8, 1 << 20), (4, 1_000_001)])
def test_one_launch_per_share_step_and_streaming_peak(m, n):
    g = wavg.gate_one_pass(m, n, device=_card())
    assert g["launches_fp32"] == 1 and g["launches_int8"] == 1
    assert g["card_quant_peak_mb"] <= 0.5 * g["full_dequant_mb"]
    assert g["pass"]


@pytest.mark.gpu
def test_kernels_bitwise_their_plain_versions_and_the_oracle():
    dev = _card()
    c = wavg.gate_correctness(6, 70_001, device=dev)
    assert c["pass"] and c["kernel_vs_plain_bitwise"]
    b = wavg.gate_bitwise(6, 70_001, device=dev)
    assert b["pass"] and b["kernel_bitwise"]
    q = wavg.gate_quant_error(8, 100_003, device=dev)
    assert q["pass"]


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [4, 8, 16])
def test_sketch_peak_within_the_restated_allowance(scale):
    dev = _card()
    n, dim = 8, 256
    tree = sketch.bench_grads(n, scale, device=dev)
    f = sketch.memory_fields(tree, dim)
    tail = n * max(dim, n) * 4 / 2**20
    allow = max(f["max_leaf_mb"], f["working_mb"]) + tail
    assert f["sketch_peak_mb"] <= allow
    assert f["exact_peak_mb"] <= allow
    assert f["sketch_peak_mb"] < n * sketch.tree_params(tree) * 4 / 2**20
    assert sketch.peak_bytes(REL.flatten_cosine, tree) >= (
        n * sketch.tree_params(tree) * 4)


@pytest.mark.gpu
def test_sketch_one_launch_per_leaf():
    from repro_torch.kernels.grad_sketch import ops
    tree = sketch.bench_grads(8, 4, device=_card())
    before = ops.sketch_flat.launches
    REL.sketch_cosine(tree, 256, 0)
    assert ops.sketch_flat.launches - before == len(tree)


@pytest.mark.gpu
def test_fault_free_op_sequence_and_launches_on_the_card():
    dev = _card()
    sp = fault.specs(8)
    ops_d, launch_d = fault.op_sequence(sp["default"], 256, dev)
    ops_n, launch_n = fault.op_sequence(sp["none"], 256, dev)
    assert ops_d == ops_n
    assert launch_d == launch_n == 1          # one share step in 4 epochs


@pytest.mark.gpu
def test_ablation_cell_launches_one_kernel_per_share_step():
    dev = _card()
    name, spec, delay = ablation_ddal.cells(500)[2]
    mean, std, launches, heard, _ = ablation_ddal._run(
        spec, delay=delay, epochs=500, device=dev)
    # sharing from epoch 200, cadence 100: share steps at 200, 300 and
    # 400; the other agent's pieces of 200..250 arrive at 350..400, by
    # the step at 400
    assert launches == 3
    assert heard == 51
