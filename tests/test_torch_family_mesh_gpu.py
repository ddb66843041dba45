"""The SSD intra-chunk CUDA kernel at a model rank's heads: on a
``(data, model)`` mesh of m ranks a Mamba2 layer runs H/m of its SSD
heads, so the kernel takes mamba2-780m's prefill at 24 heads (m = 2 of
48) and zamba2-7b's at 56 (m = 2 of 112), in bf16 (the tensor-core
kernel) and fp32 (the CUDA-core kernel), held against its plain version.
Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_family_mesh_gpu.py

Tolerance: each element within 1e-5 · Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp|,
the sum of the absolute values of the terms it adds (the plain version
on |x|, |B|, |C|), as ``tests/test_torch_ssd_scan_gpu.py`` holds the
kernel; two launches bitwise equal.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402

GATE = 1e-5
# (label, (b, nc, l, h, p, n, g)): a model rank's heads of each prefill
RANK_HEADS = {
    "mamba2-780m, 24 of 48 heads": (2, 4, 256, 24, 64, 128, 1),
    "zamba2-7b, 56 of 112 heads": (2, 4, 256, 56, 64, 64, 1),
}


def _inputs(seed, b, nc, l, h, p, n, g, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xc = normal(b, nc, l, h, p)
    dtc = torch.nn.functional.softplus(normal(b, nc, l, h))
    A = -torch.exp(normal(h))
    Bc, Cc = normal(b, nc, l, g, n), normal(b, nc, l, g, n)
    cs = torch.cumsum(dtc * A, dim=2)
    return [xc.to(dtype), dtc, cs, Bc.to(dtype), Cc.to(dtype)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(RANK_HEADS))
def test_ssd_kernel_at_a_model_ranks_heads(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = _inputs(7, *RANK_HEADS[case], getattr(torch, dtype))
    with torch.no_grad():
        got = ops.ssd_intra_chunk(*args)
        again = ops.ssd_intra_chunk(*args)
        want = ref.ssd_intra_chunk(*args)
        xc, dtc, cs, Bc, Cc = args
        scale = ref.ssd_intra_chunk(xc.abs(), dtc, cs, Bc.abs(), Cc.abs())
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(((got - want).abs() <= GATE * scale).all())
    assert torch.equal(got, again)
