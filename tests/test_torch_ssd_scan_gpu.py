"""The SSD intra-chunk CUDA kernel (``repro_torch.kernels.ssd_scan``)
against its plain version, on the card, and the Mamba2 serving path on
the card against the same path on the CPU. Every test here needs a
CUDA card and skips without one.

This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_ssd_scan_gpu.py

bf16 inputs take the tensor-core kernel, fp32 inputs the CUDA-core
kernel; both are held here at their edges.

Tolerances. At the reference's test shapes the kernel is held to the
reference's rtol = atol = 2e-5. Elsewhere each element is held to
1e-5 · Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp|, the sum of the absolute
values of the terms it adds (the plain version evaluated on |x|, |B|,
|C|): kernel and plain version add the same fp32 terms in other
orders, so their difference is a few ulp of that sum, whatever the
cancellation between the terms.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import NotPortedError  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402
from repro_torch.models import get_model, ssd  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine, \
    serve_batches  # noqa: E402

GATE = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def chunk_inputs(seed, b, nc, l, h, n, p, g=None, device="cpu",
                 dtype=torch.float32):
    g = h if g is None else g
    rng = np.random.default_rng(seed)
    xc = rng.normal(size=(b, nc, l, h, p)).astype(np.float32)
    dtc = np.log1p(np.exp(rng.normal(size=(b, nc, l, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    cs = np.cumsum(dtc * A, axis=2, dtype=np.float32)
    Bc = rng.normal(size=(b, nc, l, g, n)).astype(np.float32)
    Cc = rng.normal(size=(b, nc, l, g, n)).astype(np.float32)
    out = [torch.from_numpy(a).to(device) for a in (xc, dtc, cs, Bc, Cc)]
    for k in (0, 3, 4):
        out[k] = out[k].to(dtype)
    return out


def _within_gate(got, args):
    xc, dtc, cs, Bc, Cc = args
    want = ref.ssd_intra_chunk(*args)
    scale = ref.ssd_intra_chunk(xc.abs(), dtc, cs, Bc.abs(), Cc.abs())
    return bool(((got - want).abs() <= GATE * scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("which", range(5))
def test_input_that_requires_grad_raises(which):
    """The kernel has no backward: a CUDA call that autograd would
    record raises rather than drop the gradient of that input; under
    torch.no_grad() the same call runs."""
    dev = _card()
    args = chunk_inputs(5, 1, 1, 32, 2, 16, 16, device=dev)
    args[which].requires_grad_(True)
    launches = ops.ssd_intra_chunk.launches
    with pytest.raises(NotPortedError, match="no backward on the card"):
        ops.ssd_intra_chunk(*args)
    assert ops.ssd_intra_chunk.launches == launches
    with torch.no_grad():
        got = ops.ssd_intra_chunk(*args)
    assert ops.ssd_intra_chunk.launches == launches + 1
    assert torch.equal(got, ref.ssd_intra_chunk(*[a.detach() for a in args]))


@pytest.mark.gpu
@pytest.mark.parametrize("b,nc,l,h,p,n", [(2, 2, 32, 3, 16, 16),
                                          (1, 4, 64, 2, 32, 64),
                                          (2, 1, 128, 4, 64, 128)])
def test_kernel_matches_plain_at_reference_shapes(b, nc, l, h, p, n):
    dev = _card()
    args = chunk_inputs(b * 100 + l, b, nc, l, h, n, p, device=dev)
    launches = ops.ssd_intra_chunk.launches
    got = ops.ssd_intra_chunk(*args)
    assert ops.ssd_intra_chunk.launches == launches + 1
    torch.testing.assert_close(got, ref.ssd_intra_chunk(*args), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 4, 256, 48, 64, 128, 1),      # mamba2-780m, batch 2, 1024 tokens
    (1, 2, 100, 6, 40, 48, 3),        # ragged l, p, n; 3 groups
    (1, 1, 1, 2, 1, 1, 1),            # one step
])
def test_kernel_within_gate_and_repeatable(shape, dtype):
    dev = _card()
    b, nc, l, h, p, n, g = shape
    args = chunk_inputs(sum(shape), b, nc, l, h, n, p, g=g, device=dev,
                        dtype=dtype)
    got = ops.ssd_intra_chunk(*args)
    again = ops.ssd_intra_chunk(*args)
    assert got.dtype == torch.float32 and got.shape == (b, nc, l, h, p)
    assert torch.equal(got, again)
    assert _within_gate(got, args)


# bf16 at the edges of the tensor-core kernel's 64-row tiles, its windows
# of 4 column tiles for dt and cs (l > 256), its 16-byte copies (p, n not
# multiples of 8) and its head sets (every instance, 1, 2 and 3 heads a
# block; g > 1 with several sets per group): (b, nc, l, h, p, n, g)
BF16_EDGES = [
    (1, 2, 1, 4, 64, 128, 1), (1, 2, 63, 4, 64, 128, 1),
    (1, 2, 65, 4, 64, 128, 1), (1, 3, 100, 6, 40, 48, 3),
    (1, 2, 256, 4, 1, 16, 1), (1, 2, 256, 4, 40, 100, 2),
    (1, 1, 129, 18, 33, 24, 3), (1, 1, 300, 4, 64, 128, 2),
    (1, 1, 600, 2, 64, 64, 1), (4, 8, 256, 12, 64, 128, 2),
    (2, 8, 256, 36, 64, 128, 3), (8, 8, 256, 12, 64, 128, 3),
    (4, 16, 256, 48, 64, 128, 1), (16, 8, 300, 6, 64, 128, 2),
    (16, 8, 600, 4, 64, 64, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BF16_EDGES)
def test_bf16_kernel_at_tile_window_and_group_edges(shape):
    dev = _card()
    b, nc, l, h, p, n, g = shape
    args = chunk_inputs(sum(shape), b, nc, l, h, n, p, g=g, device=dev,
                        dtype=torch.bfloat16)
    launches = ops.ssd_intra_chunk.launches
    got = ops.ssd_intra_chunk(*args)
    again = ops.ssd_intra_chunk(*args)
    assert ops.ssd_intra_chunk.launches == launches + 2
    assert got.dtype == torch.float32 and got.shape == (b, nc, l, h, p)
    assert torch.equal(got, again)
    assert _within_gate(got, args)


@pytest.mark.gpu
def test_bf16_kernel_on_a_dt_zero_padded_chunk():
    """As below, in bf16 at mamba2-780m's prefill shape (3 heads a
    block): the padded rows are exactly 0."""
    dev = _card()
    xc, dtc, cs, Bc, Cc = chunk_inputs(12, 2, 4, 256, 48, 128, 64, g=1,
                                       device=dev)
    for t in (xc, dtc, Bc, Cc):
        t[:, :, 186:] = 0
    cs = torch.cumsum(dtc * -0.5, dim=2)
    args = [xc.bfloat16(), dtc, cs, Bc.bfloat16(), Cc.bfloat16()]
    got = ops.ssd_intra_chunk(*args)
    assert _within_gate(got, args)
    assert not bool(got[:, :, 186:].any())


@pytest.mark.gpu
def test_bf16_kernel_refuses_an_unaligned_input():
    """cp.async needs x, B and C 16-byte aligned: a view 2 bytes off
    raises before any launch."""
    dev = _card()
    args = chunk_inputs(3, 1, 1, 64, 4, 16, 16, device=dev,
                        dtype=torch.bfloat16)
    flat = torch.zeros(args[0].numel() + 1, dtype=torch.bfloat16,
                       device=dev)
    launches = ops.ssd_intra_chunk.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.ssd_intra_chunk(flat[1:].view(args[0].shape), *args[1:])
    assert ops.ssd_intra_chunk.launches == launches


@pytest.mark.gpu
def test_kernel_on_a_dt_zero_padded_chunk():
    """The last 70 steps of the chunk are ``ssd_chunked``'s padding:
    dt = 0 (so cs stays flat) and x, B, C zero."""
    dev = _card()
    xc, dtc, cs, Bc, Cc = chunk_inputs(11, 1, 1, 256, 4, 32, 16, g=1,
                                       device=dev)
    for t in (xc, dtc, Bc, Cc):
        t[:, :, 186:] = 0
    cs = torch.cumsum(dtc * -0.5, dim=2)
    got = ops.ssd_intra_chunk(xc, dtc, cs, Bc, Cc)
    assert _within_gate(got, (xc, dtc, cs, Bc, Cc))
    assert not bool(got[:, :, 186:].any())


@pytest.mark.gpu
def test_ssd_chunked_on_the_card_matches_the_cpu():
    dev = _card()
    rng = np.random.default_rng(0)
    b, s, h, p, g, n = 2, 300, 8, 64, 1, 128
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)) - 2)).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32) * 0.3
    C = rng.normal(size=(b, s, g, n)).astype(np.float32) * 0.3
    cpu = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y_cpu, s_cpu = ssd.ssd_chunked(*cpu, 256)
    launches = ops.ssd_intra_chunk.launches
    y_gpu, s_gpu = ssd.ssd_chunked(*[t.to(dev) for t in cpu], 256)
    assert ops.ssd_intra_chunk.launches == launches + 1
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_gpu.cpu(), s_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_reduced_serving_on_the_card_matches_the_cpu():
    """mamba2-780m ``reduced()``: prefill logits within 1e-4, greedy
    tokens equal, one kernel launch per layer per prefill."""
    dev = _card()
    cfg = get_arch_config("mamba2-780m").reduced()
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = [[5, 9, 200, 31, 7, 7, 301, 2, 88, 45] * 7, [11, 400, 3]]
    serve = ServeConfig(max_len=128, max_new_tokens=8)
    outs = {}
    for device in ("cpu", dev):
        eng = ServeEngine(cfg, tree_map(lambda t: t.to(device), params),
                          serve)
        toks, lens = serve_batches(prompts, 2, device=device)[0]
        launches = ops.ssd_intra_chunk.launches
        logits, cache = eng.prefill(toks, lens)
        outs[str(device)] = (logits.cpu(), eng.decode(logits, cache,
                                                      lens).cpu())
        if device == dev:
            assert ops.ssd_intra_chunk.launches == launches + cfg.n_layers
    (l_cpu, t_cpu), (l_gpu, t_gpu) = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(l_gpu, l_cpu, rtol=1e-4, atol=1e-4)
    assert torch.equal(t_gpu, t_cpu)
