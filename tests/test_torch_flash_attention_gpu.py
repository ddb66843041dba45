"""The flash-attention CUDA kernel
(``repro_torch.kernels.flash_attention``) against its plain version, on
the card, and the dense transformer on the card against the same model
on the CPU. Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor the reference package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_flash_attention_gpu.py

Tolerances. fp32 inputs: the reference's rtol = atol = 2e-5
(``tests/test_kernels.py``); the kernel and the plain version add the
same fp32 terms in other orders (online against materialised softmax).
bf16 inputs: the tensor-core kernel takes exact bf16 products into
fp32 sums and splits p into two bf16 halves (p_hi + p_lo), the plain
version computes in fp32; both round the output to bf16 once, so they
may land one bf16 unit in the last place apart where the fp32 values
straddle a rounding boundary: |got − want| ≤ 2^-7·|want| (one unit at
the bottom of a binade) + 2e-5.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import NotPortedError  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine, \
    serve_batches  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def qkv(seed, B, S, H, K, D, device, dtype):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]


def within_gate(got, want):
    if got.dtype == torch.float32:
        return torch.allclose(got, want, rtol=2e-5, atol=2e-5)
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 2e-5).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,D,window", [
    (2, 4096, 24, 8, 128, None),     # llama3.2-3b scoring, 4k tokens
    (1, 4096, 24, 8, 128, 512),      # window of 512
    (1, 300, 4, 2, 128, 5),          # windows smaller than a tile
    (1, 300, 4, 2, 64, 40),
    (1, 4000, 8, 8, 128, None),      # ragged S
    (2, 80, 4, 4, 32, None),
    (1, 1, 2, 1, 16, None),          # one token
    (2, 513, 8, 1, 64, None),        # MQA, D = 64
    (2, 4096, 32, 32, 112, None),    # zamba2-7b scoring, D = 112
    (1, 4000, 32, 8, 112, 512),      # D = 112: ragged S, window, GQA
])
def test_kernel_matches_plain(B, S, H, K, D, window, dtype):
    dev = _card()
    q, k, v = qkv(S + H + D, B, S, H, K, D, dev, dtype)
    launches = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, window=window)
    again = ops.flash_attention(q, k, v, window=window)
    assert ops.flash_attention.launches == launches + 2
    want = ref.attention(q, k, v, window=window)
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    assert torch.equal(got, again)
    assert within_gate(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,D,window", [
    (1, 127, 4, 2, 128, None),       # one query tile, short of its edge
    (1, 128, 4, 2, 128, None),       # exactly one 128-row tile
    (1, 129, 4, 2, 128, None),       # one row into the second tile
    (1, 4097, 8, 2, 128, None),      # one row past 32 tiles
    (1, 700, 4, 2, 128, 64),         # windows that cross a 128-row tile
    (1, 700, 4, 2, 128, 127),
    (1, 700, 4, 2, 128, 128),
    (2, 333, 6, 3, 16, None),        # the smaller head dims
    (2, 333, 6, 3, 32, 100),
    (2, 333, 6, 2, 64, None),
    (1, 129, 4, 4, 112, None),       # D = 112 at the tile edges
    (1, 700, 4, 2, 112, 127),
])
def test_bf16_kernel_at_tile_edges(B, S, H, K, D, window):
    """The tensor-core kernel's tile edges: S around 128-row query tiles
    and 64-key tiles, windows that start inside a query tile, D = 16, 32,
    64 and 112; within one bf16 unit, two launches bitwise equal."""
    dev = _card()
    q, k, v = qkv(S * 7 + D, B, S, H, K, D, dev, torch.bfloat16)
    got = ops.flash_attention(q, k, v, window=window)
    assert torch.equal(got, ops.flash_attention(q, k, v, window=window))
    assert within_gate(got, ref.attention(q, k, v, window=window))


@pytest.mark.gpu
def test_bf16_kernel_reads_strided_heads():
    """bf16 q, k, v as views of one fused (B, S, H + 2K, D) projection
    (16-byte aligned strides) give the result of contiguous copies."""
    dev = _card()
    fused = torch.randn((2, 300, 12, 128), device=dev).to(torch.bfloat16)
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    got = ops.flash_attention(q, k, v, window=200)
    assert within_gate(got, ref.attention(q, k, v, window=200))
    assert torch.equal(got, ops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), window=200))


@pytest.mark.gpu
def test_bf16_kernel_refuses_unaligned_inputs():
    """cp.async copies 16 bytes: a bf16 view that starts 2 bytes in is
    refused before any launch."""
    dev = _card()
    base = torch.randn((1, 64, 4, 17), device=dev).to(torch.bfloat16)
    q = base[..., 1:]
    launches = ops.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, 2:])
    assert ops.flash_attention.launches == launches


@pytest.mark.gpu
def test_kernel_reads_strided_heads():
    """q, k, v as views of one fused (B, S, H + 2K, D) projection."""
    dev = _card()
    fused = torch.randn((2, 200, 12, 64), device=dev)
    q, k, v = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    got = ops.flash_attention(q, k, v)
    assert within_gate(got, ref.attention(q, k, v))
    assert torch.equal(got, ops.flash_attention(q.contiguous(),
                                                k.contiguous(),
                                                v.contiguous()))


@pytest.mark.gpu
def test_kernel_refuses_a_backward():
    dev = _card()
    q, k, v = qkv(0, 1, 16, 2, 1, 16, dev, torch.float32)
    with pytest.raises(NotPortedError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)


@pytest.mark.gpu
def test_reduced_llama_on_the_card_matches_the_cpu():
    """llama3.2-3b ``reduced()`` (fp32): the cache-free pass's logits
    and loss within 1e-4 of the CPU's with one kernel launch per layer;
    serving greedy tokens equal, with no launch (prefill passes a
    cache)."""
    dev = _card()
    cfg = get_arch_config("llama3.2-3b").reduced()
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 257),
                                         dtype=np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "positions": torch.arange(256, dtype=torch.int32).expand(2, 256)}
    gp = tree_map(lambda t: t.to(dev), params)
    gb = {k: t.to(dev) for k, t in batch.items()}
    with torch.no_grad():
        launches = ops.flash_attention.launches
        l_gpu, _ = model.forward(cfg, gp, gb, None)
        loss_gpu = model.loss(cfg, gp, gb)
        assert ops.flash_attention.launches == launches + 2 * cfg.n_layers
        l_cpu, _ = model.forward(cfg, params, batch, None)
        loss_cpu = model.loss(cfg, params, batch)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(loss_gpu.cpu(), loss_cpu, rtol=1e-5,
                               atol=1e-5)

    prompts = [[5, 9, 200, 31, 7, 7, 301, 2, 88, 45] * 7, [11, 400, 3]]
    serve = ServeConfig(max_len=96, max_new_tokens=8)
    outs = {}
    for device, p in (("cpu", params), (dev, gp)):
        eng = ServeEngine(cfg, p, serve)
        t, lens = serve_batches(prompts, 2, device=device)[0]
        launches = ops.flash_attention.launches
        outs[str(device)] = eng.generate(t, lens).cpu()
        assert ops.flash_attention.launches == launches
    assert torch.equal(outs["cpu"], outs[str(dev)])
