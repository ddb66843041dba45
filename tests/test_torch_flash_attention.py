"""Port parity: causal GQA flash attention
(``repro_torch.kernels.flash_attention``) against
``repro.kernels.flash_attention``, on the same seeded numpy inputs.

The plain version is held to the Pallas kernel (run in interpret mode,
as ``tests/test_kernels.py`` runs it) and to the reference's oracle at
the reference's six test shapes plus a GQA ratio of 3 (llama3.2-3b's
24 / 8 heads) and zamba2-7b's head dim of 112, fp32 at the reference's own rtol = atol = 2e-5 and bf16
at its 3e-2. On the CPU the wrapper runs its plain version; the CUDA
kernels are held against it on the card by
``tests/test_torch_flash_attention_gpu.py`` and ``chip_smoke.py``. The
bf16 kernel's arithmetic (tensor-core products, p split into two bf16
halves) is emulated here tile by tile and held against the plain
version under the card's one-unit bf16 gate."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as r_ops  # noqa: E402
from repro.kernels.flash_attention import ref as r_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# (B, S, H, K, D, window, Pallas block): tests/test_kernels.py's six,
# then GQA 3 with a ragged S
SHAPES = [(2, 128, 4, 2, 32, None, 64),
          (1, 256, 4, 4, 64, None, 128),
          (2, 96, 8, 2, 32, None, 32),
          (1, 256, 4, 2, 32, 64, 64),
          (1, 64, 2, 1, 16, 16, 32),        # MQA + window
          (2, 80, 4, 4, 32, None, 32),      # padded seq (80 % 32 != 0)
          (1, 100, 6, 2, 32, None, 32),     # GQA ratio 3, ragged
          (1, 160, 2, 2, 112, None, 64),    # zamba2-7b's head dim
          (1, 160, 4, 1, 112, 48, 64)]      # the same, MQA + window


def qkv(seed, B, S, H, K, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, K, D)).astype(np.float32),
            rng.normal(size=(B, S, K, D)).astype(np.float32))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


@pytest.mark.parametrize("B,S,H,K,D,win,blk", SHAPES)
def test_plain_matches_pallas_kernel_and_reference_oracle(B, S, H, K, D, win,
                                                          blk):
    q, k, v = qkv(S + H + D, B, S, H, K, D)
    got = ops.flash_attention(*_torch(q, k, v), window=win).numpy()
    pallas = np.asarray(r_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), window=win, block_q=blk, block_k=blk,
        interpret=True))
    oracle = np.asarray(r_ref.attention(*map(jnp.asarray, (q, k, v)),
                                        window=win))
    assert got.dtype == np.float32 and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("H,K", [(4, 2), (6, 2)])
def test_bf16_matches_pallas_kernel(H, K):
    """bf16 in, bf16 out, softmax in fp32 on both sides; the reference's
    bf16 gate (3e-2) against the Pallas kernel, and the plain version
    equal to itself on the fp32 copies of the same bf16 values, rounded
    once at the end."""
    q, k, v = qkv(1, 1, 128, H, K, 32)
    bq, bk, bv = _torch(q, k, v, dtype=torch.bfloat16)
    got = ops.flash_attention(bq, bk, bv)
    assert got.dtype == torch.bfloat16
    want = r_ops.flash_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (bq, bk, bv)), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    assert torch.equal(got, ref.attention(bq.float(), bk.float(),
                                          bv.float()).to(torch.bfloat16))


def test_gqa_reads_the_kv_head_of_each_query_head():
    """Query head h attends with kv head h // (H / K): the same result
    as k and v repeated onto the heads first."""
    q, k, v = _torch(*qkv(2, 1, 48, 6, 2, 16))
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q, torch.repeat_interleave(k, 3, dim=2),
                               torch.repeat_interleave(v, 3, dim=2))
    assert torch.equal(got, want)


def test_window_smaller_than_a_row_block_and_default_scale():
    """A window of 5 keeps 5 keys per row; scale 1/√D is the default."""
    q, k, v = _torch(*qkv(3, 1, 40, 2, 2, 16))
    got = ops.flash_attention(q, k, v, window=5)
    s = torch.einsum("bihd,bjhd->bhij", q, k) / 4.0
    i = torch.arange(40)[:, None]
    j = torch.arange(40)[None, :]
    s = s.masked_fill(~((j <= i) & (i - j < 5)), float("-inf"))
    want = torch.einsum("bhij,bjhd->bihd", torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(ops.flash_attention(q, k, v, scale=0.25),
                               ops.flash_attention(q, k, v), rtol=0, atol=0)


def test_dispatch_is_by_device_only():
    """CPU tensors take the plain version, with no launch counted; the
    wrapper has no switch besides the tensors' device."""
    q, k, v = _torch(*qkv(4, 1, 32, 2, 1, 16))
    launches = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v)
    assert torch.equal(got, ref.attention(q, k, v))
    assert ops.flash_attention.launches == launches
    with pytest.raises(TypeError, match="impl"):
        ops.flash_attention(q, k, v, impl="cuda")


def _tensor_core_emulation(q, k, v, window=None, split=True):
    """The bf16 kernel's arithmetic on the CPU: per query tile of BQ
    rows, the key tiles of BK it visits, s = q·kᵀ from exact bf16
    products in fp32 sums, the mask by index with the finite −1e30, the
    online recurrence in fp32 (l from the fp32 p), and p·v as
    bf16(p)·v + bf16(p − bf16(p))·v into an fp32 accumulator (``split``)
    or as bf16(p)·v alone; the output rounded to bf16 once."""
    B, S, H, D = q.shape
    bq, bk = ops.TILES[torch.bfloat16]
    rep = H // k.shape[2]
    qq, kk, vv = (t.float().permute(0, 2, 1, 3) for t in (
        q, torch.repeat_interleave(k, rep, 2),
        torch.repeat_interleave(v, rep, 2)))
    bf16 = torch.bfloat16
    out = torch.empty(B, H, S, D)
    for i0 in range(0, S, bq):
        n = min(bq, S - i0)
        rows = torch.arange(i0, i0 + bq)[:, None]
        qt = torch.zeros(B, H, bq, D)
        qt[:, :, :n] = qq[:, :, i0:i0 + n]
        m = torch.full((B, H, bq, 1), -1e30)
        l = torch.zeros(B, H, bq, 1)
        acc = torch.zeros(B, H, bq, D)
        lo_key = max(0, i0 - window + 1) if window else 0
        for j0 in range(lo_key // bk * bk, i0 + n, bk):
            nk = min(bk, S - j0)
            kt, vt = torch.zeros(B, H, bk, D), torch.zeros(B, H, bk, D)
            kt[:, :, :nk] = kk[:, :, j0:j0 + nk]
            vt[:, :, :nk] = vv[:, :, j0:j0 + nk]
            cols = torch.arange(j0, j0 + bk)[None, :]
            ok = (cols <= rows) & (cols < S)
            if window:
                ok &= rows - cols < window
            s = torch.where(ok, (qt @ kt.transpose(-1, -2)) / D ** 0.5,
                            torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = p.to(bf16).float()
            acc = acc * alpha + hi @ vt
            if split:
                acc = acc + (p - hi).to(bf16).float() @ vt
            m = m_new
        out[:, :, i0:i0 + n] = (acc / l.clamp_min(1e-30))[:, :, :n]
    return out.permute(0, 2, 1, 3).to(bf16)


def _outside_bf16_gate(got, want):
    """Share of outputs outside the card's bf16 gate, one unit:
    |got − want| > 2^-7·|want| + 2e-5."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() > 2.0 ** -7 * w.abs() + 2e-5).float().mean())


@pytest.mark.parametrize("B,S,H,K,D,win", [
    (1, 256, 4, 2, 64, None),        # causal, two 128-row query tiles
    (1, 384, 4, 2, 64, 100),         # a window that starts inside tiles
    (2, 200, 4, 2, 32, None),        # ragged S: 200 = 128 + 72
    (1, 200, 2, 2, 112, None),       # D = 112: 7 k-steps, 14 n-tiles
])
def test_tensor_core_arithmetic_within_one_bf16_unit(B, S, H, K, D, win):
    """The bf16 kernel's arithmetic, emulated tile by tile, lands within
    one bf16 unit of the plain version on every output."""
    q, k, v = _torch(*qkv(S + H + D, B, S, H, K, D), dtype=torch.bfloat16)
    got = _tensor_core_emulation(q, k, v, win)
    assert _outside_bf16_gate(got, ref.attention(q, k, v, window=win)) == 0


def test_a_single_bf16_p_leaves_the_one_unit_gate():
    """Why the kernel splits p: rounding p once to bf16 before p·v moves
    a few per cent of the outputs (about 9 % at these seeded inputs) by
    more than one bf16 unit, where p_hi + p_lo moves none (above)."""
    q, k, v = _torch(*qkv(256 + 4 + 64, 1, 256, 4, 2, 64),
                     dtype=torch.bfloat16)
    got = _tensor_core_emulation(q, k, v, split=False)
    assert _outside_bf16_gate(got, ref.attention(q, k, v)) > 0.01


@pytest.mark.parametrize("change,kw,match", [
    (lambda a: [a[0][:, :16]] + a[1:], {}, "shapes disagree"),
    (lambda a: [a[0]] + [torch.cat([t, t[:, :, :1]], 2) for t in a[1:]],
     {}, "do not split"),
    (lambda a: [a[0].half()] + a[1:], {}, "share one of"),
    (lambda a: [a[0].double(), a[1].double(), a[2].double()], {},
     "share one of"),
    (lambda a: [torch.cat([a[0]] * 3, -1), torch.cat([a[1]] * 3, -1),
                torch.cat([a[2]] * 3, -1)], {}, "head dims"),
    (lambda a: [a[0][..., :8], a[1][..., :8], a[2][..., :8]], {},
     "head dims"),
    (lambda a: [a[0].transpose(2, 3).contiguous().transpose(2, 3)]
     + a[1:], {}, "contiguous"),
    (lambda a: a, {"causal": False}, "causal only"),
    (lambda a: a, {"window": 0}, "window"),
    (lambda a: [a[0][0]] + a[1:], {}, r"\(B, S, heads, D\)"),
    # bf16 views 2 bytes into their storage (and strides of 17 elements)
    (lambda a: [torch.cat([t, t[..., :1]], -1).to(torch.bfloat16)[..., 1:]
                for t in a], {}, "16-byte aligned"),
    # bf16 at an aligned start, head stride 20 elements (40 bytes)
    (lambda a: [torch.cat([t, t[..., :4]], -1).to(torch.bfloat16)[..., :16]
                for t in a], {}, "16-byte aligned"),
])
def test_kernel_argument_checks(change, kw, match):
    """What the CUDA wrapper refuses before a launch (checked here on
    CPU tensors, where the same checks run)."""
    args = list(_torch(*qkv(5, 1, 32, 4, 2, 16)))
    kw = {"causal": True, "window": None, **kw}
    with pytest.raises(ValueError, match=match):
        ops._check(*change(args), kw["causal"], kw["window"])


def test_strided_inputs_are_taken_as_they_are():
    """q, k and v sliced out of one fused projection (strided over the
    heads, head dim contiguous) pass the checks and give the result of
    contiguous copies."""
    rng = np.random.default_rng(6)
    qkv_ = torch.from_numpy(rng.normal(size=(2, 24, 8, 16)).astype(
        np.float32))
    q, k, v = qkv_[:, :, :4], qkv_[:, :, 4:6], qkv_[:, :, 6:]
    ops._check(q, k, v, True, None)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v),
        ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous()),
        rtol=0, atol=0)
