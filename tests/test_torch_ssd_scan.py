"""Port parity: the SSD intra-chunk dual form
(``repro_torch.kernels.ssd_scan``) and the chunked SSD of
``repro_torch.models.ssd`` against ``repro.kernels.ssd_scan`` and
``repro.models.ssd``, on the same seeded numpy inputs.

The plain version is held to the Pallas kernel (run in interpret mode,
as ``tests/test_kernels.py`` runs it) and to the reference's oracle at
the reference's three test shapes, with the reference's own rtol =
atol = 2e-5. The bf16 kernel's tensor-core arithmetic (C·Bᵀ from bf16
values, S split into bf16 hi and lo terms) is emulated step by step and
held within the 1e-5·Σ|terms| gate the card is held to, and one bf16
rounding of S shown to leave it. ``ssd_chunked`` carries the chunk states from chunk to
chunk in a sequential loop where the reference runs
``lax.associative_scan``, the same products and sums in another fp32
order: its outputs and final states are held at rtol = atol = 2e-4,
the tolerance at which ``tests/test_kernels.py`` holds the reference's
own two intra-chunk paths to each other through ``ssd_chunked``
(outputs reach |y| ≈ 100 here, and the port's largest error against a
float64 evaluation was ≈ 1e-4, about 8 ulp of that scale). On the
CPU the wrapper runs its plain version; the CUDA kernel is held against
it on the card by ``tests/test_torch_ssd_scan_gpu.py`` and
``chip_smoke.py``."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ops as r_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as r_ref  # noqa: E402
from repro.models import ssd as r_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402
from repro_torch.models import ssd  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)            # the intra-chunk form
CHUNKED_TOL = dict(rtol=2e-4, atol=2e-4)    # the chunked SSD, whole
REFERENCE_SHAPES = [(2, 2, 32, 3, 16, 16), (1, 4, 64, 2, 32, 64),
                    (2, 1, 128, 4, 64, 128)]


def _softplus(v):
    return np.log1p(np.exp(v))


def chunk_inputs(seed, b, nc, l, h, n, p, g=None):
    """The reference test's distributions, drawn with numpy: x, B, C
    standard normal, dt = softplus(normal), A = −exp(normal), cs the
    fp32 cumsum of dt·A over each chunk."""
    g = h if g is None else g
    rng = np.random.default_rng(seed)
    xc = rng.normal(size=(b, nc, l, h, p)).astype(np.float32)
    dtc = _softplus(rng.normal(size=(b, nc, l, h))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    cs = np.cumsum(dtc * A, axis=2, dtype=np.float32)
    Bc = rng.normal(size=(b, nc, l, g, n)).astype(np.float32)
    Cc = rng.normal(size=(b, nc, l, g, n)).astype(np.float32)
    return xc, dtc, cs, Bc, Cc


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("b,nc,l,h,p,n", REFERENCE_SHAPES)
def test_plain_matches_pallas_kernel_and_reference_oracle(b, nc, l, h, p, n):
    args = chunk_inputs(b * 100 + l, b, nc, l, h, n, p)
    got = ops.ssd_intra_chunk(*_torch(*args)).numpy()
    pallas = np.asarray(r_ops.ssd_intra_chunk(*map(jnp.asarray, args),
                                              interpret=True))
    oracle = np.asarray(r_ref.ssd_intra_chunk(*map(jnp.asarray, args)))
    assert got.dtype == np.float32 and got.shape == (b, nc, l, h, p)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_group_indexed_projections_equal_the_repeated_copy(g):
    """B and C by group (head k reads group k // (h / g)) give exactly
    what the reference's ``jnp.repeat`` onto the heads gives."""
    h = 4
    xc, dtc, cs, Bg, Cg = _torch(*chunk_inputs(3, 1, 2, 32, h, 16, 8, g=g))
    got = ops.ssd_intra_chunk(xc, dtc, cs, Bg, Cg)
    rep = h // g
    want = ops.ssd_intra_chunk(xc, dtc, cs,
                               torch.repeat_interleave(Bg, rep, dim=3),
                               torch.repeat_interleave(Cg, rep, dim=3))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        ref.heads_of(Bg, h).numpy(),
        np.repeat(Bg.numpy(), rep, axis=3))


def test_bf16_inputs_are_read_as_fp32():
    xc, dtc, cs, Bc, Cc = _torch(*chunk_inputs(5, 1, 1, 32, 2, 16, 16))
    bf = [t.to(torch.bfloat16) for t in (xc, Bc, Cc)]
    got = ops.ssd_intra_chunk(bf[0], dtc, cs, bf[1], bf[2])
    want = ops.ssd_intra_chunk(bf[0].float(), dtc, cs, bf[1].float(),
                               bf[2].float())
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_dispatch_is_by_device_only():
    """CPU tensors take the plain version, with no launch counted; the
    wrapper has no switch besides the tensors' device."""
    args = _torch(*chunk_inputs(1, 1, 1, 32, 2, 16, 16))
    launches = ops.ssd_intra_chunk.launches
    got = ops.ssd_intra_chunk(*args)
    assert got.shape == (1, 1, 32, 2, 16)
    assert torch.equal(got, ref.ssd_intra_chunk(*args))
    assert ops.ssd_intra_chunk.launches == launches
    with pytest.raises(TypeError, match="impl"):
        ops.ssd_intra_chunk(*args, impl="cuda")


@pytest.mark.parametrize("change,match", [
    (lambda a: [a[0][:, :, :16]] + a[1:], "shapes disagree"),
    (lambda a: [torch.cat([a[0]] * 5, -1)] + a[1:], "p <= 64"),
    (lambda a: a[:3] + [a[3][:, :, :, :1].repeat(1, 1, 1, 3, 1)] * 2,
     "do not split"),
    (lambda a: [a[0].half()] + a[1:], "share one of"),
    (lambda a: [a[0]] + [a[1].double()] + a[2:], "must be float32"),
    (lambda a: [a[0].transpose(3, 4).contiguous().transpose(3, 4)]
     + a[1:], "contiguous"),
])
def test_kernel_argument_checks(change, match):
    """What the CUDA wrapper refuses before a launch (checked here on
    CPU tensors, where the same checks run)."""
    args = _torch(*chunk_inputs(2, 1, 1, 32, 4, 16, 16))
    with pytest.raises(ValueError, match=match):
        ops._check(*change(list(args)))


GATE = 1e-5      # × Σ_j (|C_i|·|B_j|)·L_ij·dt_j·|x_jp|, as chip_smoke.py


def tensor_core_emulation(xc, dtc, cs, Bc, Cc, terms=2):
    """The bf16 kernel's arithmetic on the CPU, step by step: C·Bᵀ from
    the bf16 values, 16 state dims per m16n8k16 step (the products
    exact, each step's sum added to an fp32 accumulator); S = (C·Bᵀ ·
    exp(cs_i − cs_j)) · dt_j in fp32 on j ≤ i, 0 above; S split into
    ``terms`` bf16 parts (S_hi, S_lo, ...); per 16-column step, each
    part's product with x added to the fp32 accumulator in turn."""
    f32, f64 = torch.float32, torch.float64
    h, n = xc.shape[3], Bc.shape[4]
    l = cs.shape[2]
    Ch = ref.heads_of(Cc, h).to(f64).movedim(3, 2)       # (b,nc,h,l,n)
    Bh = ref.heads_of(Bc, h).to(f64).movedim(3, 2)
    cb = torch.zeros(Ch.shape[:3] + (l, l), dtype=f32)
    for k in range(0, n, 16):
        cb = (cb + Ch[..., k:k + 16] @ Bh[..., k:k + 16].transpose(-1, -2)
              ).to(f32)
    csh = cs.movedim(3, 2)
    s = (cb * torch.exp(csh[..., :, None] - csh[..., None, :])
         ) * torch.movedim(dtc, 3, 2)[..., None, :]
    s = torch.where(torch.ones(l, l, dtype=torch.bool).tril(), s,
                    torch.zeros((), dtype=f32))
    parts = []
    for _ in range(terms):
        parts.append(s.to(torch.bfloat16).to(f32))
        s = s - parts[-1]
    xh = xc.to(f64).movedim(3, 2)                         # (b,nc,h,l,p)
    acc = torch.zeros(xh.shape, dtype=f32)
    for k in range(0, l, 16):
        for part in parts:
            acc = (acc + part[..., k:k + 16].to(f64) @ xh[..., k:k + 16, :]
                   ).to(f32)
    return acc.movedim(2, 3)


def _gate_share(got, args):
    """Worst |got − plain| / (GATE · Σ|terms|) over the elements."""
    xc, dtc, cs, Bc, Cc = args
    want = ref.ssd_intra_chunk(*args)
    scale = ref.ssd_intra_chunk(xc.abs(), dtc, cs, Bc.abs(), Cc.abs())
    return float(((got - want).abs() / (GATE * scale)).max())


def _bf16(args):
    return [a.to(torch.bfloat16) if k in (0, 3, 4) else a
            for k, a in enumerate(args)]


# (b, nc, l, h, p, n, g): mamba2-780m's chunk at 8 heads, 3 groups of 2
# heads, a ragged chunk
EMULATED = [(1, 1, 256, 8, 64, 128, 1), (1, 2, 256, 6, 64, 128, 3),
            (1, 1, 100, 4, 40, 48, 2)]


@pytest.mark.parametrize("b,nc,l,h,p,n,g", EMULATED)
def test_tensor_core_arithmetic_is_within_the_gate(b, nc, l, h, p, n, g):
    """S_hi·x + S_lo·x, as the bf16 kernel computes it, stays within
    the 1e-5·Σ|terms| gate that chip_smoke.py holds the kernel to."""
    args = _bf16(_torch(*chunk_inputs(l + g, b, nc, l, h, n, p, g=g)))
    got = tensor_core_emulation(*args)
    assert got.shape == (b, nc, l, h, p)
    assert _gate_share(got, args) <= 1.0


def test_one_bf16_rounding_of_the_scores_leaves_the_gate():
    """The counter-case: S rounded once to bf16 moves outputs far past
    the gate (~100-fold here), which is why the kernel takes two terms."""
    args = _bf16(_torch(*chunk_inputs(257, 1, 1, 256, 8, 128, 64, g=1)))
    assert _gate_share(tensor_core_emulation(*args, terms=1), args) > 10.0
    assert _gate_share(tensor_core_emulation(*args, terms=2), args) <= 1.0


def test_bf16_kernel_needs_16_byte_aligned_inputs():
    """The bf16 kernel's cp.async copies need x, B and C 16-byte aligned;
    an input that is not raises (checked on CPU tensors, where the same
    checks run); fp32 inputs take no such check."""
    args = _bf16(_torch(*chunk_inputs(2, 1, 1, 32, 4, 16, 16)))
    ops._check(*args)
    for k in (0, 3, 4):
        flat = torch.zeros(args[k].numel() + 1, dtype=torch.bfloat16)
        moved = list(args)
        moved[k] = flat[1:].view(args[k].shape)
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops._check(*moved)
    fp32 = _torch(*chunk_inputs(2, 1, 1, 32, 4, 16, 16))
    flat = torch.zeros(fp32[0].numel() + 1)
    ops._check(flat[1:].view(fp32[0].shape), *fp32[1:])


def ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = _softplus(rng.normal(size=(b, s, h))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, s0


@pytest.mark.parametrize("s,g,with_state", [
    (128, 1, False),          # 4 whole chunks
    (128, 2, True),           # groups, continuing from a state
    (77, 1, False),           # dt = 0 padding to 3 chunks
    (77, 4, True),            # padding, a head per group, a state
    (20, 1, True),            # shorter than one chunk
])
def test_ssd_chunked_matches_reference(s, g, with_state):
    b, h, p, n, chunk = 2, 4, 16, 32, 32
    x, dt, A, B, C, s0 = ssd_inputs(s + g, b, s, h, p, g, n)
    init = s0 if with_state else None
    want_y, want_s = r_ssd.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, B, C)), chunk,
        initial_state=None if init is None else jnp.asarray(init))
    got_y, got_s = ssd.ssd_chunked(
        *_torch(x, dt, A, B, C), chunk,
        initial_state=None if init is None else _torch(init)[0])
    assert got_y.shape == (b, s, h, p) and got_s.shape == (b, h, p, n)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               **CHUNKED_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **CHUNKED_TOL)


def test_ssd_chunked_gradient_reaches_the_intra_chunk_term():
    """One chunk from a zero state: the inter-chunk term is 0, so the
    whole output, and its gradient, comes from the intra-chunk term.
    On the CPU that term is the plain version, which autograd
    differentiates: the gradients of Σ y·v with respect to x, dt, B
    and C are nonzero and match jax.grad of the reference's
    ssd_chunked (on the card the kernel refuses such a call)."""
    b, s, h, p, g, n = 1, 32, 2, 8, 1, 16
    x, dt, A, B, C, _ = ssd_inputs(11, b, s, h, p, g, n)
    v = np.random.default_rng(12).normal(size=(b, s, h, p)).astype(
        np.float32)

    def r_loss(x, dt, B, C):
        y, _ = r_ssd.ssd_chunked(x, dt, jnp.asarray(A), B, C, s)
        return jnp.sum(y * jnp.asarray(v))

    want = jax.grad(r_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, dt, B, C)))
    X, DT, BB, CC = [t.requires_grad_(True) for t in _torch(x, dt, B, C)]
    y, _ = ssd.ssd_chunked(X, DT, _torch(A)[0], BB, CC, s)
    got = torch.autograd.grad((y * _torch(v)[0]).sum(), (X, DT, BB, CC))
    for gt, wt in zip(got, want):
        assert bool(gt.abs().gt(0).any())
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   **CHUNKED_TOL)


def test_padding_is_a_no_op_on_the_recurrence():
    """77 steps padded to 96 give the first 77 outputs and the final
    state of the 77 steps themselves: the same as running the whole
    96-step input whose last 19 steps have dt = 0."""
    x, dt, A, B, C, _ = ssd_inputs(9, 1, 96, 2, 8, 1, 16)
    dt[:, 77:] = 0.0
    X, DT, AA, BB, CC = _torch(x, dt, A, B, C)
    y_pad, s_pad = ssd.ssd_chunked(X[:, :77], DT[:, :77], AA, BB[:, :77],
                                   CC[:, :77], 32)
    y_all, s_all = ssd.ssd_chunked(X, DT, AA, BB, CC, 32)
    assert torch.equal(y_pad, y_all[:, :77])
    assert torch.equal(s_pad, s_all)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    b, h, p, n = 3, 4, 16, 32
    rng = np.random.default_rng(g)
    state = rng.normal(size=(b, h, p, n)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = _softplus(rng.normal(size=(b, h))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, g, n)).astype(np.float32)
    C = rng.normal(size=(b, g, n)).astype(np.float32)
    want_y, want_s = r_ssd.ssd_decode_step(*map(jnp.asarray,
                                                (state, x, dt, A, B, C)))
    got_y, got_s = ssd.ssd_decode_step(*_torch(state, x, dt, A, B, C))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


def test_chunked_then_decode_equals_one_longer_pass():
    """The final state of a chunked pass continues a token at a time
    exactly as the chunked pass over the longer sequence does (up to
    fp32 order)."""
    x, dt, A, B, C, _ = ssd_inputs(4, 1, 40, 2, 8, 1, 16)
    X, DT, AA, BB, CC = _torch(x, dt, A, B, C)
    y_all, s_all = ssd.ssd_chunked(X, DT, AA, BB, CC, 16)
    _, st = ssd.ssd_chunked(X[:, :37], DT[:, :37], AA, BB[:, :37],
                            CC[:, :37], 16)
    for t in range(37, 40):
        y_t, st = ssd.ssd_decode_step(st, X[:, t], DT[:, t], AA, BB[:, t],
                                      CC[:, t])
        np.testing.assert_allclose(y_t.numpy(), y_all[:, t].numpy(),
                                   **CHUNKED_TOL)
    np.testing.assert_allclose(st.numpy(), s_all.numpy(), **CHUNKED_TOL)
