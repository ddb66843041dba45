"""``repro_torch.kernels.plain_vjp``: a kernel wrapper's forward under
autograd with its plain version's backward, on the CPU, where each
wrapper runs its plain version. So the forward and every gradient equal
bitwise those of the plain version differentiated by autograd, for the
flash attention and the SSD intra-chunk form, for any subset of inputs
that require grad; a call with no gradient records nothing; and the
wrappers themselves still refuse nothing on the CPU."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.plain_vjp import with_plain_vjp  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402


def _flash_inputs(rng):
    q = rng.normal(size=(2, 20, 4, 16))
    k = rng.normal(size=(2, 20, 2, 16))
    v = rng.normal(size=(2, 20, 2, 16))
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in (q, k, v)]


def _ssd_inputs(rng):
    b, nc, l, h, p, g, n = 1, 2, 16, 4, 8, 2, 8
    dt = np.abs(rng.normal(size=(b, nc, l, h))) * 0.1
    cs = np.cumsum(dt * -0.5, axis=2)
    arrays = [rng.normal(size=(b, nc, l, h, p)), dt, cs,
              rng.normal(size=(b, nc, l, g, n)),
              rng.normal(size=(b, nc, l, g, n))]
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


CASES = {
    "flash": (_flash_inputs,
              lambda *t: fa_ops.flash_attention_with_vjp(*t, window=7),
              lambda *t: fa_ref.attention(*t, causal=True, window=7)),
    "ssd": (_ssd_inputs, ssd_ops.ssd_intra_chunk_with_vjp,
            ssd_ref.ssd_intra_chunk),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("which", ["all", "first", "last"])
def test_gradients_are_the_plain_versions_bitwise(case, which):
    make, kernel, plain = CASES[case]
    base = make(np.random.default_rng(0))
    needs = {"all": [True] * len(base),
             "first": [True] + [False] * (len(base) - 1),
             "last": [False] * (len(base) - 1) + [True]}[which]
    weight = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(plain(*base).shape)).astype(np.float32))
    grads = []
    for fn in (kernel, plain):
        ins = [t.clone().requires_grad_(n) for t, n in zip(base, needs)]
        out = fn(*ins)
        (out * weight).sum().backward()
        grads.append((out.detach(), [t.grad for t in ins]))
    (got, got_g), (want, want_g) = grads
    assert torch.equal(got, want)
    for g, w, n in zip(got_g, want_g, needs):
        assert (g is None) == (not n) == (w is None)
        if n:
            assert torch.equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_grad_call_records_nothing(case):
    make, kernel, plain = CASES[case]
    ins = [t.requires_grad_(True) for t in make(np.random.default_rng(2))]
    with torch.no_grad():
        out = kernel(*ins)
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, plain(*[t.detach() for t in ins]))


def test_kernel_sees_detached_inputs():
    seen = []

    def kernel(x):
        seen.append(x.requires_grad)
        return x * 2.0

    x = torch.ones(3, requires_grad=True)
    y = with_plain_vjp(kernel, lambda t: t * 2.0, (x,))
    y.sum().backward()
    assert seen == [False] and torch.equal(x.grad, torch.full((3,), 2.0))
