"""A kernel's forward under autograd, with its plain version's backward.

The reference's Pallas kernels define no VJP, and so neither do their
CUDA counterparts: each wrapper refuses inputs that require grad. A
training pass still runs them: :func:`with_plain_vjp` calls the
wrapper on detached inputs (the CUDA kernel on the card, the plain
version on the CPU, as the wrapper chooses) and saves those inputs; its
backward runs the plain version again on them under autograd and
returns that graph's vector-Jacobian product. The gradient is then
exactly the plain version's, at the price of one more plain forward per
call in the backward pass, and the forward's activations are not kept.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


class _KernelForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, kw, *tensors):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*tensors)
        return kernel(*(t.detach() for t in tensors), **kw)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*ins, **ctx.kw)
            got = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, needs) if n], grad))
        return (None, None, None) + tuple(next(got) if n else None
                                          for n in needs)


def with_plain_vjp(kernel: Callable, plain: Callable,
                   tensors: Sequence[torch.Tensor], **kw) -> torch.Tensor:
    """``kernel(*tensors, **kw)``, differentiable through
    ``plain(*tensors, **kw)``: the same function, computed the plain
    way."""
    return _KernelForward.apply(kernel, plain, kw, *tensors)
