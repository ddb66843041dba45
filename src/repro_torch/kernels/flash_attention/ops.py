"""Dispatch for causal GQA flash attention.

``flash_attention`` takes the reference's model-layer interface
(``repro.kernels.flash_attention.ops``): q (B, S, H, D), k and v
(B, S, K, D) with K dividing H, and returns (B, S, H, D) in q's dtype.
CUDA tensors take a kernel, CPU tensors the plain version (``ref``),
and nothing else: the tensors' device is the only switch. The kernel
launches are counted in ``flash_attention.launches``.

On the card the dtype picks the kernel of ``csrc/flash_attention.cu``,
and nothing falls back from one to the other or to the plain version:

- **bf16** takes the tensor-core kernel: blocks of 128 query rows
  (8 warps of 16) over 64-key tiles, q·kᵀ by bf16 ``mma.sync``
  m16n8k16 into fp32, the online softmax in registers, and p·v as two
  bf16 products, p_hi·v + p_lo·v with p_hi = bf16(p) and p_lo =
  bf16(p − p_hi), so that the output stays within one bf16 unit of the
  plain version's (one bf16 p does not); k and v stream through a
  2-stage ``cp.async`` ring, which needs q, k and v 16-byte aligned
  (``data_ptr`` and the strides over b, s and the head). Every tensor
  the model builds is; an input that is not raises ``ValueError``.
- **fp32** takes the CUDA-core kernel (64 × 64 tiles, IEEE fp32 FMAs):
  the tensor cores would round fp32 inputs to TF32.

Both read q, k and v in their layout with their strides (the head dim
contiguous) and k and v by kv head ``h // (H / K)``, so they make no
swap copy and no GQA repeat; the plain version repeats k and v onto
the heads, the same values. Head dims 16, 32, 64, 112 (zamba2-7b's
shared block) and 128, any S,
causal attention with an optional sliding window, and no gradient:
the reference kernel has no VJP. A pass that autograd records calls
``flash_attention_with_vjp``: the kernel's forward, the plain
version's vector-Jacobian product (``kernels.plain_vjp``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.configs.base import NotPortedError
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.plain_vjp import with_plain_vjp

HEAD_DIMS = (16, 32, 64, 112, 128)
MAX_BH = 65535               # grid y (heads) and z (batch)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (query rows per block, keys per tile) of each dtype's kernel
TILES = {torch.float32: (64, 64), torch.bfloat16: (128, 64)}
ALIGN = 16                   # bytes, for the bf16 kernel's cp.async


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signature
    declared (pointers and the stream as c_void_p, never as int)."""
    from repro_torch.kernels import cuda_build
    lib, _ = cuda_build.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                        ctypes.c_float] + [ll] * 9 + [i, i, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_blocks_per_sm.argtypes = [i, i, i, p]
    lib.flash_attention_blocks_per_sm.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, causal, window):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    B, S, H, D = q.shape
    K = k.shape[2]
    if k.shape != (B, S, K, D) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads do not split over {K} kv heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {tuple(_DTYPES)}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if not (1 <= S < 2 ** 31 and 1 <= B <= MAX_BH and H <= MAX_BH):
        raise ValueError(f"the kernel takes 1 <= S < 2**31, 1 <= B <= "
                         f"{MAX_BH}, H <= {MAX_BH}; got (B, S, H) = "
                         f"{(B, S, H)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must be on one device")
    if not causal:
        raise ValueError("the kernel is causal only, as the reference's")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.dtype == torch.bfloat16:
        for name, t in zip("qkv", (q, k, v)):
            size = t.element_size()
            if (t.data_ptr() % ALIGN
                    or any(s * size % ALIGN for s in t.stride()[:3])):
                raise ValueError(
                    f"the bf16 kernel needs {name} {ALIGN}-byte aligned "
                    f"(cp.async): data_ptr % {ALIGN} = "
                    f"{t.data_ptr() % ALIGN}, strides {t.stride()[:3]} "
                    f"x {size} bytes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, K, D) → (B, S, H, D) in q's dtype.
    ``scale`` defaults to 1/√D."""
    if not q.is_cuda:
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)
    if any(t.requires_grad for t in (q, k, v)):
        raise NotPortedError(
            "flash_attention has no backward on the card, as the reference "
            "kernel has no VJP; call it under torch.no_grad()")
    _check(q, k, v, causal, window)
    B, S, H, D = q.shape
    K = k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    lib = _lib()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        K, D, 0 if window is None else window, scale, *strides,
        _DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, status, "launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_with_vjp(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Causal :func:`flash_attention` that autograd can differentiate:
    the forward is the wrapper's (the kernel on the card), the backward
    the VJP of the plain version (``ref.attention``) at the same
    inputs."""
    return with_plain_vjp(flash_attention, ref.attention, (q, k, v),
                          causal=True, window=window, scale=scale)


def _raise_on(lib, status, what):
    if status != 0:
        raise RuntimeError(
            f"flash_attention {what} failed: "
            f"{lib.flash_attention_error_string(status).decode()}")


def blocks_per_sm(dtype: torch.dtype, head_dim: int,
                  device: int = 0) -> int:
    """Blocks of the ``dtype`` kernel at ``head_dim`` that one SM of card
    ``device`` holds at once (registers, shared memory and threads)."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    _raise_on(lib, lib.flash_attention_blocks_per_sm(
        _DTYPES[dtype], head_dim, device, ctypes.byref(blocks)),
        "occupancy query")
    return blocks.value
