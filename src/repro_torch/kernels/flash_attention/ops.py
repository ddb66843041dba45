"""Dispatch for causal GQA flash attention.

``flash_attention`` takes the reference's model-layer interface
(``repro.kernels.flash_attention.ops``): q (B, S, H, D), k and v
(B, S, K, D) with K dividing H, and returns (B, S, H, D) in q's dtype.
CUDA tensors take the kernel, CPU tensors the plain version (``ref``),
and nothing else: the tensors' device is the only switch. The kernel's
launches are counted in ``flash_attention.launches``.

The kernel reads q, k and v in that layout with their strides (the head
dim contiguous) and k and v by kv head ``h // (H / K)``, so it makes no
swap copy and no GQA repeat; the plain version repeats k and v onto the
heads, the same values. It takes fp32 or bf16 (the three alike), head
dims 16, 32, 64 and 128, any S, causal attention with an optional
sliding window, and no gradient: the reference kernel has no VJP.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.configs.base import NotPortedError
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 128)
MAX_BH = 65535               # grid y (heads) and z (batch)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if status != 0:
        raise RuntimeError(
            f"flash_attention launch failed: "
            f"{lib.flash_attention_error_string(status).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
