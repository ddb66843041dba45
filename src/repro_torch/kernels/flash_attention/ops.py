"""Dispatch for causal GQA flash attention.

``flash_attention`` takes the reference's model-layer interface
(``repro.kernels.flash_attention.ops``): q (B, S, H, D), k and v
(B, S, K, D) with K dividing H, and returns (B, S, H, D) in q's dtype.
CUDA tensors take a kernel, CPU tensors the plain version (``ref``),
meta tensors the kernel op's shape function (below), and nothing else:
the tensors' device is the only switch. The kernel
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

A card tensor launches the kernel straight through ``ctypes`` (and
counts the launch). A meta or fake tensor (the dry run,
``repro_torch.roofline.trace``) goes to the custom op
``torch.ops.repro_torch.flash_attention`` instead, whose shape function
returns an output of the kernel's shape and dtype and computes nothing,
and which ``FlopCounterMode`` counts by :func:`flash_flops`, the
operations the kernel does over the pairs the causal mask and the
window keep (the op's own implementation is the same launch). The
card's path skips the op's dispatcher, which costs host time per call.
:func:`flash_flops`, :func:`flash_bytes` and :func:`flash_bound` also
price the kernel's least time in ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.configs.base import NotPortedError
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.plain_vjp import with_plain_vjp
from repro_torch.roofline import constants as C

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
    if (q.dtype == torch.bfloat16 and not q.is_meta
            and not is_fake(q)):
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
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             scale=scale)
    if any(t.requires_grad for t in (q, k, v)):
        raise NotPortedError(
            "flash_attention has no backward on the card, as the reference "
            "kernel has no VJP; call it under torch.no_grad()")
    _check(q, k, v, causal, window)
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    window = 0 if window is None else window
    if q.is_meta or is_fake(q):                  # the op's shape function
        return torch.ops.repro_torch.flash_attention(q, k, v, window, scale)
    return _launch(q, k, v, window, scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
            scale: float) -> torch.Tensor:
    """One launch of the kernel on checked card tensors (``window`` 0:
    none)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    lib = _lib()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        K, D, window, scale, *strides, _DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, status, "launch")
    flash_attention.launches += 1
    return out


_op = torch.library.custom_op("repro_torch::flash_attention", _launch,
                              mutates_args=())


@_op.register_fake
def _(q, k, v, window, scale):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _(q, k, v, window, scale, out_val=None):
    B, S, H, D = q.shape
    return flash_flops(B, S, H, D, window or None,
                       q.dtype == torch.bfloat16)


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


def flash_pairs(S: int, window: Optional[int]) -> int:
    """The (i, j) pairs the causal mask and the window keep in one
    (batch, head): Σ_i min(i + 1, window)."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_flops(B: int, S: int, H: int, D: int, window: Optional[int],
                bf16: bool) -> int:
    """Operations of one call over the pairs the mask keeps
    (:func:`flash_pairs`), 2·D per pair and product: q·kᵀ and p·v, and
    with bf16 inputs p·v as two products, p_hi·v + p_lo·v (p is fp32 in
    the reference and one bf16 p leaves the one-unit gate)."""
    return (3 if bf16 else 2) * 2 * D * flash_pairs(S, window) * B * H


def flash_bytes(B: int, S: int, H: int, K: int, D: int, esize: int) -> int:
    """q, k and v read once, o written once."""
    return (2 * B * S * H * D + 2 * B * S * K * D) * esize


def flash_bound(B, S, H, K, D, window, esize):
    """Least time (ms) of one call on the card, the larger of operations
    and bytes, and which one it is: :func:`flash_flops` at the bf16
    tensor-core rate (bf16 inputs; bf16 products are exact in fp32) or
    the fp32 rate (fp32 inputs: TF32 would round them), and
    :func:`flash_bytes` at the HBM rate (``roofline.constants``)."""
    bf16 = esize == 2
    rate = C.PEAK_FLOPS_BF16 if bf16 else C.PEAK_FLOPS_FP32
    ops_ms = flash_flops(B, S, H, D, window, bf16) / rate * 1e3
    bytes_ms = flash_bytes(B, S, H, K, D, esize) / C.HBM_BW * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def flash_mma_flops(B, S, H, D, window, dtype_is_bf16):
    """The operations the kernel runs over the tiles it visits, as
    ``csrc/flash_attention.cu`` walks them: per query tile the key tiles
    from the window's first to the diagonal; bf16 (128 x 64 tiles,
    three products) skips a tile per warp of 16 rows when it is wholly
    masked for them, fp32 (64 x 64, two products) runs every visited
    tile whole."""
    bq, bk = TILES[torch.bfloat16 if dtype_is_bf16 else torch.float32]
    rows, products = (16, 3) if dtype_is_bf16 else (bq, 2)
    units = 0                          # (rows x bk) blocks of work
    for i0 in range(0, S, bq):
        last = min(i0 + bq, S) - 1
        lo = max(0, i0 - window + 1) if window else 0
        for j0 in range(lo // bk * bk, last + 1, bk):
            for w0 in range(i0, i0 + bq, rows):
                skip = j0 > w0 + rows - 1 or (
                    window and j0 + bk - 1 <= w0 - window)
                units += not skip
    return units * rows * bk * D * 2 * products * B * H


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
