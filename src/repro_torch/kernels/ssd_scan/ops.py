"""Dispatch for the SSD intra-chunk dual form.

``ssd_intra_chunk`` takes the reference's model-layer interface
(``repro.kernels.ssd_scan.ops``): chunked (b, nc, l, h, ·) tensors in
the layout ``repro_torch.models.ssd.ssd_chunked`` makes them, and
returns y_diag (b, nc, l, h, p) fp32. CUDA tensors take the kernel,
CPU tensors the plain version (``ref``), and nothing else: the
tensors' device is the only switch. The kernel has no backward (the
reference's Pallas kernel defines no VJP), so a CUDA call that
autograd would record (grad mode on, an input that requires grad)
raises ``NotPortedError`` rather than drop that input's gradient. The kernel's launches are counted in
``ssd_intra_chunk.launches``.

B and C may carry g groups instead of h heads (g dividing h): the
kernel then reads head k's projections from group k // (h / g), and
the plain version repeats them onto the heads first, the copy the
reference makes with ``jnp.repeat`` — the same values either way.
The kernel reads x, B and C in fp32 or bf16 (the three in one dtype)
and widens them to fp32; dt and cs are fp32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.configs.base import NotPortedError
from repro_torch.kernels.ssd_scan import ref

MAX_P = 64                   # the kernel's output tile is 64 columns wide
MAX_BN = 65535               # grid z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signature
    declared (pointers and the stream as c_void_p, never as int)."""
    from repro_torch.kernels import cuda_build
    lib, _ = cuda_build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra_chunk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                    i, p]
    lib.ssd_intra_chunk.restype = i
    lib.ssd_scan_error_string.argtypes = [i]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(xc, dtc, cs, Bc, Cc):
    if xc.ndim != 5 or Bc.ndim != 5 or Cc.ndim != 5:
        raise ValueError("xc, Bc, Cc must be (b, nc, l, ·, ·)")
    b, nc, l, h, p = xc.shape
    g, n = Bc.shape[3], Bc.shape[4]
    if (dtc.shape != (b, nc, l, h) or cs.shape != (b, nc, l, h)
            or Bc.shape != (b, nc, l, g, n) or Cc.shape != Bc.shape):
        raise ValueError(
            f"shapes disagree: xc {tuple(xc.shape)}, dtc "
            f"{tuple(dtc.shape)}, cs {tuple(cs.shape)}, Bc "
            f"{tuple(Bc.shape)}, Cc {tuple(Cc.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    if xc.dtype not in _DTYPES or Bc.dtype != xc.dtype \
            or Cc.dtype != xc.dtype:
        raise ValueError(
            f"x, B, C must share one of {tuple(_DTYPES)}; got "
            f"{xc.dtype}, {Bc.dtype}, {Cc.dtype}")
    if dtc.dtype != torch.float32 or cs.dtype != torch.float32:
        raise ValueError(f"dt and cs must be float32, got {dtc.dtype}, "
                         f"{cs.dtype}")
    tensors = (xc, dtc, cs, Bc, Cc)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors only")
    if any(t.device != xc.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if not (1 <= p <= MAX_P and n >= 1 and l >= 1 and 1 <= b * nc <= MAX_BN
            and h <= 65535):
        raise ValueError(
            f"kernel takes 1 <= p <= {MAX_P}, n >= 1, l >= 1, "
            f"1 <= b·nc <= {MAX_BN}, h <= 65535; got (b·nc, l, h, p, n) "
            f"= {(b * nc, l, h, p, n)}")


def ssd_intra_chunk(xc: torch.Tensor, dtc: torch.Tensor, cs: torch.Tensor,
                    Bc: torch.Tensor, Cc: torch.Tensor) -> torch.Tensor:
    """xc: (b, nc, l, h, p); dtc, cs: (b, nc, l, h) fp32; Bc, Cc:
    (b, nc, l, g, n), g dividing h → y_diag (b, nc, l, h, p) fp32."""
    if not xc.is_cuda:
        return ref.ssd_intra_chunk(xc, dtc, cs, Bc, Cc)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dtc, cs, Bc, Cc)):
        raise NotPortedError(
            "ssd_intra_chunk has no backward on the card, as the reference "
            "kernel has no VJP; call it under torch.no_grad()")
    _check(xc, dtc, cs, Bc, Cc)
    b, nc, l, h, p = xc.shape
    g, n = Bc.shape[3], Bc.shape[4]
    out = torch.empty((b, nc, l, h, p), dtype=torch.float32,
                      device=xc.device)
    lib = _lib()
    status = lib.ssd_intra_chunk(
        xc.data_ptr(), dtc.data_ptr(), cs.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), out.data_ptr(), b * nc, l, h, g, p, n,
        _DTYPES[xc.dtype], xc.device.index,
        torch.cuda.current_stream(xc.device).cuda_stream)
    if status != 0:
        raise RuntimeError(
            f"ssd_intra_chunk launch failed: "
            f"{lib.ssd_scan_error_string(status).decode()}")
    ssd_intra_chunk.launches += 1
    return out


ssd_intra_chunk.launches = 0
