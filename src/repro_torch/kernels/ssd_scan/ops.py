"""Dispatch for the SSD intra-chunk dual form.

``ssd_intra_chunk`` takes the reference's model-layer interface
(``repro.kernels.ssd_scan.ops``): chunked (b, nc, l, h, ·) tensors in
the layout ``repro_torch.models.ssd.ssd_chunked`` makes them, and
returns y_diag (b, nc, l, h, p) fp32. CUDA tensors take the kernel,
CPU tensors the plain version (``ref``), meta tensors the kernel op's
shape function (below), and nothing else: the tensors' device is the
only switch. The kernel has no backward (the
reference's Pallas kernel defines no VJP), so a CUDA call that
autograd would record (grad mode on, an input that requires grad)
raises ``NotPortedError`` rather than drop that input's gradient; such a
pass calls ``ssd_intra_chunk_with_vjp``, the kernel's forward with the
plain version's vector-Jacobian product (``kernels.plain_vjp``). The
kernel's launches are counted in ``ssd_intra_chunk.launches``.

B and C may carry g groups instead of h heads (g dividing h): the
kernel then reads head k's projections from group k // (h / g), and
the plain version repeats them onto the heads first, the copy the
reference makes with ``jnp.repeat`` — the same values either way.
x, B and C come in fp32 or bf16 (the three in one dtype); dt and cs
are fp32. On the card the dtype picks the kernel of
``csrc/ssd_scan.cu``, and nothing falls back from one to the other:

- **bf16** takes the tensor-core kernel: C·Bᵀ by bf16 ``mma.sync``
  into fp32, per column tile once for a block's 1 to 3 heads (all in
  one group), kept in registers; per head S = (C·Bᵀ)·exp(cs_i −
  cs_j)·dt_j in fp32, then S·x as two bf16 products, S_hi·x + S_lo·x
  with S_hi = bf16(S) and S_lo = bf16(S − S_hi) (one bf16 S leaves the
  1e-5·Σ|terms| gate ~120-fold). Its ``cp.async`` copies need x, B
  and C 16-byte aligned (``data_ptr``); every tensor the model builds
  is, and one that is not raises ``ValueError``.
- **fp32** takes the CUDA-core kernel (IEEE fp32 FMAs): the tensor
  cores would round fp32 inputs to TF32.

The launch geometry (``ssd_geometry``) is computed here, where the
CPU tests can hold it, and the kernel refuses one that does not cover
every (chunk, row tile, head) once.

Card tensors launch the kernel straight through ``ctypes`` (and count
the launch). Meta or fake tensors (the dry run,
``repro_torch.roofline.trace``) go to the custom op
``torch.ops.repro_torch.ssd_intra_chunk`` instead, whose shape function
returns a y_diag of the kernel's shape and dtype and computes nothing,
and which ``FlopCounterMode`` counts by :func:`ssd_flops` (the op's own
implementation is the same launch). :func:`ssd_flops`,
:func:`ssd_bytes` and :func:`ssd_bound` also price the kernel's least
time in ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.configs.base import NotPortedError
from repro_torch.kernels.plain_vjp import with_plain_vjp
from repro_torch.kernels.ssd_scan import ref
from repro_torch.roofline import constants as C

MAX_P = 64                   # the kernel's output tile is 64 columns wide
MAX_BN = 65535               # grid y (heads) and z (chunks)
TILE = 64                    # rows and columns of a tile, both kernels
MAX_HEADS = 3                # bf16 heads per block (tc::MAX_HB)
SMS = 132                    # H100 SXM
# bf16 blocks of each head count that one SM holds (registers and shared
# memory; chip_smoke.py checks them on the card)
BLOCKS_PER_SM = {1: 3, 2: 3, 3: 2}
ALIGN = 16                   # bytes, for the bf16 kernel's cp.async
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class SsdGeometry(NamedTuple):
    heads: int                       # heads per block, all in one group
    grid: Tuple[int, int, int]       # (x, y, z) blocks


def ssd_geometry(bn: int, l: int, h: int, g: int,
                 dtype: torch.dtype) -> SsdGeometry:
    """fp32: one block per (row tile, head, chunk). bf16: one block per
    (pair of row tiles it and tiles − 1 − it, set of heads, chunk), so
    every block walks tiles + 1 column tiles (an odd count leaves the
    middle tile alone). The heads per block (at most ``MAX_HEADS``)
    divide h / g, so a set never straddles a group: the most whose grid
    has a block for each of the ``SMS`` SMs and fits in one wave of
    ``BLOCKS_PER_SM`` blocks on each (C·Bᵀ is formed once per block and
    shared by its heads); a grid too small to fill the SMs takes one
    head a block, one past a wave whatever the heads the most. A grid
    past CUDA's limits raises ``ValueError``."""
    if not (1 <= bn <= MAX_BN and 1 <= h <= MAX_BN and l >= 1 and g >= 1
            and h % g == 0):
        raise ValueError(f"no grid for (b·nc, l, h, g) = {(bn, l, h, g)}: "
                         f"the kernel takes 1 <= b·nc <= {MAX_BN}, l >= 1, "
                         f"h <= {MAX_BN} and g dividing h")
    tiles = -(-l // TILE)
    if dtype == torch.float32:
        return SsdGeometry(1, (tiles, h, bn))
    pairs = -(-tiles // 2)
    sizes = [k for k in range(1, MAX_HEADS + 1) if (h // g) % k == 0]
    fill = [k for k in sizes
            if SMS <= bn * pairs * (h // k) <= SMS * BLOCKS_PER_SM[k]]
    if fill:
        heads = fill[-1]
    else:
        heads = 1 if bn * pairs * h < SMS else sizes[-1]
    return SsdGeometry(heads, (pairs, h // heads, bn))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signature
    declared (pointers and the stream as c_void_p, never as int)."""
    from repro_torch.kernels import cuda_build
    lib, _ = cuda_build.load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra_chunk.argtypes = [p] * 6 + [i] * 11 + [p]
    lib.ssd_intra_chunk.restype = i
    lib.ssd_bf16_blocks_per_sm.argtypes = [i, i, p]
    lib.ssd_bf16_blocks_per_sm.restype = i
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
    if (xc.dtype == torch.bfloat16 and not xc.is_meta
            and not is_fake(xc)):
        for name, t in (("x", xc), ("B", Bc), ("C", Cc)):
            if t.data_ptr() % ALIGN:
                raise ValueError(
                    f"the bf16 kernel needs {name} {ALIGN}-byte aligned "
                    f"(cp.async): data_ptr % {ALIGN} = "
                    f"{t.data_ptr() % ALIGN}")


def ssd_intra_chunk(xc: torch.Tensor, dtc: torch.Tensor, cs: torch.Tensor,
                    Bc: torch.Tensor, Cc: torch.Tensor) -> torch.Tensor:
    """xc: (b, nc, l, h, p); dtc, cs: (b, nc, l, h) fp32; Bc, Cc:
    (b, nc, l, g, n), g dividing h → y_diag (b, nc, l, h, p) fp32."""
    if xc.device.type == "cpu":
        return ref.ssd_intra_chunk(xc, dtc, cs, Bc, Cc)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dtc, cs, Bc, Cc)):
        raise NotPortedError(
            "ssd_intra_chunk has no backward on the card, as the reference "
            "kernel has no VJP; call it under torch.no_grad()")
    _check(xc, dtc, cs, Bc, Cc)
    if xc.is_meta or is_fake(xc):                # the op's shape function
        return torch.ops.repro_torch.ssd_intra_chunk(xc, dtc, cs, Bc, Cc)
    return _launch(xc, dtc, cs, Bc, Cc)


def _launch(xc: torch.Tensor, dtc: torch.Tensor, cs: torch.Tensor,
            Bc: torch.Tensor, Cc: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on checked card tensors."""
    b, nc, l, h, p = xc.shape
    g, n = Bc.shape[3], Bc.shape[4]
    geo = ssd_geometry(b * nc, l, h, g, xc.dtype)
    out = torch.empty((b, nc, l, h, p), dtype=torch.float32,
                      device=xc.device)
    lib = _lib()
    status = lib.ssd_intra_chunk(
        xc.data_ptr(), dtc.data_ptr(), cs.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), out.data_ptr(), b * nc, l, h, g, p, n, geo.heads,
        geo.grid[0], geo.grid[1], _DTYPES[xc.dtype], xc.device.index,
        torch.cuda.current_stream(xc.device).cuda_stream)
    _raise_on(lib, status, "launch")
    ssd_intra_chunk.launches += 1
    return out


_op = torch.library.custom_op("repro_torch::ssd_intra_chunk", _launch,
                              mutates_args=())


@_op.register_fake
def _(xc, dtc, cs, Bc, Cc):
    b, nc, l, h, p = xc.shape
    ssd_geometry(b * nc, l, h, Bc.shape[3], xc.dtype)   # raises as a launch
    return xc.new_empty((b, nc, l, h, p), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_intra_chunk, get_raw=True)
def _(xc, dtc, cs, Bc, Cc, out_val=None):
    b, nc, l, h, p = xc.shape
    return ssd_flops(b * nc, l, h, p, Bc.shape[4], Bc.shape[3],
                     xc.element_size())


ssd_intra_chunk.launches = 0


def ssd_intra_chunk_with_vjp(xc: torch.Tensor, dtc: torch.Tensor,
                             cs: torch.Tensor, Bc: torch.Tensor,
                             Cc: torch.Tensor) -> torch.Tensor:
    """:func:`ssd_intra_chunk` that autograd can differentiate: the
    forward is the wrapper's (the kernel on the card), the backward the
    VJP of the plain version (``ref.ssd_intra_chunk``, the einsum form
    the reference trains with) at the same inputs."""
    return with_plain_vjp(ssd_intra_chunk, ref.ssd_intra_chunk,
                          (xc, dtc, cs, Bc, Cc))


def _ssd_terms(bn, l, h, p, n, g):
    """(score, S·x, decay) operations of one call over the l(l+1)/2
    causal (i, j) pairs of a chunk: the score C_i·B_j, 2n operations
    once per (chunk, group), since B and C are shared by the heads of a
    group; per (chunk, head) the product with x_j (2p), and the decay
    exp(cs_i − cs_j) and its products (3), plus l·p to fold dt_j into
    x_j."""
    pairs = l * (l + 1) // 2
    return (bn * g * pairs * 2 * n, bn * h * pairs * 2 * p,
            bn * h * (pairs * 3 + l * p))


def ssd_flops(bn, l, h, p, n, g, esize) -> int:
    """Operations of one call (:func:`_ssd_terms`); with bf16 inputs S·x
    is two products, S_hi·x + S_lo·x (S is fp32 in the reference, and
    one bf16 S leaves the gate)."""
    score, sx, decay = _ssd_terms(bn, l, h, p, n, g)
    return score + (2 if esize == 2 else 1) * sx + decay


def ssd_bytes(bn, l, h, p, n, g, esize) -> int:
    """Each input read once, the fp32 output written once."""
    return (bn * l * h * p * esize + 2 * bn * l * g * n * esize
            + 2 * bn * l * h * 4 + bn * l * h * p * 4)


def ssd_bound(bn, l, h, p, n, g, esize, split_sx=True):
    """Least time (ms) of one call on the card, the larger of operations
    and bytes, and which one it is. With bf16 inputs the score is one
    bf16 product (bf16 products are exact in fp32, the sums stay fp32)
    and S·x two, at the bf16 tensor-core rate; the decay at the fp32
    rate. ``split_sx=False`` prices a bf16 S·x at the fp32 rate instead,
    the pricing of an S·x on the CUDA cores. With fp32 inputs everything
    runs at the fp32 rate (TF32 would round them). Bytes
    (:func:`ssd_bytes`) at the HBM rate (``roofline.constants``)."""
    score, sx, decay = _ssd_terms(bn, l, h, p, n, g)
    bf16, fp32 = C.PEAK_FLOPS_BF16, C.PEAK_FLOPS_FP32
    if esize == 2 and split_sx:
        ops_ms = ((score + 2 * sx) / bf16 + decay / fp32) * 1e3
    elif esize == 2:
        ops_ms = (score / bf16 + (sx + decay) / fp32) * 1e3
    else:
        ops_ms = (score + sx + decay) / fp32 * 1e3
    bytes_ms = ssd_bytes(bn, l, h, p, n, g, esize) / C.HBM_BW * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def _raise_on(lib, status, what):
    if status != 0:
        raise RuntimeError(f"ssd_intra_chunk {what} failed: "
                           f"{lib.ssd_scan_error_string(status).decode()}")


def blocks_per_sm(heads: int, device: int = 0) -> int:
    """Blocks of the bf16 kernel with ``heads`` heads per block that one
    SM of card ``device`` holds at once (registers, shared memory and
    threads)."""
    lib = _lib()
    blocks = ctypes.c_int(0)
    _raise_on(lib, lib.ssd_bf16_blocks_per_sm(heads, device,
                                              ctypes.byref(blocks)),
              "occupancy query")
    return blocks.value
