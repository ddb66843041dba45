"""Where the bf16 SSD kernel's time goes, ring item by ring item, on the card.

    python -m repro_torch.kernels.ssd_scan.trace [--shape B,NC,L,H,P,N,G] \
        [--heads HB]

builds a copy of ``csrc/ssd_scan.cu`` in which thread 0 of every block
writes ``%globaltimer`` stamps (ns) when the block starts, at the top of
the ring loop, after that item's wait and barrier, and when the block
ends; runs the bf16 kernel at the shape (mamba2-780m's prefill, (2, 4,
256, 48, 64, 128, 1), by default; inputs drawn as the reference's test
draws them, from seed 0) with the heads per block ``ssd_geometry``
gives (or ``--heads``), and prints the blocks' start and end spread and, for each ring
item of the first pass, the median over blocks of its wait (the
``cp.async`` wait and the barrier) and of its own time (from the end of
its wait to the top of the next item). Run with fewer blocks than SMs
(``--shape 1,2,256,48,64,128,1 --heads 3``), it shows what a block takes
with an SM to itself. The stamps cost a few instructions per item.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ssd_scan import ops

SLOTS = 64                   # stamps a block keeps: 2 per item, 2 more
_STAMP = ("__device__ unsigned long long g_stamps[{blocks} * 2 * {slots}];\n"
          "__device__ __forceinline__ unsigned long long stamp() {{\n"
          "  unsigned long long t;\n"
          "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
          "  return t;\n}}\n")
# (anchor in the source, text that replaces it); each anchor occurs once
_EDITS = [
    ("namespace {\n", None),          # the stamps' storage goes first
    ("  const int pair = blockIdx.x;\n",
     "  const int pair = blockIdx.x;\n"
     "  const long long blk = blockIdx.x + gridDim.x * (blockIdx.y"
     " + static_cast<long long>(gridDim.y) * blockIdx.z);\n"
     "  unsigned long long* mine = g_stamps + blk * 2 * {slots};\n"
     "  int item = 0;\n"
     "  if (tid == 0) mine[0] = stamp();\n"),
    ("        cp_async_wait_ring();\n        __syncthreads();",
     "        const bool log = tid == 0 && item < {slots} - 1;\n"
     "        if (log) mine[2 * item + 2] = stamp();\n"
     "        cp_async_wait_ring();\n        __syncthreads();\n"
     "        if (log) mine[2 * item + 3] = stamp();\n"
     "        ++item;"),
    ("      }\n    }\n  }\n}\n\n// The instance",
     "      }\n    }\n  }\n  if (tid == 0) mine[1] = stamp();\n}\n\n"
     "// The instance"),
    ("extern \"C\" const char* ssd_scan_error_string",
     "extern \"C\" int ssd_stamps(void* host, long long bytes) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_stamps, bytes);\n}\n\n"
     "extern \"C\" const char* ssd_scan_error_string"),
]


def instrumented(source: str, blocks: int) -> str:
    """``source`` with the stamps written in."""
    for anchor, text in _EDITS:
        if source.count(anchor) != 1:
            raise ValueError(f"the kernel source no longer has one {anchor!r}"
                             f"; update the trace's anchors")
        text = (_STAMP.format(blocks=blocks, slots=SLOTS) + anchor
                if text is None else text.replace("{slots}", str(SLOTS)))
        source = source.replace(anchor, text)
    return source


def inputs(shape, seed=0):
    b, nc, l, h, p, n, g = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*s):
        return torch.randn(s, generator=gen, device="cuda")

    x, dt = normal(b, nc, l, h, p), torch.nn.functional.softplus(
        normal(b, nc, l, h))
    cs = torch.cumsum(dt * -torch.exp(normal(h)), dim=2)
    bf = torch.bfloat16
    return [x.to(bf), dt, cs, normal(b, nc, l, g, n).to(bf),
            normal(b, nc, l, g, n).to(bf)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="2,4,256,48,64,128,1")
    ap.add_argument("--heads", type=int, help="heads per block")
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split(","))
    b, nc, l, h, p, n, g = shape
    geo = ops.ssd_geometry(b * nc, l, h, g, torch.bfloat16)
    if args.heads:
        geo = ops.SsdGeometry(args.heads, (geo.grid[0], h // args.heads,
                                           b * nc))
    gx, gy, gz = geo.grid
    blocks = gx * gy * gz
    src = instrumented(cuda_build.source_of("ssd_scan").read_text(), blocks)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as tmp:
        cu, so = Path(tmp) / "ssd_trace.cu", Path(tmp) / "ssd_trace.so"
        cu.write_text(src)
        subprocess.run([cuda_build.nvcc_path(), *cuda_build.ARCH_FLAGS,
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-o", str(so), str(cu)], check=True)
        lib = ctypes.CDLL(str(so))
    pp, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra_chunk.argtypes = [pp] * 6 + [i] * 11 + [pp]
    lib.ssd_intra_chunk.restype = i
    lib.ssd_stamps.argtypes = [pp, ctypes.c_longlong]
    lib.ssd_stamps.restype = i
    xc, dtc, cs, Bc, Cc = inputs(shape)
    out = torch.empty((b, nc, l, h, p), dtype=torch.float32, device="cuda")
    for _ in range(3):                   # the last launch's stamps stay
        status = lib.ssd_intra_chunk(
            xc.data_ptr(), dtc.data_ptr(), cs.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), out.data_ptr(), b * nc, l, h, g, p, n, geo.heads,
            gx, gy, 1, torch.cuda.current_device(),
            torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"launch failed: {status}")
    torch.cuda.synchronize()
    stamps = np.zeros(blocks * 2 * SLOTS, dtype=np.uint64)
    if lib.ssd_stamps(stamps.ctypes.data, stamps.nbytes):
        raise RuntimeError("could not read the stamps back")
    t = stamps.reshape(blocks, 2 * SLOTS).astype(np.int64)
    start, end = t[:, 0] - t[:, 0].min(), t[:, 1] - t[:, 0].min()
    print(f"[trace] bf16 SSD at (b, nc, l, h, p, n, g) = {shape}: "
          f"{geo.heads} heads a block, grid {gx} x {gy} x {gz} = {blocks} "
          f"blocks; starts {start.min()}..{start.max()} ns, ends "
          f"{end.min()}..{end.max()} ns, median block "
          f"{int(np.median(end - start))} ns")
    # the blocks of the first row-tile pair, whose first pass is the longest
    # row tile: the items of its first window of column tiles
    first = t[np.arange(blocks) % gx == 0]
    tiles = -(-l // ops.TILE)
    items = min(tiles, 4) * (-(-n // 64) + 1)
    top, after = first[:, 2::2], first[:, 3::2]
    nxt = np.where(top[:, 1:items + 1] > 0, top[:, 1:items + 1],
                   first[:, 1:2])
    wait = np.median(after[:, :items] - top[:, :items], axis=0)
    own = np.median(nxt - after[:, :items], axis=0)
    print(f"[trace] longest row tile, first {items} ring items (per column "
          f"tile its C / B chunks, then the heads' x tiles): median wait ns "
          f"{wait.astype(int).tolist()}; median own time ns "
          f"{own.astype(int).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
