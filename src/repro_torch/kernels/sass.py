"""What the compiler made of a kernel source: its SASS, per kernel.

    python -m repro_torch.kernels.sass SRC.cu [SRC.cu ...] \\
        [--kernels NAME,NAME] [--out DIR]

compiles each CUDA source to a cubin for sm_90a with the flags
``cuda_build`` uses (ptxas's register and spill report included),
disassembles it with ``cuobjdump -sass`` and prints, for each kernel
whose name contains one of ``--kernels``: its instruction count by
opcode and, for each loop (a backward branch), the loop body as a run
of opcodes with repeats folded (``LDG.E.S8 x8 I2F x8 ...``) and its
global loads before the first floating-point add. The full listing of
each source goes to ``DIR/<source>.sass`` (give two versions of one
source two ``--out`` directories). Needs ``nvcc`` and
``cuobjdump``, so it runs on the machine with the card.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import cuda_build

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def compile_cubin(src: Path, out_dir: Path) -> Tuple[Path, str]:
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / f"{src.stem}.cubin"
    proc = subprocess.run(
        [cuda_build.nvcc_path(), "-Xptxas", "-v", *cuda_build.ARCH_FLAGS,
         "-std=c++17", "-O3", "-cubin", "-o", str(cubin), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=False)
    if proc.returncode != 0:
        raise cuda_build.KernelBuildError(f"nvcc failed for {src}:\n"
                                          f"{proc.stdout}")
    return cubin, proc.stdout


def disassemble(cubin: Path) -> Tuple[str, Dict[str, List[Tuple[int, str,
                                                                  str]]]]:
    """(listing, {mangled kernel: [(address, opcode, operands)]})."""
    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    kernels: Dict[str, List[Tuple[int, str, str]]] = {}
    current = None
    for line in text.splitlines():
        func = _FUNC.search(line)
        if func:
            current = kernels.setdefault(func.group(1), [])
            continue
        insn = _INSN.search(line)
        if insn and current is not None:
            current.append((int(insn.group(1), 16), insn.group(2),
                            insn.group(3)))
    return text, kernels


def fold(ops: List[str]) -> str:
    """Opcodes with runs of one opcode folded: ``LDG x8 FADD ...``."""
    out, i = [], 0
    while i < len(ops):
        j = i
        while j < len(ops) and ops[j] == ops[i]:
            j += 1
        out.append(ops[i] if j - i == 1 else f"{ops[i]} x{j - i}")
        i = j
    return " ".join(out)


def loops(insns: List[Tuple[int, str, str]]) -> List[Tuple[int, int]]:
    """(start, end) indices of each loop body: a branch to an earlier
    address closes the body that starts there."""
    index = {addr: k for k, (addr, _, _) in enumerate(insns)}
    found = []
    for k, (addr, op, rest) in enumerate(insns):
        if op.startswith("BRA"):
            target = _TARGET.search(rest)
            if target and int(target.group(1), 16) < addr:
                start = index.get(int(target.group(1), 16))
                if start is not None:
                    found.append((start, k))
    return found


def report(kernels, wanted: List[str]) -> List[str]:
    lines = []
    for name, insns in kernels.items():
        if wanted and not any(w in name for w in wanted):
            continue
        counts = Counter(op.split(".")[0] for _, op, _ in insns)
        lines.append(f"[sass] {name}: {len(insns)} instructions; "
                     + ", ".join(f"{op} {c}" for op, c in
                                 counts.most_common()))
        for start, end in loops(insns):
            body = [op for _, op, _ in insns[start:end + 1]]
            first_add = next((k for k, op in enumerate(body)
                              if op.split(".")[0] in ("FADD", "FFMA")),
                             len(body))
            loads = sum(op.startswith("LDG") for op in body[:first_add])
            lines.append(f"[sass]   loop of {len(body)} instructions, "
                         f"{sum(op.startswith('LDG') for op in body)} "
                         f"global loads ({loads} before the first fp add): "
                         f"{fold(body)}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--kernels", default="",
                    help="comma-separated substrings of kernel names")
    ap.add_argument("--out", type=Path,
                    default=cuda_build.BUILD_DIR / "sass")
    args = ap.parse_args(argv)
    wanted = [w for w in args.kernels.split(",") if w]
    for src in args.sources:
        cubin, log = compile_cubin(src.resolve(), args.out)
        listing, kernels = disassemble(cubin)
        (args.out / f"{cubin.stem}.sass").write_text(listing)
        print(f"[sass] {src}: {len(kernels)} kernels, listing in "
              f"{args.out / (cubin.stem + '.sass')}")
        for kernel, regs, stores, loads in cuda_build.ptxas_report(log):
            print(f"[sass]   ptxas {kernel}: {regs} registers, spill "
                  f"stores {stores} B, spill loads {loads} B")
        for line in report(kernels, wanted):
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
