#!/usr/bin/env python3
"""Instructions a row of one kernel's row loop, by pipe, from its SASS.

    python3 tools/sass_count.py [--source sample] [--function sample_mask_k]

Builds ``spark_rapids_tpu_torch/csrc/<source>.cu`` as the port builds it
(``kernels.build``), disassembles the library with ``cuobjdump -sass``,
finds the named kernel's row loop (the instructions from the target of its
backward branch to that branch) and counts its instructions by opcode and
by the pipe that issues them: ``alu`` (32-bit integer logic, shift,
compare, select, move: the ALU pipe only), ``add`` (32-bit integer adds,
which the ALU pipe or, as IMAD, the FMA pipe issues), ``fma`` (IMAD and
its forms, issued to the FMA pipe), ``fp64``, ``memory``, ``control`` and
``other``.  Rows a loop trip: the byte stores of the row's output
(``STG.E.U8``).  ``clocks_a_row``: the least issue time of the row's
integer instructions an SM, the larger of ``alu`` at 64 a clock and
``alu + add + fma`` at 128 (two pipes of 64, compute capability 9.0): a
floor of this compiled code, not of the function.  Prints one JSON line.
Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ALU = ("LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "LEA", "SEL", "PRMT",
       "IMNMX", "IABS", "MOV", "BMSK", "SGXT", "PLOP3", "P2R", "R2P",
       "VIMNMX")
ADD = ("IADD3", "IADD", "VIADD")
FMA = ("IMAD",)
FP64 = ("DADD", "DMUL", "DFMA", "DSETP")
MEMORY = ("LDG", "STG", "LDS", "STS", "LD", "ST", "ATOM", "RED", "LDC",
          "ULDC")
CONTROL = ("BRA", "EXIT", "BSSY", "BSYNC", "BAR", "RET", "CALL", "WARPSYNC",
           "NOP", "YIELD")

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                  r"\s*([^;]*);")


def pipe(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in (("fma", FMA), ("fp64", FP64), ("alu", ALU),
                      ("add", ADD), ("memory", MEMORY),
                      ("control", CONTROL)):
        if base in ops:
            return name
    return "other"


def function_sass(sass: str, function: str):
    """(address, opcode, operands) of the named function's instructions,
    and its labels' addresses (a branch may name its target by label)."""
    out, labels, pending, inside = [], {}, [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        if not inside:
            continue
        lab = re.match(r"\s*(\.L\w+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = LINE.search(line)
        if m:
            at = int(m.group(1), 16)
            for name in pending:
                labels[name] = at
            pending = []
            out.append((at, m.group(3), m.group(4)))
    return out, labels


def branch_target(operands: str, labels: dict):
    m = re.search(r"(\.L\w+)", operands)
    if m:
        return labels.get(m.group(1))
    m = re.search(r"0x([0-9a-f]+)", operands)
    return int(m.group(1), 16) if m else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="sample")
    ap.add_argument("--function", default="sample_mask_k")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from spark_rapids_tpu_torch import kernels
    kernels.build([args.source])
    lib = kernels._library_path(args.source)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    code, labels = function_sass(sass, args.function)
    if not code:
        print(f"sass_count: no SASS for {args.function}", file=sys.stderr)
        return 1
    loops = []
    for at, op, operands in code:
        to = branch_target(operands, labels) if op.startswith("BRA") \
            else None
        if to is not None and to < at:
            loops.append((to, at))
    if not loops:
        print(f"sass_count: {args.function} has no backward branch",
              file=sys.stderr)
        return 1
    head, tail = max(loops, key=lambda lt: lt[1] - lt[0])
    body = [op for at, op, _ in code if head <= at <= tail]
    by_op, by_pipe = {}, {}
    for op in body:
        by_op[op] = by_op.get(op, 0) + 1
        by_pipe[pipe(op)] = by_pipe.get(pipe(op), 0) + 1
    rows = sum(1 for op in body if op.startswith("STG") and ".U8" in op) or 1
    alu = by_pipe.get("alu", 0) / rows
    ints = alu + (by_pipe.get("add", 0) + by_pipe.get("fma", 0)) / rows
    print(json.dumps({
        "source": args.source, "function": args.function,
        "loop": [hex(head), hex(tail)], "instructions": len(body),
        "rows_a_trip": rows,
        "by_pipe_a_row": {k: v / rows for k, v in sorted(by_pipe.items())},
        "clocks_a_row": max(alu / 64, ints / 128),
        "by_opcode": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
        "total_instructions_in_function": len(code)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
