#!/usr/bin/env python3
"""``csrc/masked_reduce.cu`` in variants of its source, each built with
``nvcc`` and timed on the card at Q6's and F1u's shapes (run from the
repository root; the copies go under ``build/mr_bench/``):

    python3 tools/masked_reduce_bench.py [--variants base,lb6,step8]

A variant edits the source text (the launch bounds, the rows whose loads
are issued together, the block size, the blocks a launch) before building
it.  Every variant
but the "cut" ones (which drop the row loop or the last block's finish to
time the rest) is first held to the plain version on the shape it is
timed at; times are device times of calls queued behind a spin kernel
(``tools/kernel_ab.py`` ``time_ms``).  Prints one JSON line per variant
and shape, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "spark_rapids_tpu_torch" / "csrc" / "masked_reduce.cu"
OUT = ROOT / "build" / "mr_bench"
BOUNDS = "__launch_bounds__(MR_THREADS)"
VARIANTS = {
    "base": [],
    "lb4": [(BOUNDS, "__launch_bounds__(MR_THREADS, 4)")],
    "lb6": [(BOUNDS, "__launch_bounds__(MR_THREADS, 6)")],
    "step8": [("#define MR_STEP 16", "#define MR_STEP 8")],
    "step8_lb6": [("#define MR_STEP 16", "#define MR_STEP 8"),
                  (BOUNDS, "__launch_bounds__(MR_THREADS, 6)")],
    "step4_lb8": [("#define MR_STEP 16", "#define MR_STEP 4"),
                  (BOUNDS, "__launch_bounds__(MR_THREADS, 8)")],
    "threads128_lb8": [("#define MR_THREADS 256", "#define MR_THREADS 128"),
                       (BOUNDS, "__launch_bounds__(MR_THREADS, 8)")],
    "grid1": [("blocks = sms * (per_sm > 0 ? per_sm : 1);",
               "blocks = sms;")],
    "grid2": [("blocks = sms * (per_sm > 0 ? per_sm : 1);",
               "blocks = sms * 2;")],
    # "cut" variants drop a part of the kernel to time the rest: their
    # results are wrong and not checked
    "cut_loop": [("    if (m == 0) continue;", "    continue;")],
    "cut_finish": [("  if (!s_last) return;", "  return;")],
}


def build(names, flags):
    """One nvcc per variant, all started together; {name: library}."""
    jobs = {}
    for name in names:
        text = SRC.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "masked_reduce.cu").write_text(text)
        lib = d / "libmasked_reduce.so"
        jobs[name] = (subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *flags, "-o", str(lib),
             str(d / "masked_reduce.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        libs[name] = (lib, regs)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.ops import groupby
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", ROOT / "tools" / "kernel_ab.py")
    kab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kab)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    names = args.variants.split(",")
    libs = build(names, [f for f in kernels.NVCC_FLAGS])
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n = 4 << 20
    x = t(rng.uniform(900.0, 105000.0, n) * 0.06)
    day = t(rng.integers(8036, 10_600, n))
    key = t(rng.integers(1, 60_000_000, n))
    q6 = [t(rng.random(n) < 0.02)]
    f1u = [t(rng.random(n) < 203_181 / n), t(rng.random(n) < 0.25),
           t(rng.random(n) < 0.5)]
    shapes = {
        "q6": (q6, lambda c: ([(x, None, "sum"), (None, None, "count")],
                              c[0]), [("sum", True), ("sum", False)]),
        "f1u": (f1u, lambda c: ([(day, None, "first"), (key, None, "last"),
                                 (key, c[1], "first"), (day, c[2], "last"),
                                 (x, None, "last")], c[0]),
                [("first", False)] * 4 + [("last", True)])}
    for name in names:
        path, regs = libs[name]
        lib = ctypes.CDLL(str(path))
        lib.masked_reduce.argtypes = \
            kernels._SIGNATURES["masked_reduce"]["masked_reduce"]
        lib.masked_reduce.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        kernels._libs["masked_reduce"] = lib
        groupby._MR_SCRATCH.clear()  # a fresh ticket for each library
        for shape, (cols, make, specs) in shapes.items():
            accs = []
            for fn in (groupby.masked_reduce, groupby.masked_reduce_plain):
                acc_f, acc_i = groupby.init_scalars(specs, dev)
                acc = (acc_f, acc_i, torch.zeros_like(acc_i))
                fn(*make(cols), *acc)
                accs.append(acc)
            torch.cuda.synchronize()
            (kf, ki, kh), (pf, pi, ph) = accs
            err = float((kf - pf).abs().max())
            if not name.startswith("cut_") and not (
                    torch.equal(ki, pi) and torch.equal(kh, ph)
                    and err <= 1e-9 * float(pf.abs().max())):
                print(f"masked_reduce_bench: {name} differs from plain at "
                      f"{shape}", file=sys.stderr)
                return 1
            acc = accs[0]
            inputs = kab.copies(cols, 8)
            ms = kab.time_ms(torch, [lambda c=c: groupby.masked_reduce(
                *make(c), *acc) for c in inputs], reps=8 * len(inputs))
            print(json.dumps({"variant": name, "shape": shape, "ms": ms,
                              "ptxas": regs, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
