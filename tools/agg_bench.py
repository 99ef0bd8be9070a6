#!/usr/bin/env python3
"""Device times of variants of the kernel sources on one CUDA card, at
``tools/kernel_ab.py``'s shapes: for ``csrc/hash_agg.cu`` the hash
aggregate's update (Q21's keys, Q18's float64 sum and count, F1's
FIRST/LAST, Q9's and Q7's few groups, one group) with the merge (Q18's
final in one call and in 64 buckets); for ``csrc/dense_join.cu`` the
build and probe at Q3's, Q18's semi and a fully live shape; for
``csrc/window_scan.cu`` W1's window context and running sum; the base
variant times the grid at Q1's shape too.  A variant of another source is
one more entry in VARIANTS.

    python3 tools/agg_bench.py [--variants base,sm2,sm8,nocache]

Each variant is a copy of ``spark_rapids_tpu_torch/csrc`` under
``build/agg_variants/<name>/`` with one define changed, built and timed
in a process of its own (a kernel library is loaded once a process):

  * ``base``: the checkout's sources (every shape);
  * ``sm<k>``: ``hash_agg.cu``'s ``HA_BLOCKS_PER_SM`` k (blocks an SM of
    the update);
  * ``nocache``: ``hash_agg.cu`` without its shared-memory cache of
    groups (``HA_CACHE_BYTES`` 0);
  * ``dj_base``, ``ws_base``: the checkout's sources, timed for
    ``dense_join.cu``'s or ``window_scan.cu``'s shapes only;
  * ``dj_rows8``: ``dense_join.cu``'s probe with 8 rows a thread
    (``DJ_ROWS``) against the sources' 4;

Prints kernel_ab's JSON lines, labelled with the variant.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# variant: (source, {define: value})
VARIANTS = {"base": (None, {}),
            "sm2": ("hash_agg.cu", {"HA_BLOCKS_PER_SM": "2"}),
            "sm3": ("hash_agg.cu", {"HA_BLOCKS_PER_SM": "3"}),
            "sm6": ("hash_agg.cu", {"HA_BLOCKS_PER_SM": "6"}),
            "sm8": ("hash_agg.cu", {"HA_BLOCKS_PER_SM": "8"}),
            "nocache": ("hash_agg.cu", {"HA_CACHE_BYTES": "0"}),
            "dj_base": ("dense_join.cu", {}),
            "dj_rows8": ("dense_join.cu", {"DJ_ROWS": "8"}),
            "ws_base": ("window_scan.cu", {})}


def make_variant(name: str) -> Path:
    out = ROOT / "build" / "agg_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / "spark_rapids_tpu_torch" / "csrc", out)
    source, defines = VARIANTS[name]
    if source is not None:
        src = (out / source).read_text()
        for key, value in defines.items():
            src, n = re.subn(rf"#define {key} [^/\n]*",
                             f"#define {key} {value} ", src)
            if n != 1:
                raise SystemExit(f"agg_bench: no #define {key}")
        (out / source).write_text(src)
    return out


def run_variant(name: str, csrc: str) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import json

    import numpy as np
    import torch
    import kernel_ab
    from spark_rapids_tpu_torch import kernels
    from spark_rapids_tpu_torch.ops import groupby
    kernels.CSRC = Path(csrc)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()

    def emit(what, ms, **extra):
        print(json.dumps({"label": name, "what": what, "ms": ms, **extra,
                          "device": smi}), flush=True)
    dev = torch.device("cuda")
    source = VARIANTS[name][0]
    rc = 0
    if source in (None, "hash_agg.cu"):
        rc |= kernel_ab.time_hash_agg(torch, dev, groupby, emit)
        kernel_ab.time_merge(torch, dev, np.random.default_rng(18), groupby,
                             emit)
    if source in (None, "grid_agg.cu"):
        rc |= kernel_ab.time_grid_agg(torch, dev, groupby, emit)
    if source in (None, "dense_join.cu"):
        rc |= kernel_ab.time_dense_join(torch, dev, emit)
    if source in (None, "window_scan.cu"):
        rc |= kernel_ab.time_window_scan(torch, dev, emit)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants",
                    default="base,sm2,sm8,nocache")
    ap.add_argument("--run", nargs=2, metavar=("NAME", "CSRC"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        return run_variant(*args.run)
    rc = 0
    for name in args.variants.split(","):
        csrc = make_variant(name)
        rc |= subprocess.call([sys.executable, __file__, "--run", name,
                               str(csrc)])
    return rc


if __name__ == "__main__":
    sys.exit(main())
