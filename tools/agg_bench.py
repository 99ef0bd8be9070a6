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
``build/agg_variants/<name>/`` with one define changed (or its zero tail
left out), built and timed in a process of its own (a kernel library is
loaded once a process):

  * ``base``: the checkout's sources (every shape);
  * ``sm<k>``: ``hash_agg.cu``'s ``HA_BLOCKS_PER_SM`` k (blocks an SM of
    the update);
  * ``nocache``: ``hash_agg.cu`` without its shared-memory cache of
    groups (``HA_CACHE_BYTES`` 0);
  * ``dj_base``, ``ws_base``: the checkout's sources, timed for
    ``dense_join.cu``'s or ``window_scan.cu``'s shapes only;
  * ``dj_rows8``: ``dense_join.cu``'s probe with 8 rows a thread
    (``DJ_ROWS``) against the sources' 4;
  * ``bz_base``: the checkout's sources, timed for ``bucketize.cu``'s
    shapes only; ``bz_notail``: without its zero tail (results not
    checked), the part of its time the tail takes;
  * ``cp_base``, ``hs_base``: the checkout's sources, timed for
    ``compact.cu``'s or ``hashing.cu``'s shapes only; ``cp_group1``:
    ``compact.cu`` with 1 tile a group on a sparse mask (``CP_GROUP``)
    against 4; ``cp_sparse16``: groups only under 1 live row in 16
    (``CP_SPARSE``) against 8; ``cp_occ5``: registers fitted to 5 blocks
    an SM (``CP_MIN_BLOCKS``), which the sources leave at 4;
    ``cp_nofetch``: without reading the live values (results
    not checked), the part of its time the gathered reads take;
    ``hs_rows4``: ``hashing.cu``
    with 4 rows a thread (``HS_ROWS``) against 8; ``hs_sm4``,
    ``hs_sm16``: 4 and 16 blocks an SM at most (``HS_BLOCKS_PER_SM``)
    against 8 (16: one block per 2,048 rows at a lineitem batch);
  * ``ex_base``, ``gr_base``: the checkout's sources, timed for
    ``explode.cu``'s or ``group_ratio.cu``'s shapes only; ``ex_nosib``:
    explode without its siblings (results not checked), the part of its
    time the sibling pass takes; ``gr_noclear``: the other set left as it
    is (results not checked), the part of its time the emptying takes;

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
# variant: (source, {define: value}, optionally [(text, replacement)])
VARIANTS = {"base": (None, {}),
            "sm2": ("hash_agg.cu", {"HA_BLOCKS_PER_SM": "2"}),
            "sm3": ("hash_agg.cu", {"HA_BLOCKS_PER_SM": "3"}),
            "sm6": ("hash_agg.cu", {"HA_BLOCKS_PER_SM": "6"}),
            "sm8": ("hash_agg.cu", {"HA_BLOCKS_PER_SM": "8"}),
            "nocache": ("hash_agg.cu", {"HA_CACHE_BYTES": "0"}),
            "dj_base": ("dense_join.cu", {}),
            "dj_rows8": ("dense_join.cu", {"DJ_ROWS": "8"}),
            "ws_base": ("window_scan.cu", {}),
            "bz_base": ("bucketize.cu", {}),
            "cp_base": ("compact.cu", {}),
            "cp_group1": ("compact.cu", {"CP_GROUP": "1"}),
            "cp_sparse16": ("compact.cu", {"CP_SPARSE": "16"}),
            "cp_occ5": ("compact.cu", {"CP_MIN_BLOCKS": "5"}),
            # compact.cu without its value fetches (its results then differ
            # from plain and are not checked)
            "cp_nofetch": ("compact.cu", {}, [
                ("if (live > 0 && (!first || warp > 0)) {", "if (false) {")]),
            "hs_base": ("hashing.cu", {}),
            "hs_rows4": ("hashing.cu", {"HS_ROWS": "4"}),
            "hs_sm4": ("hashing.cu", {"HS_BLOCKS_PER_SM": "4"}),
            "hs_sm16": ("hashing.cu", {"HS_BLOCKS_PER_SM": "16"}),
            "ex_base": ("explode.cu", {}),
            # explode.cu without its siblings (results not checked): the
            # part of its time they take
            "ex_nosib": ("explode.cu", {}, [
                ("for (int c = 0; c < args.ncols; ++c) {",
                 "for (int c = 0; c < 0; ++c) {")]),
            "gr_base": ("group_ratio.cu", {}),
            # group_ratio.cu without emptying the other set (its results
            # then differ from plain and are not checked)
            "gr_noclear": ("group_ratio.cu", {}, [
                ("w < GR_SET_WORDS / 2; w += stride)",
                 "w < 0; w += stride)")]),
            # bucketize.cu without its zero tail (its results then differ
            # from plain and are not checked)
            "bz_notail": ("bucketize.cu", {}, [
                ("? 0 : (slots + BZ_ZERO_SLOTS - 1) / BZ_ZERO_SLOTS;",
                 "? 0 : 0;"),
                ("if (ntiles == 1 && slots <= BZ_ZERO_SLOTS) {",
                 "if (false) {")])}


def make_variant(name: str) -> Path:
    out = ROOT / "build" / "agg_variants" / name
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(ROOT / "spark_rapids_tpu_torch" / "csrc", out)
    source, defines, *edits = VARIANTS[name]
    if source is not None:
        src = (out / source).read_text()
        for key, value in defines.items():
            src, n = re.subn(rf"#define {key} [^/\n]*",
                             f"#define {key} {value} ", src)
            if n != 1:
                raise SystemExit(f"agg_bench: no #define {key}")
        for text, replacement in (edits[0] if edits else []):
            if src.count(text) != 1:
                raise SystemExit(f"agg_bench: no single {text!r}")
            src = src.replace(text, replacement)
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
    if source in (None, "bucketize.cu"):
        rc |= kernel_ab.time_bucketize(torch, dev, emit,
                                       check=len(VARIANTS[name]) < 3)
    if source in (None, "compact.cu"):
        rc |= kernel_ab.time_compact(torch, dev, emit,
                                     check=len(VARIANTS[name]) < 3)
    if source in (None, "hashing.cu"):
        rc |= kernel_ab.time_hashing(torch, dev, emit)
    if source in (None, "explode.cu"):
        rc |= kernel_ab.time_explode(torch, dev, emit,
                                     check=len(VARIANTS[name]) < 3)
    if source in (None, "group_ratio.cu"):
        rc |= kernel_ab.time_group_ratio(torch, dev, groupby, emit,
                                         check=name != "gr_noclear")
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
