#!/usr/bin/env python3
"""Whether TPC-H Q15's float sums repeat bit for bit on the CUDA card.

    python3 tools/q15_repeat.py [--sf 10] [--reruns 40] [--queries 20]

Q15 keeps the suppliers whose summed revenue equals the maximum a first
query collected, so it needs the same sums in both queries.  This runs
Q15's revenue aggregate (``SUM(l_extendedprice * (1 - l_discount))`` per
supplier over one quarter of ``gen_db_arrays`` lineitem) ``--reruns``
times and counts the reruns, and the group sums, whose bits differ from
the first run's; then runs Q15 itself ``--queries`` times and counts the
runs that keep the numpy oracle's rows.  Prints the card's name and
power limit first.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--reruns", type=int, default=40)
    ap.add_argument("--queries", type=int, default=20)
    args = ap.parse_args()
    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.models import tpch
    from spark_rapids_tpu_torch.sql import functions as F
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    db = tpch.gen_db_arrays(args.sf, tables=("lineitem", "supplier"),
                            columns={"lineitem": [
                                "l_suppkey", "l_shipdate", "l_extendedprice",
                                "l_discount"]})
    sess = Session.get_or_create(device="cuda")
    li, sup = (sess.create_dataframe(db[t]) for t in ("lineitem", "supplier"))
    lo, hi = tpch.D(1996, 1, 1), tpch.D(1996, 4, 1)
    revenue = (li.filter((F.col("l_shipdate") >= lo)
                         & (F.col("l_shipdate") < hi))
               .with_column("rev", F.col("l_extendedprice")
                            * (1 - F.col("l_discount")))
               .group_by("l_suppkey")
               .agg(F.sum(F.col("rev")).alias("total_revenue")))
    first, runs, groups = None, 0, 0
    for _ in range(args.reruns):
        out = revenue.to_device_arrays()
        keys = out["l_suppkey"][0].cpu().numpy()
        bits = out["total_revenue"][0].cpu().numpy().view(np.int64)
        bits = bits[np.argsort(keys)]
        if first is None:
            first = bits
            continue
        differ = int((bits != first).sum())
        runs += differ > 0
        groups += differ
    print(f"revenue: {len(first)} groups; {runs} of {args.reruns - 1} "
          f"reruns differ from the first, in {groups} group sums in all")
    want = tpch.q15_numpy(db["lineitem"], db["supplier"])

    def same(rows) -> bool:  # keys and names exact, revenue within 1e-9
        return len(rows) == len(want) and all(
            g[:2] == w[:2] and abs(g[2] - w[2]) <= 1e-9 * abs(w[2])
            for g, w in zip(rows, want))
    kept = sum(same(tpch.q15(li, sup).collect())
               for _ in range(args.queries))
    print(f"q15: {kept} of {args.queries} runs equal the oracle's "
          f"{len(want)} row(s)")


if __name__ == "__main__":
    main()
