#!/usr/bin/env python3
"""Warm wall times of a few TPC-H paths of the port on the CUDA card.

    python3 tools/path_walls.py [--root DIR] [--sf 10] [--runs 5] \
        [--queries q1,q3,q18,q7,q9]

Imports ``spark_rapids_tpu_torch`` from ``--root`` (default: this
checkout), so one command can time two checkouts of the port in turns on
one card (parent, change, change, parent).  Every query runs over
``models/tpch.gen_db_arrays(sf)`` in the default 4,194,304-row batches:
one cold run, then ``--runs`` warm runs, each a host clock around
``collect()``.  Prints one JSON line per query: the warm median and every
warm wall in ms, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--queries", default="q1,q3,q18,q7,q9")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("path_walls: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.models import tpch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    queries = args.queries.split(",")
    tables = {"q1": ("lineitem",), "q3": ("customer", "orders", "lineitem")}
    tables.update({q: tpch.QUERY_TABLES.get(q) for q in queries
                   if q not in tables})
    tables["q18"] = ("orders", "lineitem", "customer")
    db = tpch.gen_db_arrays(args.sf, tables=sorted(
        {t for q in queries for t in tables[q]}))
    sess = Session.get_or_create(device="cuda")
    dfs = {t: sess.create_dataframe(cols) for t, cols in db.items()}
    for q in queries:
        walls = []
        for i in range(1 + args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(tpch, q)(*(dfs[t] for t in tables[q])).collect()
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"label": args.label, "query": q, "sf": args.sf,
                          "warm_median_ms": statistics.median(walls),
                          "warm_ms": walls, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
