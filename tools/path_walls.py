#!/usr/bin/env python3
"""Warm wall times and blocking fetches of TPC-H paths of the port on the
CUDA card.

    python3 tools/path_walls.py [--root DIR] [--sf 10] [--runs 5] \
        [--queries q1,q3,q18,q7,q9,q3_2ph,q18_2ph,q18_2ph_repart,pq_q18,
                   s1,w1,w2,q10_shuffled,q10_flip,q21_exists]

Imports ``spark_rapids_tpu_torch`` from ``--root`` (default: this
checkout), so one command can time two checkouts of the port in turns on
one card (parent, change, change, parent).  Every query runs over
``models/tpch.gen_db_arrays(sf)`` in the default 4,194,304-row batches:
one cold run, then ``--runs`` warm runs, each a host clock around
``collect()``.  A name with ``_2ph`` runs on a session with
``sql.agg.singleProcessComplete`` false (the partial/final aggregate),
``_2ph_repart`` also with ``sql.batchSizeBytes`` at 8 MiB (the final
re-partitions); ``pq_<q>`` runs over parquet files that ``tpch.gen_db``
writes once under ``build/tpch_parquet`` (kept between runs), read with
``fileCache.enabled``, as ``chip_smoke.py`` reads them.  ``_shuffled``
runs on a session with ``sql.aqe.enabled`` false (Q10-shuffled: the
sorted join over 8 hash partition pairs); ``s1`` (``tpch.sort_lineitem``),
``w1`` (``tpch.supplier_history``) and ``w2`` (``tpch.w2``, windowed
FIRST/LAST) end in ``to_device_arrays()``, as ``chip_smoke.py`` runs
them; ``q21_exists`` runs on the default session
(8 shuffle partition pairs), and so does ``q10_flip`` (Q10 with the
defaults: its second join flips to a broadcast).  Prints one JSON
line per query: the warm median and every warm wall in ms, the blocking
fetches of the last warm run, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TWO_PHASE = {"spark.rapids.tpu.sql.agg.singleProcessComplete": False}
VARIANTS = {
    "": {},
    "2ph": TWO_PHASE,
    "2ph_repart": dict(TWO_PHASE, **{
        "spark.rapids.tpu.sql.batchSizeBytes": 8 << 20}),
    "pq": {"spark.rapids.tpu.sql.fileCache.enabled": True},
    "shuffled": {"spark.rapids.tpu.sql.aqe.enabled": False}}
PARQUET_DIR = "build/tpch_parquet"
# paths that are not TPC-H queries: (tpch function, tables); their results
# stay on the device
DEVICE_PATHS = {"s1": ("sort_lineitem", ("lineitem",)),
                "w1": ("supplier_history", ("lineitem",)),
                "w2": ("w2", ("lineitem",))}


def split(name: str):
    """(TPC-H query, variant) of a path name."""
    if name.startswith("pq_"):
        return name[3:], "pq"
    if name.endswith("_flip"):  # the defaults: the runtime flip
        return name[:-len("_flip")], ""
    for suffix in ("_2ph_repart", "_2ph", "_shuffled"):
        if name.endswith(suffix):
            return name[:-len(suffix)], suffix[1:]
    return name, ""


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
    from spark_rapids_tpu_torch.utils.metrics import QueryStats
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    paths = args.queries.split(",")
    tables = {"q1": ("lineitem",), "q3": ("customer", "orders", "lineitem"),
              "q18": ("orders", "lineitem", "customer")}
    funcs = {q: getattr(tpch, f) for q, (f, _) in DEVICE_PATHS.items()}
    for name in paths:
        q = split(name)[0]
        if q in DEVICE_PATHS:
            tables[q] = DEVICE_PATHS[q][1]
        elif q not in tables:
            tables[q] = tpch.QUERY_TABLES.get(q) or tpch.SUITE_QUERIES[q]
    needed = sorted({t for name in paths for t in tables[split(name)[0]]})
    db = tpch.gen_db_arrays(args.sf, tables=needed)
    sessions, frames = {}, {}
    for name in paths:
        q, variant = split(name)
        if variant in sessions:
            continue
        sess = Session.get_or_create(device="cuda") if variant == "" \
            else Session(VARIANTS[variant], device="cuda")
        sessions[variant] = sess
        if variant == "pq":
            pq_tables = sorted({t for n in paths if split(n)[1] == "pq"
                                for t in tables[split(n)[0]]})
            files = tpch.gen_db(args.sf, PARQUET_DIR, data=db,
                                tables=pq_tables)
            frames[variant] = {t: sess.read_parquet(p)
                               for t, p in files.items()}
        else:
            frames[variant] = {t: sess.create_dataframe(cols)
                               for t, cols in db.items()}
    for name in paths:
        q, variant = split(name)
        dfs = frames[variant]
        walls, syncs = [], 0
        for i in range(1 + args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with QueryStats.scoped() as st:
                df = (funcs.get(q) or getattr(tpch, q))(
                    *(dfs[t] for t in tables[q]))
                if q in DEVICE_PATHS:
                    df.to_device_arrays()
                else:
                    df.collect()
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
                syncs = st.blocking_fetches
        print(json.dumps({"label": args.label, "query": name, "sf": args.sf,
                          "warm_median_ms": statistics.median(walls),
                          "warm_ms": walls, "syncs": syncs,
                          "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
