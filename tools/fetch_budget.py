#!/usr/bin/env python3
"""Blocking fetches per TPC-H query in the JAX reference and in the port.

    JAX_PLATFORMS=cpu python tools/fetch_budget.py --sf 1 --package both \
        [--batch-rows 4194304]

Besides the TPC-H queries, ``sort_lineitem`` (S1: a global ORDER BY of a
lineitem projection, out-of-core when lineitem spans several batches) and
``supplier_history`` (W1: two window specs over lineitem, filtered above
them) run through ``to_device_arrays`` in both packages.

Both packages run on the CPU over the same ``gen_db_arrays`` data (the
reference suite's ``gen_db`` draws) with ``--batch-rows``-row batches
(4,194,304, the default of ``batchSizeRows``) and
``spark.rapids.tpu.join.denseMinProbeRows = 0``; each query's rows are
checked against the numpy oracle.  SF1 with 400,000-row batches cuts
lineitem into the 15 batches it has at SF10 with the default size.  Q10
runs in the reference's two configurations, ``q10_flip`` (AQE on: the
second join's staged side flips it to a broadcast join) and
``q10_shuffled`` (AQE off: 8 hash partition pairs), with the broadcast
threshold scaled from SF10 to ``--sf`` so the plans are SF10's.  Prints
one JSON line per query and package: ``{"query", "package",
"blocking_fetches", "seconds"}``.  A
fetch count on the CPU equals the count on a device for the same plan
(the counted fetches do not depend on the backend); the port's ceiling on
the card is the reference's count for the same query, scale factor and
batch size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

Q10_TABLES = ("customer", "orders", "lineitem")
# name: (query body, tables, settings beyond the common ones)
QUERIES = {"q4": ("q4", ("orders", "lineitem"), {}),
           "q13": ("q13", ("customer", "orders"), {}),
           "q18": ("q18", ("orders", "lineitem", "customer"), {}),
           "q21": ("q21", ("lineitem", "orders", "supplier"), {}),
           "q11": ("q11", ("partsupp", "supplier", "nation"), {}),
           "q10_flip": ("q10", Q10_TABLES,
                        {"spark.rapids.tpu.sql.aqe.enabled": True}),
           "q10_shuffled": ("q10", Q10_TABLES,
                            {"spark.rapids.tpu.sql.aqe.enabled": False})}
# device hand-offs: name -> (models/tpch function, numpy oracle)
DEVICE_PATHS = {"sort_lineitem": ("sort_lineitem", "sort_lineitem_numpy"),
                "supplier_history": ("supplier_history",
                                     "supplier_history_numpy")}
SETTINGS = {"spark.rapids.tpu.join.denseMinProbeRows": 0}
SF10_BROADCAST_THRESHOLD = 256 * 1024 * 1024


def _same(got, want) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float):
                if a is None or abs(a - b) > 1e-9 * max(abs(b), 1.0):
                    return False
            elif a != b:
                return False
    return True


def _same_columns(got: dict, want: dict) -> bool:
    """Device columns against the oracle's: validity and integers equal,
    floats within rel 1e-9."""
    if set(got) != set(want):
        return False
    for c, w in want.items():
        wd, wv = w if isinstance(w, tuple) else (w, None)
        if wd.dtype.kind == "M":
            wd = wd.astype("datetime64[D]").astype(np.int64).astype(np.int32)
        gd, gv = got[c]
        gd = np.asarray(gd.numpy() if hasattr(gd, "numpy") else gd)
        ok = np.ones(len(wd), dtype=bool) if wv is None else wv
        gok = np.ones(len(gd), dtype=bool) if gv is None else np.asarray(
            gv.numpy() if hasattr(gv, "numpy") else gv)
        if gd.shape != wd.shape or not np.array_equal(gok, ok):
            return False
        if wd.dtype.kind == "f":
            if np.any(np.abs(gd[ok] - wd[ok])
                      > 1e-9 * np.maximum(np.abs(wd[ok]), 1.0)):
                return False
        elif not np.array_equal(gd[ok], wd[ok]):
            return False
    return True


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--package", choices=("reference", "port", "both"),
                    default="both")
    ap.add_argument("--queries", default=",".join(list(QUERIES)
                                                  + list(DEVICE_PATHS)))
    ap.add_argument("--batch-rows", type=int, default=4 << 20)
    args = ap.parse_args()
    base = dict(SETTINGS, **{"spark.rapids.tpu.sql.batchSizeRows":
                             args.batch_rows})

    def settings(q):
        extra = dict(QUERIES[q][2])
        if QUERIES[q][0] == "q10":
            extra["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"] = int(
                SF10_BROADCAST_THRESHOLD * args.sf / 10)
        return dict(base, **extra)
    from spark_rapids_tpu_torch.models import tpch
    data = tpch.gen_db_arrays(args.sf)
    runners = []
    if args.package in ("reference", "both"):
        import spark_rapids_tpu as jsrt
        from spark_rapids_tpu.models import tpch_suite
        from spark_rapids_tpu.utils.metrics import QueryStats

        def run_ref(q):
            if q in DEVICE_PATHS:
                from spark_rapids_tpu.sql import functions as JF
                from spark_rapids_tpu.sql.window import Window as JW
                jsess = jsrt.Session(base)
                df = jsess.create_dataframe(data["lineitem"])
                body = getattr(tpch, DEVICE_PATHS[q][0])
                q_df = body(df, functions=JF) if q == "sort_lineitem" \
                    else body(df, functions=JF, window=JW)
                with QueryStats.scoped() as st:
                    out = q_df.to_device_arrays()
                return out, st.blocking_fetches
            jsess = jsrt.Session(settings(q))
            body, tables, _ = QUERIES[q]
            dfs = {t: jsess.create_dataframe(data[t]) for t in tables}
            with QueryStats.scoped() as st:
                rows = getattr(tpch_suite, f"run_{body}")(dfs)
            return rows, st.blocking_fetches
        runners.append(("reference", run_ref))
    if args.package in ("port", "both"):
        import spark_rapids_tpu_torch as tsrt

        from spark_rapids_tpu_torch.utils.metrics import \
            QueryStats as TStats

        def run_port(q):
            # the scope counts every query the body runs (Q11 runs two)
            if q in DEVICE_PATHS:
                tsess = tsrt.Session(base, device="cpu")
                df = tsess.create_dataframe(data["lineitem"])
                with TStats.scoped() as st:
                    out = getattr(tpch, DEVICE_PATHS[q][0])(df) \
                        .to_device_arrays()
                return out, st.blocking_fetches
            tsess = tsrt.Session(settings(q), device="cpu")
            body, tables, _ = QUERIES[q]
            dfs = [tsess.create_dataframe(data[t]) for t in tables]
            with TStats.scoped() as st:
                rows = getattr(tpch, body)(*dfs).collect()
            return rows, st.blocking_fetches
        runners.append(("port", run_port))
    for q in args.queries.split(","):
        if q in DEVICE_PATHS:
            want = getattr(tpch, DEVICE_PATHS[q][1])(data["lineitem"])
            same = _same_columns
        else:
            body, tables, _ = QUERIES[q]
            want = getattr(tpch, f"{body}_numpy")(*(data[t] for t in tables))
            same = _same
        for package, run in runners:
            t0 = time.perf_counter()
            rows, fetches = run(q)
            print(json.dumps({"query": q, "package": package, "sf": args.sf,
                              "batch_rows": args.batch_rows,
                              "blocking_fetches": fetches,
                              "matches_oracle": same(rows, want),
                              "seconds": round(time.perf_counter() - t0,
                                               3)}), flush=True)


if __name__ == "__main__":
    main()
