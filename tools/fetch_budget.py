#!/usr/bin/env python3
"""Blocking fetches per TPC-H query in the JAX reference and in the port.

    JAX_PLATFORMS=cpu python tools/fetch_budget.py --sf 1 --package both \
        [--batch-rows 4194304]

The queries are Q4, Q13, Q18, Q21, Q11, Q10 (twice), the rest of TPC-H
(Q2, Q5, Q7, Q8, Q9, Q12, Q14, Q15, Q16, Q17, Q19, Q20, Q22) and Q21 in
its EXISTS form (``q21_exists``: the same logical plan built in both
packages, with conditioned semi and anti joins).  Besides them,
``sort_lineitem`` (S1: a global ORDER BY of a
lineitem projection, out-of-core when lineitem spans several batches) and
``supplier_history`` (W1: two window specs over lineitem, filtered above
them) and ``w2`` (W2: the same specs with windowed FIRST/LAST) run through
``to_device_arrays`` in both packages.  The decimal and FIRST/LAST paths
``q1_dec``, ``q6_dec``, ``q18_dec``, ``f1`` (through ``to_device_arrays``)
and ``f1u`` run over the money columns as DECIMAL(12, 2): pyarrow
``decimal128`` arrays for the reference, ``DecimalArray``s for the port,
from the same integers.  The reference cannot run ``q18_dec`` (its HAVING
reads a wide sum the reference finalizes into a host column); its line
then carries the error instead of a count.  The eighth slice's paths:
``q1_sample`` (Q1 over a 1% lineitem sample), ``x1`` and ``x1o`` (explodes
of orders' lineitem quantity lists: a ``pa.ListArray`` for the reference,
a ``ListArray`` from the same offsets for the port; ``x1o`` through
``to_device_arrays``), and the subquery forms ``q18_in``, ``q16_notin``
and ``q22_scalar``, each built by the same body in both packages.
The tenth slice's paths run Q1, Q3, Q10 and Q18 with the partial/final
aggregate split (``q1_2ph``, ``q3_2ph``, ``q18_2ph``), the
the final's re-partition fallback (``q18_2ph_repart``: chip_smoke.py's
8 MiB ``batchSizeBytes`` at SF10, scaled to ``--sf``), the HOST shuffle
(``q10_host``, ``q18_host``: the reference cannot carry a
string group key through its Arrow frames and fails ``q10_host``; the
ceiling is then its ``q10_2ph_noaqe``, the same plan, which HOST runs
without the broadcast flip, on the single-process transport) and the mesh (``q3_ici`` over one
device, ``q1_ici8`` and ``q3_ici8`` over 8: run with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` so the reference
has its 8 virtual devices).
With ``--parquet DIR`` the ninth slice's forms run instead: ``pq_q1`` ..
``pq_q22``, the reference suite's 22 queries over parquet as ``bench.py``
runs them (``read_parquet`` per table, ``fileCache.enabled``), the
reference over its own ``gen_db`` files (pyarrow) under ``DIR/reference``
and the port over the files its ``gen_db`` writes under ``DIR/port`` (the
same values and row groups; the codec does not change a fetch count).

Both packages run on the CPU over the same ``gen_db_arrays`` data (the
reference suite's ``gen_db`` draws) with ``--batch-rows``-row batches
(4,194,304, the default of ``batchSizeRows``) and
``spark.rapids.tpu.join.denseMinProbeRows = 0``; each query's rows are
checked against the numpy oracle.  SF1 with 400,000-row batches cuts
lineitem into the 15 batches it has at SF10 with the default size.  Q10
runs in the reference's two configurations, ``q10_flip`` (AQE on: the
second join's staged side flips it to a broadcast join) and
``q10_shuffled`` (AQE off: 8 hash partition pairs); Q10 and the rest of
TPC-H run with the broadcast threshold scaled from SF10 to ``--sf`` so
the plans are SF10's.  Prints
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
# slice 10: the partial/final split, the HOST shuffle and the mesh (ICI;
# ``ici8``: 8 shards, ``spark.rapids.tpu.shuffle.ici.devices`` = 8, the
# reference's 8 virtual devices and the port's ``["cpu"] * 8``)
TWO_PHASE = {"spark.rapids.tpu.sql.agg.singleProcessComplete": False}
HOST = {"spark.rapids.tpu.shuffle.mode": "HOST"}
ICI = {"spark.rapids.tpu.shuffle.mode": "ICI"}
Q3_TABLES = ("customer", "orders", "lineitem")
Q18_TABLES = ("orders", "lineitem", "customer")
SLICE10 = {"q1_2ph": ("q1", ("lineitem",), TWO_PHASE),
           "q3_2ph": ("q3", Q3_TABLES, TWO_PHASE),
           "q18_2ph": ("q18", Q18_TABLES, TWO_PHASE),
           # the final re-partitions: chip_smoke.py's 8 MiB buffer limit
           # at SF10, scaled to --sf below
           "q18_2ph_repart": ("q18", Q18_TABLES, TWO_PHASE),
           # the plan HOST runs (no broadcast flip) on the reference's
           # single-process transport
           "q10_2ph_noaqe": ("q10", Q10_TABLES, dict(TWO_PHASE, **{
               "spark.rapids.tpu.sql.aqe.enabled": False})),
           "q10_host": ("q10", Q10_TABLES, HOST),
           "q18_host": ("q18", Q18_TABLES, HOST),
           "q3_ici": ("q3", Q3_TABLES, dict(
               ICI, **{"spark.rapids.tpu.shuffle.ici.devices": 1})),
           "q1_ici8": ("q1", ("lineitem",), dict(
               ICI, **{"spark.rapids.tpu.shuffle.ici.devices": 8})),
           "q3_ici8": ("q3", Q3_TABLES, dict(
               ICI, **{"spark.rapids.tpu.shuffle.ici.devices": 8}))}
QUERIES.update(SLICE10)
REST = ("q2", "q5", "q7", "q8", "q9", "q12", "q14", "q15", "q16", "q17",
        "q19", "q20", "q22", "q21_exists")
# device hand-offs: name -> (models/tpch function, numpy oracle)
DEVICE_PATHS = {"sort_lineitem": ("sort_lineitem", "sort_lineitem_numpy"),
                "supplier_history": ("supplier_history",
                                     "supplier_history_numpy"),
                "w2": ("w2", "w2_numpy")}
# decimal money columns: name -> (tables, ends in to_device_arrays)
DECIMAL_PATHS = {"q1_dec": (("lineitem",), False),
                 "q6_dec": (("lineitem",), False),
                 "q18_dec": (("orders", "lineitem", "customer"), False),
                 "f1": (("orders",), True), "f1u": (("lineitem",), False)}
# slice 8: name -> (tables, ends in to_device_arrays)
SLICE8_PATHS = {"q1_sample": (("lineitem",), False),
                "x1": (("orders", "lineitem"), False),
                "x1o": (("orders", "lineitem"), True),
                "q18_in": (("orders", "lineitem", "customer"), False),
                "q16_notin": (("partsupp", "supplier", "part"), False),
                "q22_scalar": (("customer", "orders"), False)}
SETTINGS = {"spark.rapids.tpu.join.denseMinProbeRows": 0}
SF10_BROADCAST_THRESHOLD = 256 * 1024 * 1024
REPART_BYTES_SF10 = 8 << 20


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


def _same_by_key(got: dict, want: dict) -> bool:
    """Device columns whose row order is not specified (a hash aggregate's
    output), sorted by their first column, against the oracle's."""
    first = next(iter(want))
    order = np.argsort(np.asarray(got[first][0]), kind="stable")
    return _same_columns({c: (np.asarray(d)[order],
                              None if v is None else np.asarray(v)[order])
                          for c, (d, v) in got.items()}, want)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--package", choices=("reference", "port", "both"),
                    default="both")
    ap.add_argument("--queries", default=",".join(
        list(QUERIES) + list(REST) + list(DEVICE_PATHS)
        + list(DECIMAL_PATHS) + list(SLICE8_PATHS)))
    ap.add_argument("--batch-rows", type=int, default=4 << 20)
    ap.add_argument("--parquet", metavar="DIR", default=None,
                    help="run the 22 queries over parquet files under DIR")
    args = ap.parse_args()
    base = dict(SETTINGS, **{"spark.rapids.tpu.sql.batchSizeRows":
                             args.batch_rows})

    from spark_rapids_tpu_torch.models import tpch
    for q in REST:
        QUERIES[q] = (q, tpch.QUERY_TABLES[q], {})
    parquet = {f"pq_{q}": q for q in tpch.SUITE_QUERIES}
    if args.parquet:
        args.queries = ",".join(parquet)
        pq_settings = dict(base, **{
            "spark.rapids.tpu.sql.fileCache.enabled": True,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": int(
                SF10_BROADCAST_THRESHOLD * args.sf / 10)})

    import tempfile
    spill = tempfile.mkdtemp(prefix="fetch_budget_spill_")

    def settings(q):
        extra = dict(QUERIES[q][2])
        if extra.get("spark.rapids.tpu.shuffle.mode") == "HOST":
            extra["spark.rapids.tpu.memory.spill.dir"] = spill
        if q == "q18_2ph_repart":
            extra["spark.rapids.tpu.sql.batchSizeBytes"] = int(
                REPART_BYTES_SF10 * args.sf / 10)
        if QUERIES[q][0] == "q10" or q in REST:
            extra["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"] = int(
                SF10_BROADCAST_THRESHOLD * args.sf / 10)
        return dict(base, **extra)
    data = tpch.gen_db_arrays(args.sf)
    dec = {t: tpch.decimal_columns(data[t], tpch.MONEY_COLUMNS[t])
           for t in ("lineitem", "orders", "customer")}

    def decimal_body(q, F):
        body = getattr(tpch, q)
        return lambda *dfs: body(*dfs, functions=F)

    lists = {}

    def slice8_tables(q, arrow):
        """The path's input tables; X1's and X1o's orders carry o_qty."""
        tables, _ = SLICE8_PATHS[q]
        if q not in ("x1", "x1o"):
            return [data[t] for t in tables]
        if q not in lists:
            lists[q] = tpch.order_quantities(
                data["orders"], data["lineitem"],
                *((0.01, 0.01) if q == "x1o" else ()))
        la = lists[q]
        if arrow:
            import pyarrow as pa
            la = pa.ListArray.from_arrays(
                pa.array(la.offsets.astype(np.int32)), pa.array(la.values),
                mask=None if la.valid is None else pa.array(~la.valid))
        cols = ("o_orderkey", "o_orderdate", "o_orderpriority") \
            if q == "x1" else ("o_orderkey",)
        return [dict({c: data["orders"][c] for c in cols}, o_qty=la)]

    def slice8_df(q, dfs, F):
        if q == "x1o":
            return tpch.x1o(*dfs)
        return getattr(tpch, q)(*dfs, functions=F)
    runners = []
    if args.package in ("reference", "both"):
        import spark_rapids_tpu as jsrt
        from spark_rapids_tpu.models import tpch_suite
        from spark_rapids_tpu.utils.metrics import QueryStats

        def ref_tables():
            import pyarrow as pa
            out = {}
            for t, cols in dec.items():
                out[t] = dict(cols)
                for n in tpch.MONEY_COLUMNS[t]:
                    u = cols[n].unscaled
                    buf = np.stack([u, u >> 63], 1).tobytes()
                    out[t][n] = pa.Array.from_buffers(
                        pa.decimal128(12, 2), len(u),
                        [None, pa.py_buffer(buf)])
            return out

        def run_ref(q):
            if q in parquet:
                paths = tpch_suite.gen_db(args.sf, f"{args.parquet}/reference")
                jsess = jsrt.Session(pq_settings)
                dfs = {t: jsess.read_parquet(paths[t])
                       for t in tpch_suite.TABLES[parquet[q]]}
                with QueryStats.scoped() as st:
                    rows = tpch_suite.QUERIES[parquet[q]][0](dfs)
                return rows, st.blocking_fetches
            if q in SLICE8_PATHS:
                from spark_rapids_tpu.sql import functions as JF
                jsess = jsrt.Session(base)
                df = slice8_df(q, [jsess.create_dataframe(t) for t in
                                   slice8_tables(q, True)], JF)
                with QueryStats.scoped() as st:
                    out = df.to_device_arrays() if SLICE8_PATHS[q][1] \
                        else df.collect()
                return out, st.blocking_fetches
            if q in DECIMAL_PATHS:
                from spark_rapids_tpu.sql import functions as JF
                tables, device = DECIMAL_PATHS[q]
                jsess = jsrt.Session(base)
                ref = ref_tables()
                df = decimal_body(q, JF)(*(jsess.create_dataframe(ref[t])
                                           for t in tables))
                try:
                    with QueryStats.scoped() as st:
                        out = df.to_device_arrays() if device \
                            else df.collect()
                except TypeError as e:
                    return f"{type(e).__name__}: {e}", None
                return out, st.blocking_fetches
            if q in DEVICE_PATHS:
                from spark_rapids_tpu.sql import functions as JF
                from spark_rapids_tpu.sql.window import Window as JW
                jsess = jsrt.Session(base)
                df = jsess.create_dataframe(data["lineitem"])
                body = getattr(tpch, DEVICE_PATHS[q][0])
                q_df = body(df, functions=JF) if q == "sort_lineitem" \
                    else body(df, functions=JF, window=JW)
                if q == "w2":
                    q_df = body(df, functions=JF, window=JW)
                with QueryStats.scoped() as st:
                    out = q_df.to_device_arrays()
                return out, st.blocking_fetches
            jsess = jsrt.Session(settings(q))
            body, tables, _ = QUERIES[q]
            dfs = {t: jsess.create_dataframe(data[t]) for t in tables}
            if q in SLICE10:
                try:
                    with QueryStats.scoped() as st:
                        rows = getattr(tpch_suite, f"run_{body}")(dfs)
                except Exception as e:   # HOST with string keys
                    return f"{type(e).__name__}: {e}", None
                return rows, st.blocking_fetches
            with QueryStats.scoped() as st:
                if body == "q21_exists":
                    import spark_rapids_tpu.plan.logical as JL
                    from spark_rapids_tpu.sql import functions as JF
                    rows = tpch.q21_exists(*dfs.values(), functions=JF,
                                           logical=JL).collect()
                else:
                    rows = getattr(tpch_suite, f"run_{body}")(dfs)
            return rows, st.blocking_fetches
        runners.append(("reference", run_ref))
    if args.package in ("port", "both"):
        import spark_rapids_tpu_torch as tsrt

        from spark_rapids_tpu_torch.utils.metrics import \
            QueryStats as TStats

        def run_port(q):
            # the scope counts every query the body runs (Q11 runs two)
            if q in parquet:
                paths = tpch.gen_db(args.sf, f"{args.parquet}/port",
                                    data=data)
                tsess = tsrt.Session(pq_settings, device="cpu")
                dfs = {t: tsess.read_parquet(p) for t, p in paths.items()}
                with TStats.scoped() as st:
                    rows = tpch.run_query(parquet[q], dfs)
                return rows, st.blocking_fetches
            if q in SLICE8_PATHS:
                from spark_rapids_tpu_torch.sql import functions as TF
                tsess = tsrt.Session(base, device="cpu")
                df = slice8_df(q, [tsess.create_dataframe(t) for t in
                                   slice8_tables(q, False)], TF)
                with TStats.scoped() as st:
                    out = df.to_device_arrays() if SLICE8_PATHS[q][1] \
                        else df.collect()
                return out, st.blocking_fetches
            if q in DECIMAL_PATHS:
                tables, device = DECIMAL_PATHS[q]
                tsess = tsrt.Session(base, device="cpu")
                df = getattr(tpch, q)(*(tsess.create_dataframe(dec[t])
                                        for t in tables))
                with TStats.scoped() as st:
                    out = df.to_device_arrays() if device else df.collect()
                return out, st.blocking_fetches
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
        if q in parquet:
            want = tpch.query_oracle(parquet[q], data)
            same = _same
        elif q in SLICE8_PATHS:
            tables, device = SLICE8_PATHS[q]
            same = _same_columns if device else _same
            if q == "q1_sample":
                n = len(data["lineitem"]["l_orderkey"])
                want = tpch.q1_sample_numpy(
                    data["lineitem"], tpch.sample_keep(n, args.batch_rows))
            elif q == "x1":
                want = tpch.x1_numpy(data["orders"], data["lineitem"])
            elif q == "x1o":
                want = tpch.x1o_numpy(slice8_tables(q, False)[0],
                                      lists["x1o"])
            else:
                explicit = q.split("_")[0]
                want = getattr(tpch, f"{explicit}_numpy")(
                    *(data[t] for t in tables))
        elif q in DECIMAL_PATHS:
            tables, device = DECIMAL_PATHS[q]
            want = getattr(tpch, f"{q}_numpy")(*(data[t] for t in tables))
            if q == "q6_dec":
                want = [(want,)]
            same = _same_by_key if device else _same
        elif q in DEVICE_PATHS:
            want = getattr(tpch, DEVICE_PATHS[q][1])(data["lineitem"])
            same = _same_columns
        else:
            body, tables, _ = QUERIES[q]
            want = getattr(tpch, f"{body}_numpy")(*(data[t] for t in tables))
            same = _same
        for package, run in runners:
            t0 = time.perf_counter()
            rows, fetches = run(q)
            if fetches is None:  # the package could not run the query
                print(json.dumps({"query": q, "package": package,
                                  "sf": args.sf, "error": rows}), flush=True)
                continue
            print(json.dumps({"query": q, "package": package, "sf": args.sf,
                              "batch_rows": args.batch_rows,
                              "blocking_fetches": fetches,
                              "matches_oracle": same(rows, want),
                              "seconds": round(time.perf_counter() - t0,
                                               3)}), flush=True)


if __name__ == "__main__":
    main()
